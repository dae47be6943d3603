// Fused event sweep for Hopper (sm_90a): all U multiscans of the four
// Metropolis-Hastings event kernels of one chain in one thread block.
//
// Replaces covid19uk_tpu/ops/pallas/fused_sweep.py:fused_sweep (the Pallas
// TPU kernel _build_kernel.kernel: move_kernel, occult_kernel, multiscan).
// Its plain PyTorch version is fused_sweep_reference in ../fused_sweep.py;
// both evaluate the same per-cell formulas in the same order of float32
// operations (built with -fmad=false), so they make the same decisions.
//
// What bounds it on this card: latency and issue, not bytes.  The bytes
// bound (each input plane read once, each output plane written once: 64
// chains x 1.64 MB at M = 380, T = 120) is ~0.06 ms.  A sweep is 20
// serially dependent MH applications per chain (U = 5 x 4), each a chain
// of reductions around a scalar decision; a block holds one chain, so 64
// of the 132 SMs work at C = 64, and the chain's planes (1.46 MB) live in
// global memory: 64 chains' planes are twice the 50 MB L2.
//
// What this design does about it:
// - Bytes once, at full width.  The copy-in reads the caller's tensors as
//   they lie (events [C, M, T, 3] or a plane-major view of [C, 3, M, T];
//   state [C, M, T, 4], one float4 a cell, or plane-major), converts them
//   to the location-major working layout [plane][M][T] of the outputs
//   with 16-byte loads and stores, several in flight a thread, and sums
//   the occult guide's case window on the way (one warp a location row).
//   The wrapper makes no layout copy; the caller's tensors are not written.
// - Inputs of decisions in shared memory.  N, psi_w, rate_ir_t and each
//   multiscan's uniforms (tbl row, ttbl lanes) are staged with cp.async,
//   the next multiscan's while the current one runs; each slot's location
//   column (the planes its kernel reads) and Cstar row are staged once per
//   application, so a decision waits on at most one round trip to device
//   memory.
// - Few barriers, short chains.  Gumbel top-mmax is one pass (each warp
//   pops its best mmax, warp 0 merges the warps' lists).  The slots' T-day
//   column work (t_src, n_nz, the proposal, Hastings, column delta) runs
//   on one warp group a slot, in parallel; a day's four log-pmfs run on
//   four lanes, one function for both binomial kinds, every branch
//   computed and one selected (as the plain version's torch.where does),
//   so the lanes of a warp never diverge.  The E->I move's
//   rate-only plane delta is one pass over a plan of the slots' window
//   days (each day once, under the first slot whose window holds it): a
//   cell carries I and the commute through the slots' tentative updates
//   in registers and adds each slot's rate_diff to that slot's partial
//   sum; a cell without S->E events needs no logarithm there (the same
//   value).  The same pass writes both outcomes of each touched commute
//   cell, with the reference's per-cell sequence: the revert by
//   subtraction ((cm + a0) + a1) + (-a0) + (-a1) (kept on purpose) into
//   the commute, the tentative apply ((cm + a0) + a1) into a workspace
//   copied over only on accept (E->I moves are mostly rejected).
//   27 block barriers a multiscan at mmax = 2, against ~80 before.
// - Not done: splitting a chain over a cluster of two blocks (128 SMs).
//   The plane passes are the largest part left, not most of the kernel
//   (profile_torch.py's K1 phase split; ROADMAP.md).
//
// Synchronisation rule: every __syncthreads() is reached by the whole
// block.  Scalar decisions are made by thread 0 (or by every lane of one
// warp, from the same warp-wide values), put in shared memory, and read by
// all threads after a barrier; every branch around a barrier depends only
// on such shared values.
// Reductions are in a fixed order (shuffles in a fixed pattern, then the
// warps' partials summed by one thread in warp order) with no atomics, so
// logp is the same from run to run.  Only the order inside a reduction
// differs from the plain version (torch.sum), and the per-slot terms are
// combined in the plain version's order.

#include <cuda_runtime.h>
#include <cuda_pipeline_primitives.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kThreads = 512;  // >= M = 380, a multiple of 32
constexpr int kWarps = kThreads / 32;
constexpr int kMmaxLimit = 8;  // ops/fused_sweep.py MMAX_LIMIT; <= kWarps
static_assert(kMmaxLimit <= kWarps, "at least one warp per slot");
// planes of a staged location column
enum { kEv0, kEv1, kEv2, kSt0, kSt1, kSt2, kCm, kEta, kColPlanes };

// Phases of a launch, as thread 0 passes them (k: 0 S->E, 1 E->I); names
// in profile_torch.py, which builds the kernel with -DK1_PHASES to count
// each phase's clock64() cycles per block.  The default build counts
// nothing.
enum {
  kPhCopyIn,
  kPhGuide,
  kPhStage,
  kPhMoveTopk,                        // + k
  kPhMoveDays = kPhMoveTopk + 2,      // + k
  kPhMovePlane = kPhMoveDays + 2,     // E->I only
  kPhMoveDecision,                    // + k
  kPhMoveApply = kPhMoveDecision + 2, // + k
  kPhOccultPick = kPhMoveApply + 2,   // + k
  kPhOccultDelta = kPhOccultPick + 2, // + k
  kPhOccultDecision = kPhOccultDelta + 2,
  kPhOccultApply = kPhOccultDecision + 2,
  kPhases = kPhOccultApply + 2
};
#ifdef K1_PHASES
constexpr int kPhaseBlocks = 1024;
__device__ unsigned long long g_phase_cycles[kPhaseBlocks][kPhases];
__device__ unsigned long long g_phase_mark[kPhaseBlocks];
#define PHASE_START()                                            \
  do {                                                           \
    if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks)           \
      g_phase_mark[blockIdx.x] = clock64();                      \
  } while (0)
#define PHASE(id)                                                \
  do {                                                           \
    if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks) {         \
      const unsigned long long now = clock64();                  \
      g_phase_cycles[blockIdx.x][id] += now - g_phase_mark[blockIdx.x]; \
      g_phase_mark[blockIdx.x] = now;                            \
    }                                                            \
  } while (0)
#else
#define PHASE_START() do {} while (0)
#define PHASE(id) do {} while (0)
#endif

// Constants are rounded from double to float, as JAX's weakly typed
// Python scalars and PyTorch's Python scalars are.
#define F(x) static_cast<float>(x)
constexpr double kRateEps = 1e-9;
constexpr double kNu = 0.28;
constexpr double kLogPNu = -1.40970114071642;  // log(-expm1(-0.28))
constexpr double kHalfLog2Pi = 0.91893853320467274;  // 0.5 * log(2 pi)

// ---------------------------------------------------------------------------
// In-kernel numerics (fused_sweep.py:_log1p .. _gumbel).  Every branch
// is computed and one selected, as the plain version's torch.where does:
// the same result, and straight-line code that the four lanes of a day's
// log-pmfs run without diverging.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float log1p_k(float x) {
  const float big = logf(1.0f + fmaxf(x, F(1e-3)));
  const float small = x * (1.0f - x * (0.5f - x / 3.0f));
  return x > F(1e-3) ? big : small;
}

__device__ __forceinline__ float stirling(float z) {
  float inv = 1.0f / z;
  return (((z - 0.5f) * logf(z) - z) + F(kHalfLog2Pi)) +
         inv * (F(1.0 / 12.0) - inv * inv * F(1.0 / 360.0));
}

__device__ __forceinline__ float lgamma_diff(float n, float k) {
  float b = n - k + 1.0f;
  float a_s = n + 3.0f;
  float b_s = b + 2.0f;
  float s_diff = ((((a_s - 0.5f) * log1p_k(k / b_s) + k * logf(b_s)) - k) +
                  F(1.0 / 12.0) * (1.0f / a_s - 1.0f / b_s)) -
                 F(1.0 / 360.0) *
                     (1.0f / (a_s * a_s * a_s) - 1.0f / (b_s * b_s * b_s));
  return (s_diff - log1p_k(k / b)) - log1p_k(k / (b + 1.0f));
}

__device__ __forceinline__ float lgamma1p(float k) {
  float z = k + 1.0f;
  return (((stirling(z + 4.0f) - logf(z)) - logf(z + 1.0f)) -
          logf(z + 2.0f)) - logf(z + 3.0f);
}

__device__ __forceinline__ float log_pm(float r) {
  const float r_safe = fmaxf(r, F(1e-30));
  const float em = expf(-r_safe);
  const float large = -em * (1.0f + em * (0.5f + em / 3.0f));
  const float mid = logf(fmaxf(1.0f - em, F(1e-30)));
  const float small =
      logf(r_safe) +
      logf(1.0f - r_safe * (0.5f - r_safe * (F(1.0 / 6.0) - r_safe / 24.0f)));
  return r > 5.0f ? large : (r > F(1e-2) ? mid : small);
}

__device__ __forceinline__ bool valid_cell(float n, float y) {
  return (y >= 0.0f) && (y <= n) && (n >= 0.0f);
}

// Binomial log-pmf of y in n: with p = 1 - exp(-r) (binom_lp_rate), or
// at the constant E->I rate NU when nu (binom_lp_nu); -inf where invalid.
// One function for both, so that lanes evaluating either run the same
// instructions.
__device__ __forceinline__ float binom_lp(float n, float y, float r, bool nu) {
  const float r_ = fmaxf(r, F(1e-30));
  const float lpm = nu ? F(kLogPNu) : log_pm(r_);
  const float rr = nu ? F(kNu) : r_;
  const float lp = ((lgamma_diff(n, y) - lgamma1p(y)) + y * lpm) - (n - y) * rr;
  return valid_cell(n, y) ? lp : -INFINITY;
}

// log_pm with its branches taken, for the plane passes, where a warp's
// cells mostly share a branch; the same values as log_pm.
__device__ __forceinline__ float log_pm_branch(float r) {
  const float r_safe = fmaxf(r, F(1e-30));
  const float em = expf(-r_safe);
  if (r > 5.0f) return -em * (1.0f + em * (0.5f + em / 3.0f));
  if (r > F(1e-2)) return logf(fmaxf(1.0f - em, F(1e-30)));
  return logf(r_safe) +
         logf(1.0f - r_safe * (0.5f - r_safe * (F(1.0 / 6.0) - r_safe / 24.0f)));
}

// With no events (k == 0) the first term is a signed zero, so the result
// is -(n - k)(r_new - r_old) without the two log_pm: the same value, and
// most plane cells have no events.
__device__ __forceinline__ float rate_diff(float n, float k, float r_old,
                                           float r_new) {
  const float dr = (n - k) * (r_new - r_old);
  if (k == 0.0f) return 0.0f - dr;
  return k * (log_pm_branch(r_new) - log_pm_branch(r_old)) - dr;
}

__device__ float clip_decay(float d) {
  return fminf(fmaxf(d, F(1e-3)), F(1.0 - 1e-6));
}

__device__ float pow_k(float base, float expo) {
  return expf(expo * logf(base));
}

// d ~ decay^(|d|-1) on {-left..-1} u {1..right}
__device__ void two_sided_geometric(float u_side, float u_j, int left,
                                    int right, float decay, int* d,
                                    float* log_mass) {
  decay = clip_decay(decay);
  float left_f = static_cast<float>(left);
  float right_f = static_cast<float>(right);
  float mass_l = 1.0f - pow_k(decay, left_f);
  float mass_r = 1.0f - pow_k(decay, right_f);
  float total = fmaxf(mass_l + mass_r, F(1e-30));
  bool go_right = u_side < mass_r / total;
  float side_len = go_right ? right_f : left_f;
  float side_mass = 1.0f - pow_k(decay, side_len);
  float j = ceilf(logf(fmaxf(1.0f - u_j * side_mass, F(1e-30))) / logf(decay));
  j = fminf(fmaxf(j, 1.0f), fmaxf(side_len, 1.0f));
  *d = go_right ? static_cast<int>(j) : static_cast<int>(-j);
  *log_mass = logf(total);
}

// x ~ decay^(x-1) on {1..cap}
__device__ void truncated_geometric(float u, float cap, float decay, float* x,
                                    float* log_mass) {
  decay = clip_decay(decay);
  float cap_f = fmaxf(cap, 1.0f);
  float mass = 1.0f - pow_k(decay, cap_f);
  float v = ceilf(logf(fmaxf(1.0f - u * mass, F(1e-30))) / logf(decay));
  *x = fminf(fmaxf(v, 1.0f), cap_f);
  *log_mass = logf(fmaxf(mass, F(1e-30)));
}

__device__ float log_mass_geometric(float cap, float decay) {
  decay = clip_decay(decay);
  float cap_f = fmaxf(cap, 1.0f);
  return logf(fmaxf(1.0f - pow_k(decay, cap_f), F(1e-30)));
}

__device__ float gumbel(float u) {
  u = fminf(fmaxf(u, F(1e-7)), F(1.0 - 1e-7));
  return -logf(-logf(u));
}

__device__ float log_u_accept(float u) {
  return logf(fminf(fmaxf(u, F(1e-38)), 1.0f));
}

// ---------------------------------------------------------------------------
// Fixed-order reductions.  The block-wide ones must be called by every
// thread of the block, the warp-wide ones by every lane of the warp.
// ---------------------------------------------------------------------------

struct Reduce {
  float v[kWarps + 1];
  int i[kWarps + 1];
};

// Lane 0 gets the sum.
__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ float block_sum(float v, Reduce* r) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) r->v[w] = v;
  __syncthreads();
  if (w == 0) {
    float s = lane < kWarps ? r->v[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) r->v[kWarps] = s;
  }
  __syncthreads();
  return r->v[kWarps];
}

// Keeps the larger value; ties go to the lower index (jnp.argmax).
__device__ void arg_merge(float* v, int* i, float ov, int oi) {
  if (ov > *v || (ov == *v && oi < *i)) {
    *v = ov;
    *i = oi;
  }
}

__device__ void warp_argmax(float* v, int* i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, *v, o);
    int oi = __shfl_down_sync(0xffffffffu, *i, o);
    arg_merge(v, i, ov, oi);
  }
}

// Every lane gets the warp's best (value, index): the order is total, so
// both lanes of a butterfly pair keep the same pair.
__device__ void warp_argmax_all(float* v, int* i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, *v, o);
    int oi = __shfl_xor_sync(0xffffffffu, *i, o);
    arg_merge(v, i, ov, oi);
  }
}

// Each thread passes its own best (value, index), or (-inf, INT_MAX) if it
// had no element; all -inf gives the lowest index.
__device__ int block_argmax(float v, int i, Reduce* r) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  warp_argmax(&v, &i);
  if (lane == 0) {
    r->v[w] = v;
    r->i[w] = i;
  }
  __syncthreads();
  if (w == 0) {
    float bv = lane < kWarps ? r->v[lane] : -INFINITY;
    int bi = lane < kWarps ? r->i[lane] : INT_MAX;
    warp_argmax(&bv, &bi);
    if (lane == 0) r->i[kWarps] = bi;
  }
  __syncthreads();
  return r->i[kWarps];
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct Args {
  const float *tbl, *ttbl, *ev_in, *st_in, *cm_in, *lp_in, *eta, *pw, *rir,
      *N, *cs, *dec;
  float *ev, *st, *cm, *lp_out, *trace, *work;
  int C, M, T, U, W, LT, mmax, nmax, dmax, onmax, t_lo, t_hi, guided;
  int ev_cell_major, st_cell_major, vec;
  float one_minus_gf, gf_over_m;
};

// One proposal slot; for the rate-only plane passes also a window
// [lo, hi] of days where w(t) = (t > t_dst) - (t > t_src) is +-1, and
// xn = x / N[loc], the rank-1 scale.  An occult at t0 is the slot
// (t_src = T, t_dst = t0).
struct Slot {
  int loc, t_src, t_dst, d, lo, hi, moves, active;
  float x, xn, lq;
};

// Scalars shared by the block.
struct Shared {
  Reduce red;
  float cand_v[kWarps][kMmaxLimit];  // each warp's best mmax gumbels
  int cand_i[kWarps][kMmaxLimit];
  float part[kWarps][kMmaxLimit];  // each warp's per-slot plane sums
  // each warp's share of its slot's day scan and column delta
  float w_nz[kWarps], w_bv[kWarps], w_col[kWarps];
  int w_bi[kWarps];
  Slot slot[kMmaxLimit];
  int nd;  // days in the plan
  float lp;
  int acc;
  // occult
  int t, is_add, can_delete;
  float dx, count, x_add, cap_del;
};

__device__ float step_w(int t, int td, int ts) {
  return (t > td ? 1.0f : 0.0f) - (t > ts ? 1.0f : 0.0f);
}

__device__ bool in_window(const Slot& sl, int t) {
  return sl.moves && t >= sl.lo && t <= sl.hi;
}

// The values of one plane cell that the rate-only delta reads.
struct Cell {
  float S, y0, I, cm, eta;
};

struct Chain {
  const Args& a;
  Shared& s;
  int M, T, MT, mmax, LS;  // LS = 2 mmax staged day lanes
  float *ev, *st, *cm, *tr;  // this chain's output planes and trace
  float* work;  // [M][T]: the E->I move's accepted commute cells
  const float *eta, *cs;
  // shared memory
  const float *N, *pw, *rir;
  float *g, *guide;
  float* csr;  // the slots' Cstar rows [mmax][M]
  float* colb;  // the slots' location columns [mmax][kColPlanes][T]
  int* plan;  // the plane passes' days [T]
  const float *row, *tsel;  // the current multiscan's staged uniforms
  int tid, lane, w;
  // a slot's day work runs on a group of G = kWarps / mmax warps: this
  // thread's group (a slot when grp < mmax) and its place gt in it
  int G, grp, gt;

  __device__ float* ev_col(int k, int loc) { return ev + k * MT + loc * T; }
  __device__ float* st_col(int k, int loc) { return st + k * MT + loc * T; }
  // slot i's staged column of plane p
  __device__ float* cb(int i, int p) { return colb + (i * kColPlanes + p) * T; }

  // Stages day t of the column of loc that a kernel on plane k reads
  // (S->E: events 0-1, state 0-2, commute, exp_eta; E->I: events 1-2,
  // state 1-2) into slot i's column buffer: independent loads, in flight
  // together.
  __device__ void stage_day(int i, int loc, int t, int k) {
    const int c = loc * T + t;
    if (k == 0) {
      cb(i, kEv0)[t] = ev[c];
      cb(i, kEv1)[t] = ev[MT + c];
      cb(i, kSt0)[t] = st[c];
      cb(i, kSt1)[t] = st[MT + c];
      cb(i, kSt2)[t] = st[2 * MT + c];
      cb(i, kCm)[t] = cm[c];
      cb(i, kEta)[t] = eta[c];
    } else {
      cb(i, kEv1)[t] = ev[MT + c];
      cb(i, kEv2)[t] = ev[2 * MT + c];
      cb(i, kSt1)[t] = st[MT + c];
      cb(i, kSt2)[t] = st[2 * MT + c];
    }
  }

  // S->E rate at (loc, t) from slot i's staged column, as rate_se_col
  __device__ float rate_se(int i, int loc, int t) {
    return (cb(i, kEta)[t] * (cb(i, kSt2)[t] + pw[t] * cb(i, kCm)[t])) /
               N[loc] +
           F(kRateEps);
  }

  // Term q of day t's column delta for a kernel on plane k (0: S->E, 1:
  // E->I) from slot i's staged column, when x w(t) events move between
  // the plane's two compartments and ev_d between its event days: q = 0, 1
  // the two log-pmfs before, q = 2, 3 after.
  __device__ float col_term(int q, int i, int k, int loc, int t, float xw,
                            float ev_d) {
    const bool after = q >= 2, second = q & 1;
    if (k == 0) {
      const float S = cb(i, kSt0)[t], E = cb(i, kSt1)[t];
      const float y0 = cb(i, kEv0)[t], y1 = cb(i, kEv1)[t];
      const float n = second ? (after ? E + xw : E) : (after ? S - xw : S);
      const float y = second ? y1 : (after ? y0 + ev_d : y0);
      return binom_lp(n, y, rate_se(i, loc, t), second);
    }
    const float E = cb(i, kSt1)[t], I = cb(i, kSt2)[t];
    const float y1 = cb(i, kEv1)[t], y2 = cb(i, kEv2)[t];
    const float n = second ? (after ? I + xw : I) : (after ? E - xw : E);
    const float y = second ? y2 : (after ? y1 + ev_d : y1);
    return binom_lp(n, y, rir[t], !second);
  }

  // This thread's share of the column delta of slot i's staged column when
  // x events move from day t_src to t_dst (an occult is t_src = T): four
  // lanes a day, lane q of a quad evaluating term q and its lane 0
  // combining them in the reference's order, a move's (new0 + new1) -
  // (old0 + old1) or an occult's ((new0 + new1) - old0) - old1.  Called by
  // threads gt = 0..GS-1 of a group, GS a multiple of 32.
  __device__ float col_delta(int i, int k, int loc, int gt, int GS, float x,
                             int t_dst, int t_src, bool occult) {
    const int q = gt & 3, per = GS / 4;
    float p = 0.0f;
    for (int base = 0; base < T; base += per) {
      const int t = base + (gt >> 2);
      float v = 0.0f;
      if (t < T) {
        const float w = step_w(t, t_dst, t_src);
        const float ev_d = (t == t_dst ? x : 0.0f) - (t == t_src ? x : 0.0f);
        v = col_term(q, i, k, loc, t, x * w, ev_d);
      }
      const float b = __shfl_down_sync(0xffffffffu, v, 1);
      const float c = __shfl_down_sync(0xffffffffu, v, 2);
      const float d = __shfl_down_sync(0xffffffffu, v, 3);
      if (q == 0 && t < T)
        p += occult ? ((c + d) - v) - b : (c + d) - (v + b);
    }
    return p;
  }

  // Gumbel top-mmax of g[0..M): slot i gets the i-th largest, ties to the
  // lower index, as mmax sequential argmaxes give it.  Each warp pops its
  // own best mmax (a popped element is set to -inf and no longer
  // eligible; gumbels are finite), then warp 0 merges the warps' lists.
  __device__ void top_locations() {
    float hv = -INFINITY;
    int hi = INT_MAX;
    for (int m = tid; m < M; m += kThreads)
      if (g[m] > -INFINITY) arg_merge(&hv, &hi, g[m], m);
    for (int r = 0; r < mmax; ++r) {
      float v = hv;
      int i = hi;
      warp_argmax_all(&v, &i);
      if (lane == 0) {
        s.cand_v[w][r] = v;
        s.cand_i[w][r] = i;
      }
      if (i == hi && hi != INT_MAX) {  // this lane owned the winner
        g[hi] = -INFINITY;
        hv = -INFINITY;
        hi = INT_MAX;
        for (int m = tid; m < M; m += kThreads)
          if (g[m] > -INFINITY) arg_merge(&hv, &hi, g[m], m);
      }
    }
    __syncthreads();
    if (w == 0) {
      int p = 0;  // lane l walks warp l's list
      for (int r = 0; r < mmax; ++r) {
        const bool has = lane < kWarps && p < mmax;
        const float v = has ? s.cand_v[lane][p] : -INFINITY;
        const int i = has ? s.cand_i[lane][p] : INT_MAX;
        float bv = v;
        int bi = i;
        warp_argmax_all(&bv, &bi);
        if (i == bi && i != INT_MAX) ++p;
        if (lane == 0) s.slot[r].loc = bi;
      }
    }
    __syncthreads();
  }

  // Lists, on warp 0, the days of the moving slots' windows, each under
  // the first slot whose window holds it: plan[j] = t | i0 << 16 for
  // j < s.nd.  Ends in a barrier.
  __device__ void plan_days(int n) {
    if (w == 0) {
      int off = 0;
      for (int i = 0; i < n; ++i) {
        const Slot& sl = s.slot[i];
        if (!sl.moves) continue;
        for (int t0 = sl.lo; t0 <= sl.hi; t0 += 32) {
          const int t = t0 + lane;
          bool own = t <= sl.hi;
          for (int j = 0; j < i; ++j) own = own && !in_window(s.slot[j], t);
          const unsigned ballot = __ballot_sync(0xffffffffu, own);
          if (own) plan[off + __popc(ballot & ((1u << lane) - 1u))] = t | i << 16;
          off += __popc(ballot);
        }
      }
      if (lane == 0) s.nd = off;
    }
    __syncthreads();
  }

  // The plan's cells in the order idx = j + nd m (neighbouring threads on
  // neighbouring days of one location row), walked from idx = start in
  // steps of kThreads without a division a step; past the last cell m = M.
  struct Walk {
    int m, j, sm, sj, nd;
    __device__ void step() {
      j += sj;
      m += sm;
      if (j >= nd) {
        j -= nd;
        ++m;
      }
    }
  };

  __device__ Walk walk(int start) {
    const int nd = s.nd;
    return Walk{start / nd, start % nd, kThreads / nd, kThreads % nd, nd};
  }

  // Takes the walk's cell: (m, t, first slot i0); false past the last.
  __device__ bool take(Walk* wk, int* m, int* t, int* i0) {
    const bool on = wk->m < M;
    const int p = on ? plan[wk->j] : 0;
    *m = on ? wk->m : 0;
    *t = p & 0xffff;
    *i0 = p >> 16;
    wk->step();
    return on;
  }

  __device__ Cell load_cell(int c) {
    return Cell{st[c], ev[c], st[2 * MT + c], cm[c], eta[c]};
  }

  // Slot i's step of a plane cell: the S->E rates before and after its
  // change, with I and the commute as the earlier slots left them, then
  // its own tentative update of both, as the next slot sees them.
  __device__ void plane_rates(int i, int m, int t, float pref, float pwt,
                              float* I, float* cmv, float* r_old,
                              float* r_new) {
    const Slot& sl = s.slot[i];
    const float w = step_w(t, sl.t_dst, sl.t_src);
    const float dI = (sl.x * w) * (m == sl.loc ? 1.0f : 0.0f);
    const float dcm = (sl.xn * w) * csr[i * M + m];
    *r_old = pref * (*I + pwt * *cmv) + F(kRateEps);
    *r_new = pref * ((*I + dI) + pwt * (*cmv + dcm)) + F(kRateEps);
    if (m == sl.loc) *I += sl.x * w;
    *cmv += dcm;
  }

  // Adds r to part[i] (registers: no dynamic index).
  __device__ void add_part(float* part, int i, float r) {
#pragma unroll
    for (int ii = 0; ii < kMmaxLimit; ++ii)
      if (ii == i) part[ii] += r;
  }

  // Rate-only plane delta of slots 0..n-1 applied in order (the plan of
  // plan_days): for every location m and day t of a slot's window, the
  // S->E log-pmf change when I at that slot's loc moves by x w(t) and the
  // commute by the matching rank-1 term, with I and the commute carried
  // through the earlier slots' tentative updates.  Adds each slot's terms
  // to part[slot].  A thread loads its next cell while it works on the
  // current one: the cell's first slot i0, then the rare later slots whose
  // windows overlap.
  // With split (the E->I move), each cell's two possible final commute
  // values are written before the decision: the reference's tentative
  // apply then revert by subtraction, ((cm + a0) + a1) + (-a0) + (-a1),
  // into cm, and the tentative apply ((cm + a0) + a1) into work, which
  // accept_commute copies over on accept.
  __device__ void plane_pass(int n, float* part, bool split) {
    if (s.nd == 0) return;
    Walk wk = walk(tid);
    int m, t, i0;
    bool on = take(&wk, &m, &t, &i0);
    Cell cur = on ? load_cell(m * T + t) : Cell{};
    while (on) {
      int nm, nt, ni;
      const bool non = take(&wk, &nm, &nt, &ni);
      const Cell nx = non ? load_cell(nm * T + nt) : Cell{};
      const float pwt = pw[t];
      const float pref = cur.eta / N[m];
      float I = cur.I, cmv = cur.cm;
      for (int i = i0; i < n; ++i) {
        if (!in_window(s.slot[i], t)) continue;
        float r_old, r_new;
        plane_rates(i, m, t, pref, pwt, &I, &cmv, &r_old, &r_new);
        add_part(part, i, rate_diff(cur.S, cur.y0, r_old, r_new));
      }
      if (split) {
        float rej = cmv;
        for (int i = i0; i < n; ++i) {
          const Slot& sl = s.slot[i];
          if (in_window(sl, t))
            rej += ((-sl.xn) * step_w(t, sl.t_dst, sl.t_src)) * csr[i * M + m];
        }
        cm[m * T + t] = rej;
        work[m * T + t] = cmv;
      }
      cur = nx;
      m = nm;
      t = nt;
      i0 = ni;
      on = non;
    }
  }

  // Adds the rank-1 terms of slots 0..n-1 to the plan's commute cells,
  // each cell written once (an accepted occult).  kBatch cells a thread a
  // step, their loads first.
  __device__ void rank1_pass(int n) {
    constexpr int kBatch = 8;
    if (s.nd == 0) return;
    Walk wk = walk(tid);
    while (wk.m < M) {
      float v[kBatch];
      int m[kBatch], t[kBatch], i0[kBatch];
      bool on[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        on[j] = take(&wk, &m[j], &t[j], &i0[j]);
        if (on[j]) v[j] = cm[m[j] * T + t[j]];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (!on[j]) continue;
        float cmv = v[j];
        for (int i = i0[j]; i < n; ++i) {
          const Slot& sl = s.slot[i];
          if (in_window(sl, t[j]))
            cmv += (sl.xn * step_w(t[j], sl.t_dst, sl.t_src)) *
                   csr[i * M + m[j]];
        }
        cm[m[j] * T + t[j]] = cmv;
      }
    }
  }

  // Copies the plan's commute cells from work (an accepted E->I move).
  __device__ void accept_commute() {
    constexpr int kBatch = 8;
    if (s.nd == 0) return;
    Walk wk = walk(tid);
    while (wk.m < M) {
      float v[kBatch];
      int c[kBatch];
      bool on[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        int m, t, i0;
        on[j] = take(&wk, &m, &t, &i0);
        c[j] = m * T + t;
        if (on[j]) v[j] = work[c[j]];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (on[j]) cm[c[j]] = v[j];
    }
  }

  // Sums each of part[0..n) over the block into s.part (one barrier).
  __device__ void reduce_parts(int n, const float* part) {
#pragma unroll
    for (int i = 0; i < kMmaxLimit; ++i) {
      if (i >= n) break;
      const float v = warp_sum(part[i]);
      if (lane == 0) s.part[w][i] = v;
    }
    __syncthreads();
  }

  __device__ float plane_total(int i) {
    float p = 0.0f;
    for (int ww = 0; ww < kWarps; ++ww) p += s.part[ww][i];
    return p;
  }

  // -------------------------------------------------------------------------
  // The slots' T-day column work, slot i on warp group i, in parallel:
  // t_src, the proposal, the Hastings term and the column delta from the
  // pre-move columns (slots have distinct locations, so no slot's columns
  // see another's update).  Two barriers.
  // -------------------------------------------------------------------------
  __device__ void slot_days(int k, float decay, float x_decay, int o_side,
                            int o_j, int o_x) {
    const int GS = G * 32;
    if (grp < mmax) {
      const int loc = s.slot[grp].loc;
      float nz = 0.0f, bv = -INFINITY;
      int bi = INT_MAX;
      for (int t = gt; t < T; t += GS) {
        stage_day(grp, loc, t, k);
        const bool on = cb(grp, k)[t] > 0.0f;
        nz += on ? 1.0f : 0.0f;
        const float gt_ = gumbel(tsel[t * LS + k * mmax + grp]);
        arg_merge(&bv, &bi, on ? gt_ : -INFINITY, t);
      }
      nz = warp_sum(nz);
      warp_argmax(&bv, &bi);
      if (lane == 0) {
        s.w_nz[w] = nz;
        s.w_bv[w] = bv;
        s.w_bi[w] = bi;
      }
    }
    __syncthreads();
    if (grp < mmax) {
      const int i = grp, loc = s.slot[i].loc;
      const float* cnt = cb(i, k);
      // the group's totals in warp order; every thread of the group
      // computes the proposal from the same values
      float n_nz = 0.0f, bv = -INFINITY;
      int bi = INT_MAX;
      for (int ww = i * G; ww < (i + 1) * G; ++ww) {
        n_nz += s.w_nz[ww];
        arg_merge(&bv, &bi, s.w_bv[ww], s.w_bi[ww]);
      }
      // the slot's Cstar row, for the E->I move's plane passes
      if (k == 1)
        for (int m = gt; m < M; m += GS)
          csr[i * M + m] = cs[static_cast<size_t>(loc) * M + m];
      const int t_src = bi;
      const int left = min(a.dmax, t_src);
      const int right = min(a.dmax, T - 1 - t_src);
      int d;
      float lm_fwd, x, lm_x_fwd;
      two_sided_geometric(row[o_side + i], row[o_j + i], left, right, decay,
                          &d, &lm_fwd);
      const float c_src = cnt[t_src];
      const float cap_fwd = fminf(F(a.nmax), c_src);
      truncated_geometric(row[o_x + i], cap_fwd, x_decay, &x, &lm_x_fwd);
      const bool active = (n_nz > 0.0f) && (left + right > 0);
      x = active ? x : 0.0f;
      const int t_dst = min(max(t_src + d, 0), T - 1);
      // days with events after the move: the count changes only at t_src
      // (by -x) and t_dst (by +x); integer counts, so exact
      const float c_dst = cnt[t_dst];
      float n_nz_new = n_nz;
      if (t_dst != t_src)
        n_nz_new = (((n_nz - (c_src > 0.0f ? 1.0f : 0.0f)) +
                     (c_src + (-x) > 0.0f ? 1.0f : 0.0f)) -
                    (c_dst > 0.0f ? 1.0f : 0.0f)) +
                   (c_dst + x > 0.0f ? 1.0f : 0.0f);
      const float w_ev = x - (t_dst == t_src ? x : 0.0f);
      const float count_dst_new = c_dst + w_ev;
      const float cap_rev = fminf(F(a.nmax), count_dst_new);
      const int left_r = min(a.dmax, t_dst);
      const int right_r = min(a.dmax, T - 1 - t_dst);
      const float dec_c = clip_decay(decay);
      const float mass_rev =
          (1.0f - pow_k(dec_c, static_cast<float>(left_r))) +
          (1.0f - pow_k(dec_c, static_cast<float>(right_r)));
      const float lq =
          ((-logf(fmaxf(n_nz_new, 1.0f)) -
            log_mass_geometric(cap_rev, x_decay)) -
           logf(fmaxf(mass_rev, F(1e-30)))) -
          ((-logf(fmaxf(n_nz, 1.0f)) - lm_x_fwd) - lm_fwd);

      float p = col_delta(i, k, loc, gt, GS, x, t_dst, t_src, false);
      p = warp_sum(p);
      if (lane == 0) s.w_col[w] = p;
      if (gt == 0) {
        Slot& sl = s.slot[i];
        sl.t_src = t_src;
        sl.t_dst = t_dst;
        sl.d = d;
        sl.x = x;
        sl.xn = x / N[loc];
        sl.lo = min(t_src, t_dst) + 1;
        sl.hi = max(t_src, t_dst);
        sl.moves = x != 0.0f && sl.lo <= sl.hi;
        sl.active = active;
        sl.lq = lq;
      }
    }
    __syncthreads();
  }

  // slot i's column delta: its group's warps in order
  __device__ float slot_col(int i) {
    float p = 0.0f;
    for (int ww = i * G; ww < (i + 1) * G; ++ww) p += s.w_col[ww];
    return p;
  }

  // -------------------------------------------------------------------------
  // One move application (k = 0: S->E, k = 1: E->I); fused_sweep.py:_move
  // -------------------------------------------------------------------------
  __device__ void move(int k, float decay, float x_decay, int trace_row) {
    const int base = k * (M + 3 * mmax + 1);
    const int o_side = base + M, o_j = base + M + mmax,
              o_x = base + M + 2 * mmax, o_acc = base + M + 3 * mmax;

    for (int m = tid; m < M; m += kThreads) g[m] = gumbel(row[base + m]);
    top_locations();
    PHASE(kPhMoveTopk + k);
    slot_days(k, decay, x_decay, o_side, o_j, o_x);
    PHASE(kPhMoveDays + k);

    float part[kMmaxLimit];
#pragma unroll
    for (int i = 0; i < kMmaxLimit; ++i) part[i] = 0.0f;
    if (k == 1) {
      plan_days(mmax);
      plane_pass(mmax, part, true);
      reduce_parts(mmax, part);
      PHASE(kPhMovePlane);
    }
    if (tid == 0) {
      // per-slot terms combined in the reference's order
      float hastings = 0.0f, delta = 0.0f;
      for (int i = 0; i < mmax; ++i) {
        const Slot& sl = s.slot[i];
        hastings = hastings + (sl.active ? sl.lq : 0.0f);
      }
      for (int i = 0; i < mmax; ++i) {
        if (k == 0) {
          delta = delta + slot_col(i);
        } else {
          const float plane = s.slot[i].moves ? plane_total(i) : 0.0f;
          delta = (delta + slot_col(i)) + plane;
        }
      }
      const float log_alpha = delta + hastings;
      const bool acc = log_u_accept(row[o_acc]) < log_alpha;
      s.acc = acc;
      s.lp = s.lp + (acc ? delta : 0.0f);
      float* r = tr + trace_row * (2 + 4 * mmax);
      r[0] = acc ? 1.0f : 0.0f;
      r[1] = s.lp;
      for (int i = 0; i < mmax; ++i) {
        r[2 + i] = static_cast<float>(s.slot[i].loc);
        r[2 + mmax + i] = static_cast<float>(s.slot[i].t_src);
        r[2 + 2 * mmax + i] = static_cast<float>(s.slot[i].d);
        r[2 + 3 * mmax + i] = s.slot[i].x;
      }
    }
    __syncthreads();
    PHASE(kPhMoveDecision + k);

    const bool acc = s.acc;
    if (k == 0) {
      if (acc && grp < mmax) {
        const Slot sl = s.slot[grp];
        for (int t = gt; t < T; t += G * 32) {
          const float wt = step_w(t, sl.t_dst, sl.t_src);
          const float ev_d = (t == sl.t_dst ? sl.x : 0.0f) -
                             (t == sl.t_src ? sl.x : 0.0f);
          ev_col(0, sl.loc)[t] = cb(grp, kEv0)[t] + ev_d;
          st_col(0, sl.loc)[t] = cb(grp, kSt0)[t] + (-sl.x) * wt;
          st_col(1, sl.loc)[t] = cb(grp, kSt1)[t] + sl.x * wt;
        }
      }
    } else {
      // the commute holds the reference's revert by subtraction (written
      // by the plane pass); on accept, its tentative apply
      if (acc) accept_commute();
      if (grp < mmax) {
        const Slot sl = s.slot[grp];
        for (int t = gt; t < T; t += G * 32) {
          const float wt = step_w(t, sl.t_dst, sl.t_src);
          const float ev_d = (t == sl.t_dst ? sl.x : 0.0f) -
                             (t == sl.t_src ? sl.x : 0.0f);
          float e1 = cb(grp, kEv1)[t] + ev_d;
          float s1 = cb(grp, kSt1)[t] + (-sl.x) * wt;
          float s2 = cb(grp, kSt2)[t] + sl.x * wt;
          if (!acc) {
            e1 += -ev_d;
            s1 += sl.x * wt;
            s2 += (-sl.x) * wt;
          }
          ev_col(1, sl.loc)[t] = e1;
          st_col(1, sl.loc)[t] = s1;
          st_col(2, sl.loc)[t] = s2;
        }
      }
    }
    __syncthreads();
    PHASE(kPhMoveApply + k);
  }

  // -------------------------------------------------------------------------
  // One occult add/delete application; fused_sweep.py:_occult
  // -------------------------------------------------------------------------
  __device__ void occult(int k, float x_decay, int trace_row) {
    const int base = 2 * (M + 3 * mmax + 1) + k * (M + 4);
    const int o_t = base + M, o_dir = base + M + 1, o_x = base + M + 2,
              o_acc = base + M + 3;
    const float onmax = F(a.onmax);

    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int m = tid; m < M; m += kThreads) {
      float gm = gumbel(row[base + m]);
      if (a.guided) gm = gm + guide[m];
      arg_merge(&bv, &bi, gm, m);
    }
    const int loc = block_argmax(bv, bi, &s.red);
    for (int t = tid; t < T; t += kThreads) stage_day(0, loc, t, k);
    if (k == 1)
      for (int m = tid; m < M; m += kThreads)
        csr[m] = cs[static_cast<size_t>(loc) * M + m];
    if (tid == 0) {
      int t = a.t_lo + static_cast<int>(
                           floorf(row[o_t] * F(a.t_hi - a.t_lo)));
      t = min(max(t, a.t_lo), a.t_hi - 1);
      const bool is_add = row[o_dir] < 0.5f;
      const float count = ev_col(k, loc)[t];
      const float cap_del = fminf(onmax, count);
      float x_add, x_del, unused;
      truncated_geometric(row[o_x], onmax, x_decay, &x_add, &unused);
      truncated_geometric(row[o_x], cap_del, x_decay, &x_del, &unused);
      const bool can_delete = count > 0.0f;
      const float x = is_add ? x_add : (can_delete ? x_del : 0.0f);
      const float dx = is_add ? x : -x;
      s.t = t;
      s.is_add = is_add;
      s.can_delete = can_delete;
      s.count = count;
      s.cap_del = cap_del;
      s.x_add = x_add;
      s.dx = dx;
      // rate-only cells: an occult at t perturbs I only at days > t, the
      // window of the slot (t_src = T, t_dst = t)
      Slot& sl = s.slot[0];
      sl.loc = loc;
      sl.t_src = T;
      sl.t_dst = t;
      sl.lo = t + 1;
      sl.hi = T - 1;
      sl.x = dx;
      sl.xn = dx / N[loc];
      sl.moves = k == 1 && dx != 0.0f && sl.lo <= sl.hi;
      // the plan: the window's days, in order
      s.nd = sl.moves ? sl.hi - sl.lo + 1 : 0;
      for (int j = 0; j < s.nd; ++j) plan[j] = sl.lo + j;
    }
    __syncthreads();
    PHASE(kPhOccultPick + k);
    const int t0 = s.t;
    const float dx = s.dx;
    const bool perturbs = s.slot[0].moves;
    // part[0]: the rate-only plane delta; part[1]: the column delta
    float part[kMmaxLimit] = {};
    // an occult at t0 is the move (t_src = T, t_dst = t0): w(t) = t > t0
    part[1] = col_delta(0, k, loc, tid, kThreads, dx, t0, T, true);
    if (perturbs) plane_pass(1, part, false);
    reduce_parts(2, part);
    PHASE(kPhOccultDelta + k);
    if (tid == 0) {
      const float col = plane_total(1);
      const float plane = perturbs ? plane_total(0) : 0.0f;
      const float delta = col + plane;
      const float log_h_add =
          log_mass_geometric(onmax, x_decay) -
          log_mass_geometric(fminf(onmax, s.count + s.x_add), x_decay);
      const float log_h_del = log_mass_geometric(s.cap_del, x_decay) -
                              log_mass_geometric(onmax, x_decay);
      const float hastings = s.is_add ? log_h_add : log_h_del;
      const bool is_null = !s.is_add && !s.can_delete;
      const float log_alpha = delta + hastings;
      const bool acc = !is_null && (log_u_accept(row[o_acc]) < log_alpha);
      s.acc = acc;
      s.lp = s.lp + (acc ? delta : 0.0f);
      float* r = tr + trace_row * (2 + 4 * mmax);
      r[0] = acc ? 1.0f : 0.0f;
      r[1] = s.lp;
      r[2] = static_cast<float>(loc);
      r[3] = static_cast<float>(t0);
      r[4] = s.is_add ? 1.0f : -1.0f;
      r[5] = fabsf(dx);
    }
    __syncthreads();
    PHASE(kPhOccultDecision + k);
    if (s.acc) {
      for (int t = tid; t < T; t += kThreads) {
        const float wt = t > t0 ? 1.0f : 0.0f;
        if (t == t0) ev_col(k, loc)[t] = cb(0, kEv0 + k)[t] + dx;
        st_col(k, loc)[t] = cb(0, kSt0 + k)[t] + (-dx) * wt;
        st_col(k + 1, loc)[t] = cb(0, kSt0 + k + 1)[t] + dx * wt;
      }
      if (perturbs) rank1_pass(1);
    }
    __syncthreads();
    PHASE(kPhOccultApply + k);
  }
};

// ---------------------------------------------------------------------------
// Copy-in: the caller's tensors to the location-major output planes
// ---------------------------------------------------------------------------

constexpr int kCopyInFlight = 8;  // 16-byte loads in flight a thread

// n floats, 16 bytes at a time when vec (n % 4 == 0, both 16-byte
// aligned), kCopyInFlight loads in flight a thread.
__device__ void copy_flat(const float* __restrict__ src,
                          float* __restrict__ dst, int n, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
    float4* __restrict__ d4 = reinterpret_cast<float4*>(dst);
    const int n4 = n / 4;
    for (int b = tid; b < n4; b += kCopyInFlight * kThreads) {
      float4 v[kCopyInFlight];
#pragma unroll
      for (int j = 0; j < kCopyInFlight; ++j)
        if (b + j * kThreads < n4) v[j] = s4[b + j * kThreads];
#pragma unroll
      for (int j = 0; j < kCopyInFlight; ++j)
        if (b + j * kThreads < n4) d4[b + j * kThreads] = v[j];
    }
  } else {
    for (int i = tid; i < n; i += kThreads) dst[i] = src[i];
  }
}

// State [M, T, 4], one float4 a cell, to four planes [4][M][T].
__device__ void copy_state_cells(const float* __restrict__ src,
                                 float* __restrict__ st, int MT) {
  const int tid = threadIdx.x;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
  for (int b = tid; b < MT; b += kCopyInFlight * kThreads) {
    float4 v[kCopyInFlight];
#pragma unroll
    for (int j = 0; j < kCopyInFlight; ++j)
      if (b + j * kThreads < MT) v[j] = s4[b + j * kThreads];
#pragma unroll
    for (int j = 0; j < kCopyInFlight; ++j) {
      const int i = b + j * kThreads;
      if (i < MT) {
        st[i] = v[j].x;
        st[MT + i] = v[j].y;
        st[2 * MT + i] = v[j].z;
        st[3 * MT + i] = v[j].w;
      }
    }
  }
}

// Events to three planes [3][M][T], one warp a location row, two rows a
// warp at a time; lane 0 of the row's warp writes the row's plane-2 sum
// over [t_lo, t_hi) to guide_raw[m] (integers: exact in any order).
// Cell-major rows are [T][3]; vec (T % 4 == 0) moves four cells, 48
// bytes, a lane a step.
__device__ void copy_events(const float* __restrict__ src,
                            float* __restrict__ ev, int M, int T,
                            bool cell_major, bool vec, int t_lo, int t_hi,
                            float* guide_raw) {
  constexpr int kRows = 2;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int MT = M * T;
  for (int m0 = w; m0 < M; m0 += kRows * kWarps) {
    float cw[kRows] = {};
    if (vec) {
      for (int gi = lane; gi < T / 4; gi += 32) {
        const int t = 4 * gi;
        float4 p[kRows][3];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int m = m0 + r * kWarps;
          if (m >= M) break;
          if (cell_major) {
            const float4* q =
                reinterpret_cast<const float4*>(src + 3 * (m * T + t));
            const float4 a0 = q[0], a1 = q[1], a2 = q[2];
            p[r][0] = make_float4(a0.x, a0.w, a1.z, a2.y);
            p[r][1] = make_float4(a0.y, a1.x, a1.w, a2.z);
            p[r][2] = make_float4(a0.z, a1.y, a2.x, a2.w);
          } else {
#pragma unroll
            for (int x = 0; x < 3; ++x)
              p[r][x] = *reinterpret_cast<const float4*>(src + x * MT +
                                                         m * T + t);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int m = m0 + r * kWarps;
          if (m >= M) break;
#pragma unroll
          for (int x = 0; x < 3; ++x)
            *reinterpret_cast<float4*>(ev + x * MT + m * T + t) = p[r][x];
          const float y2[4] = {p[r][2].x, p[r][2].y, p[r][2].z, p[r][2].w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (t + j >= t_lo && t + j < t_hi) cw[r] += y2[j];
        }
      }
    } else {
      for (int t = lane; t < T; t += 32) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int m = m0 + r * kWarps;
          if (m >= M) break;
          const int c = m * T + t;
          float y[3];
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            y[x] = cell_major ? src[3 * c + x] : src[x * MT + c];
            ev[x * MT + c] = y[x];
          }
          if (t >= t_lo && t < t_hi) cw[r] += y[2];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = warp_sum(cw[r]);
      if (lane == 0 && m0 + r * kWarps < M) guide_raw[m0 + r * kWarps] = v;
    }
  }
}

// The chain's per-multiscan uniforms into shared memory, asynchronously:
// the tbl row's used columns and the ttbl row's first LS lanes of each
// day.
__device__ void stage_tables(const Args& a, int c, int u, int Wu, int LS,
                             float* tab, float* tt) {
  const int tid = threadIdx.x;
  const size_t cu = static_cast<size_t>(c) * a.U + u;
  const float* src = a.tbl + cu * a.W;
  for (int j = tid; j < Wu; j += kThreads)
    __pipeline_memcpy_async(tab + j, src + j, sizeof(float));
  const float* tsrc = a.ttbl + cu * a.T * a.LT;
  for (int j = tid; j < a.T * LS; j += kThreads)
    __pipeline_memcpy_async(tt + j, tsrc + (j / LS) * a.LT + j % LS,
                            sizeof(float));
}

__device__ int used_width(int M, int mmax) {
  return 2 * (M + 3 * mmax + 1) + 2 * (M + 4);
}

__global__ void __launch_bounds__(kThreads)
    fused_sweep_kernel(const __grid_constant__ Args a) {
  extern __shared__ float dyn[];
  __shared__ Shared s;
  const int c = blockIdx.x, tid = threadIdx.x;
  PHASE_START();
  const int M = a.M, T = a.T, MT = M * T, mmax = a.mmax, LS = 2 * mmax;
  const int Wu = used_width(M, mmax);
  const size_t c3 = static_cast<size_t>(c) * 3 * MT;
  const size_t c4 = static_cast<size_t>(c) * 4 * MT;
  const size_t c1 = static_cast<size_t>(c) * MT;
  const int tw = 2 + 4 * mmax;
  // dynamic shared memory: N, guide, g [M]; psi_w, rate_ir_t [T]; two
  // buffers of the multiscan's tbl row [Wu] and ttbl lanes [T * LS]; the
  // slots' Cstar rows [mmax * M] and location columns [mmax * 8 * T];
  // the plane passes' plan [T]
  float* sh_N = dyn;
  float* sh_guide = dyn + M;
  float* sh_g = dyn + 2 * M;
  float* sh_pw = dyn + 3 * M;
  float* sh_rir = sh_pw + T;
  float* sh_tab = sh_rir + T;
  float* sh_tt = sh_tab + 2 * Wu;
  float* sh_cs = sh_tt + 2 * T * LS;
  float* sh_col = sh_cs + mmax * M;
  int* sh_plan = reinterpret_cast<int*>(sh_col + kColPlanes * T * mmax);

  for (int i = tid; i < M; i += kThreads)
    __pipeline_memcpy_async(sh_N + i, a.N + i, sizeof(float));
  for (int i = tid; i < T; i += kThreads) {
    __pipeline_memcpy_async(sh_pw + i, a.pw + c * T + i, sizeof(float));
    __pipeline_memcpy_async(sh_rir + i, a.rir + c * T + i, sizeof(float));
  }
  if (a.U > 0) stage_tables(a, c, 0, Wu, LS, sh_tab, sh_tt);
  __pipeline_commit();

  // copy-in; the sweep then updates the outputs in place
  float* ev = a.ev + c3;
  float* st = a.st + c4;
  float* cm = a.cm + c1;
  float* tr = a.trace + static_cast<size_t>(c) * 4 * tw;
  const bool vec = a.vec;
  copy_events(a.ev_in + c3, ev, M, T, a.ev_cell_major, vec, a.t_lo, a.t_hi,
              sh_guide);
  if (a.st_cell_major)
    copy_state_cells(a.st_in + c4, st, MT);
  else
    copy_flat(a.st_in + c4, st, 4 * MT, vec);
  copy_flat(a.cm_in + c1, cm, MT, vec);
  for (int i = tid; i < 4 * tw; i += kThreads) tr[i] = 0.0f;
  if (tid == 0) s.lp = a.lp_in[c];
  __syncthreads();
  PHASE(kPhCopyIn);

  if (a.guided) {
    // case_guide_logits: observed I->R cases over the occult window with a
    // uniform floor; events[..., 2] is never modified by the sweep
    float part = 0.0f;
    for (int m = tid; m < M; m += kThreads) part += sh_guide[m];
    const float total = block_sum(part, &s.red);
    for (int m = tid; m < M; m += kThreads) {
      const float w =
          total > 0.0f ? (a.one_minus_gf * sh_guide[m]) / fmaxf(total, 1.0f)
                       : 0.0f;
      sh_guide[m] = logf(w + a.gf_over_m);
    }
  }

  PHASE(kPhGuide);
  const float* dec = a.dec + static_cast<size_t>(c) * 5;
  const float d_mse = dec[0], d_mei = dec[1], d_xse = dec[2],
              d_xei = dec[3], d_occ = dec[4];
  const int G = kWarps / mmax, grp = (tid >> 5) / G;
  Chain ch{a, s, M, T, MT, mmax, LS, ev, st, cm, tr, a.work + c1,
           a.eta + c1, a.cs,
           sh_N, sh_pw, sh_rir, sh_g, sh_guide, sh_cs, sh_col, sh_plan,
           nullptr, nullptr,
           tid, tid & 31, tid >> 5, G, grp, tid - grp * G * 32};
  for (int u = 0; u < a.U; ++u) {
    const int buf = u & 1;
    // the next multiscan's uniforms load while this one runs
    if (u + 1 < a.U)
      stage_tables(a, c, u + 1, Wu, LS, sh_tab + (buf ^ 1) * Wu,
                   sh_tt + (buf ^ 1) * T * LS);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    PHASE(kPhStage);
    ch.row = sh_tab + buf * Wu;
    ch.tsel = sh_tt + buf * T * LS;
    ch.move(0, d_mse, d_xse, 0);
    ch.move(1, d_mei, d_xei, 1);
    ch.occult(0, d_occ, 2);
    ch.occult(1, d_occ, 3);
  }
  if (tid == 0) a.lp_out[c] = s.lp;
}

}  // namespace

extern "C" int fused_sweep_launch(
    const float* tbl, const float* ttbl, const float* ev_in,
    const float* st_in, const float* cm_in, const float* lp_in,
    const float* eta, const float* pw, const float* rir, const float* N,
    const float* cs, const float* dec, float* ev, float* st, float* cm,
    float* lp_out, float* trace, float* work, int C, int M, int T, int U,
    int W, int LT, int mmax, int nmax, int dmax, int onmax, int t_lo,
    int t_hi, int guided,
    int ev_cell_major, int st_cell_major, int vec, float one_minus_gf,
    float gf_over_m, void* stream) {
  if (mmax < 1 || mmax > kMmaxLimit || M < mmax || LT < 2 * mmax)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{tbl, ttbl, ev_in, st_in, cm_in, lp_in, eta, pw, rir, N, cs, dec,
         ev, st, cm, lp_out, trace, work, C, M, T, U, W, LT, mmax, nmax, dmax,
         onmax, t_lo, t_hi, guided, ev_cell_major, st_cell_major, vec,
         one_minus_gf, gf_over_m};
  const int Wu = 2 * (M + 3 * mmax + 1) + 2 * (M + 4);
  if (W < Wu) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem =
      ((3 + static_cast<size_t>(mmax)) * M + 2 * T +
       2 * static_cast<size_t>(Wu) +
       (4 + kColPlanes) * static_cast<size_t>(T) * mmax + T) *
      sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_sweep_kernel<<<C, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef K1_PHASES
// Copies the per-block phase cycles [kPhaseBlocks][kPhases] to host and
// zeroes them.
extern "C" int fused_sweep_phase_cycles(unsigned long long* host) {
  void* dev = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&dev, g_phase_cycles);
  if (e == cudaSuccess)
    e = cudaMemcpy(host, dev, sizeof(g_phase_cycles), cudaMemcpyDeviceToHost);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, sizeof(g_phase_cycles));
  return static_cast<int>(e);
}
#endif
