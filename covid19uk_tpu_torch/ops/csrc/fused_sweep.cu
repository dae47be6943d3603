// Fused event sweep for Hopper (sm_90a): all U multiscans of the four
// Metropolis-Hastings event kernels of one chain in one thread block.
//
// Replaces covid19uk_tpu/ops/pallas/fused_sweep.py:fused_sweep (the Pallas
// TPU kernel _build_kernel.kernel: move_kernel, occult_kernel, multiscan).
// Its plain PyTorch version is fused_sweep_reference in ../fused_sweep.py;
// both evaluate the same formulas in the same order of float32 operations
// (built with -fmad=false), so they make the same decisions.
//
// What bounds it on this card: latency, not bytes.  A sweep is about 20
// serially dependent MH applications per chain (U = 5 x 4), each a few
// block-wide reductions and barriers around one thread's scalar decision;
// the planes of a chain (events, state, commute, exp_eta: 1.64 MB at
// M = 380, T = 120) are read and written a few times in all, far less than
// the card's memory rate could move in the time the barriers take.  With
// one block per chain only 64 of the 132 SMs are busy at C = 64.
// What this first design does about it: nothing yet.  Correctness first;
// the planes stay in global memory (L2), location-major ([plane][M][T]) so
// one location's day column is contiguous.
//
// Synchronisation rule: every __syncthreads() is reached by the whole
// block.  Scalar decisions are made by thread 0 after block reductions,
// put in shared memory, and read by all threads after a barrier; every
// branch around a barrier depends only on such shared values.
// Reductions are in a fixed order (warp shuffles, then one warp over the
// warp partials) with no atomics, so logp is the same from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kThreads = 384;  // >= M = 380, a multiple of 32
constexpr int kWarps = kThreads / 32;
constexpr int kMmaxLimit = 8;  // ops/fused_sweep.py MMAX_LIMIT

// Constants are rounded from double to float, as JAX's weakly typed
// Python scalars and PyTorch's Python scalars are.
#define F(x) static_cast<float>(x)
constexpr double kRateEps = 1e-9;
constexpr double kNu = 0.28;
constexpr double kLogPNu = -1.40970114071642;  // log(-expm1(-0.28))
constexpr double kHalfLog2Pi = 0.91893853320467274;  // 0.5 * log(2 pi)

// ---------------------------------------------------------------------------
// In-kernel numerics (fused_sweep.py:_log1p .. _gumbel)
// ---------------------------------------------------------------------------

__device__ float log1p_k(float x) {
  if (x > F(1e-3)) return logf(1.0f + fmaxf(x, F(1e-3)));
  return x * (1.0f - x * (0.5f - x / 3.0f));
}

__device__ float stirling(float z) {
  float inv = 1.0f / z;
  return (((z - 0.5f) * logf(z) - z) + F(kHalfLog2Pi)) +
         inv * (F(1.0 / 12.0) - inv * inv * F(1.0 / 360.0));
}

__device__ float lgamma_diff(float n, float k) {
  float b = n - k + 1.0f;
  float a_s = n + 3.0f;
  float b_s = b + 2.0f;
  float s_diff = ((((a_s - 0.5f) * log1p_k(k / b_s) + k * logf(b_s)) - k) +
                  F(1.0 / 12.0) * (1.0f / a_s - 1.0f / b_s)) -
                 F(1.0 / 360.0) *
                     (1.0f / (a_s * a_s * a_s) - 1.0f / (b_s * b_s * b_s));
  return (s_diff - log1p_k(k / b)) - log1p_k(k / (b + 1.0f));
}

__device__ float lgamma1p(float k) {
  float z = k + 1.0f;
  return (((stirling(z + 4.0f) - logf(z)) - logf(z + 1.0f)) -
          logf(z + 2.0f)) - logf(z + 3.0f);
}

__device__ float log_pm(float r) {
  float r_safe = fmaxf(r, F(1e-30));
  float em = expf(-r_safe);
  if (r > 5.0f) return -em * (1.0f + em * (0.5f + em / 3.0f));
  if (r > F(1e-2)) return logf(fmaxf(1.0f - em, F(1e-30)));
  return logf(r_safe) +
         logf(1.0f - r_safe * (0.5f - r_safe * (F(1.0 / 6.0) - r_safe / 24.0f)));
}

__device__ bool valid_cell(float n, float y) {
  return (y >= 0.0f) && (y <= n) && (n >= 0.0f);
}

__device__ float binom_lp_rate(float n, float y, float r) {
  if (!valid_cell(n, y)) return -INFINITY;
  float r_ = fmaxf(r, F(1e-30));
  return ((lgamma_diff(n, y) - lgamma1p(y)) + y * log_pm(r_)) - (n - y) * r_;
}

__device__ float binom_lp_nu(float n, float y) {
  if (!valid_cell(n, y)) return -INFINITY;
  return ((lgamma_diff(n, y) - lgamma1p(y)) + y * F(kLogPNu)) -
         (n - y) * F(kNu);
}

__device__ float rate_diff(float n, float k, float r_old, float r_new) {
  return k * (log_pm(r_new) - log_pm(r_old)) - (n - k) * (r_new - r_old);
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
// Fixed-order block reductions; every thread of the block must call them.
// ---------------------------------------------------------------------------

struct Reduce {
  float v[kWarps + 1];
  int i[kWarps + 1];
};

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
  float *ev, *st, *cm, *lp_out, *trace;
  int C, M, T, U, W, LT, mmax, nmax, dmax, onmax, t_lo, t_hi, guided;
  float one_minus_gf, gf_over_m;
};

struct Slot {
  int loc, t_src, t_dst, d;
  float x;
};

// Scalars shared by the block; written by thread 0 only.
struct Shared {
  Reduce red;
  Slot slot[kMmaxLimit];
  float lp, delta, hastings, log_alpha;
  float lm_fwd, lm_x_fwd, n_nz;
  int active, acc;
  // occult
  int loc, t, is_add, can_delete;
  float dx, count, x_add, cap_del;
};

struct Chain {
  const Args& a;
  Shared& s;
  float* g;      // [M] location gumbels
  float* guide;  // [M] guided occult logits
  int M, T, MT;
  float *ev, *st, *cm, *tr;
  const float *eta, *pw, *rir, *dec;
  int tid;

  __device__ float* ev_col(int k, int loc) { return ev + k * MT + loc * T; }
  __device__ float* st_col(int k, int loc) { return st + k * MT + loc * T; }

  // S->E rate at (loc, t), as rate_se_col
  __device__ float rate_se(int loc, int t) {
    return (eta[loc * T + t] * (st[2 * MT + loc * T + t] +
                                pw[t] * cm[loc * T + t])) /
               a.N[loc] +
           F(kRateEps);
  }

  // Sum over locations and over days t in [lo, hi] of the S->E log-pmf
  // change when I at loc moves by x * w(t) and commute by the matching
  // rank-1 term; w(t) = (t > td) - (t > ts).  Days outside [lo, hi] have
  // w = 0 and add exactly 0, so they are skipped.
  __device__ float plane_delta(int loc, float x, int ts, int td, int lo,
                               int hi) {
    const float n_loc = a.N[loc];
    const float* cs_row = a.cs + static_cast<size_t>(loc) * M;
    const int rows = hi - lo + 1;
    float p = 0.0f;
    for (int idx = tid; idx < rows * M; idx += kThreads) {
      const int m = idx / rows, t = lo + idx % rows;
      const float w = (t > td ? 1.0f : 0.0f) - (t > ts ? 1.0f : 0.0f);
      const int c = m * T + t;
      const float pref = eta[c] / a.N[m];
      const float dI = (x * w) * (m == loc ? 1.0f : 0.0f);
      const float dcm = ((x / n_loc) * w) * cs_row[m];
      const float I = st[2 * MT + c], cmv = cm[c];
      const float r_old = pref * (I + pw[t] * cmv) + F(kRateEps);
      const float r_new = pref * ((I + dI) + pw[t] * (cmv + dcm)) + F(kRateEps);
      p += rate_diff(st[c], ev[c], r_old, r_new);
    }
    return block_sum(p, &s.red);
  }

  // commute += (x / N[loc]) * w * Cstar[loc, :] over days [lo, hi]
  __device__ void add_rank1(int loc, float x, int ts, int td, int lo, int hi) {
    const float n_loc = a.N[loc];
    const float* cs_row = a.cs + static_cast<size_t>(loc) * M;
    const int rows = hi - lo + 1;
    for (int idx = tid; idx < rows * M; idx += kThreads) {
      const int m = idx / rows, t = lo + idx % rows;
      const float w = (t > td ? 1.0f : 0.0f) - (t > ts ? 1.0f : 0.0f);
      cm[m * T + t] += ((x / n_loc) * w) * cs_row[m];
    }
  }

  // -------------------------------------------------------------------------
  // One move application (k = 0: S->E, k = 1: E->I); fused_sweep.py:_move
  // -------------------------------------------------------------------------
  __device__ void move(int k, const float* row, const float* tsel,
                       float decay, float x_decay, int trace_row) {
    const int mmax = a.mmax;
    const int base = k * (M + 3 * mmax + 1);
    const int o_side = base + M, o_j = base + M + mmax,
              o_x = base + M + 2 * mmax, o_acc = base + M + 3 * mmax;

    for (int m = tid; m < M; m += kThreads) g[m] = gumbel(row[base + m]);
    __syncthreads();
    // Gumbel-top-k: mmax distinct locations
    for (int i = 0; i < mmax; ++i) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int m = tid; m < M; m += kThreads) arg_merge(&bv, &bi, g[m], m);
      const int loc = block_argmax(bv, bi, &s.red);
      if (tid == 0) {
        s.slot[i].loc = loc;
        g[loc] = -INFINITY;
      }
      __syncthreads();
    }

    if (tid == 0) s.hastings = 0.0f;
    for (int i = 0; i < mmax; ++i) {
      const int loc = s.slot[i].loc;
      const float* cnt = ev_col(k, loc);
      float nz = 0.0f, bv = -INFINITY;
      int bi = INT_MAX;
      for (int t = tid; t < T; t += kThreads) {
        const bool on = cnt[t] > 0.0f;
        nz += on ? 1.0f : 0.0f;
        const float gt = gumbel(tsel[t * a.LT + k * mmax + i]);
        arg_merge(&bv, &bi, on ? gt : -INFINITY, t);
      }
      const float n_nz = block_sum(nz, &s.red);
      const int t_src = block_argmax(bv, bi, &s.red);
      if (tid == 0) {
        Slot& sl = s.slot[i];
        const int left = min(a.dmax, t_src);
        const int right = min(a.dmax, T - 1 - t_src);
        int d;
        float lm_fwd, x, lm_x_fwd;
        two_sided_geometric(row[o_side + i], row[o_j + i], left, right, decay,
                            &d, &lm_fwd);
        const float cap_fwd = fminf(F(a.nmax), cnt[t_src]);
        truncated_geometric(row[o_x + i], cap_fwd, x_decay, &x, &lm_x_fwd);
        const bool active = (n_nz > 0.0f) && (left + right > 0);
        sl.t_src = t_src;
        sl.d = d;
        sl.x = active ? x : 0.0f;
        sl.t_dst = min(max(t_src + d, 0), T - 1);
        s.active = active;
        s.lm_fwd = lm_fwd;
        s.lm_x_fwd = lm_x_fwd;
        s.n_nz = n_nz;
      }
      __syncthreads();
      const Slot sl = s.slot[i];
      float nz_new = 0.0f;
      for (int t = tid; t < T; t += kThreads) {
        const float w_ev = (t == sl.t_dst ? sl.x : 0.0f) -
                           (t == sl.t_src ? sl.x : 0.0f);
        nz_new += (cnt[t] + w_ev > 0.0f) ? 1.0f : 0.0f;
      }
      const float n_nz_new = block_sum(nz_new, &s.red);
      if (tid == 0) {
        const float w_ev = sl.x - (sl.t_dst == sl.t_src ? sl.x : 0.0f);
        const float count_dst_new = cnt[sl.t_dst] + w_ev;
        const float cap_rev = fminf(F(a.nmax), count_dst_new);
        const int left_r = min(a.dmax, sl.t_dst);
        const int right_r = min(a.dmax, T - 1 - sl.t_dst);
        const float dec_c = clip_decay(decay);
        const float mass_rev =
            (1.0f - pow_k(dec_c, static_cast<float>(left_r))) +
            (1.0f - pow_k(dec_c, static_cast<float>(right_r)));
        const float lq =
            ((-logf(fmaxf(n_nz_new, 1.0f)) -
              log_mass_geometric(cap_rev, x_decay)) -
             logf(fmaxf(mass_rev, F(1e-30)))) -
            ((-logf(fmaxf(s.n_nz, 1.0f)) - s.lm_x_fwd) - s.lm_fwd);
        s.hastings = s.hastings + (s.active ? lq : 0.0f);
      }
      __syncthreads();
    }

    // --- likelihood delta, decision, apply --------------------------------
    if (tid == 0) s.delta = 0.0f;
    if (k == 0) {
      // distinct locations, no rate changes: per-location column deltas
      // from the pre-move planes
      for (int i = 0; i < mmax; ++i) {
        const Slot sl = s.slot[i];
        const int loc = sl.loc;
        const float x = sl.x;
        float p = 0.0f;
        for (int t = tid; t < T; t += kThreads) {
          const float w = (t > sl.t_dst ? 1.0f : 0.0f) -
                          (t > sl.t_src ? 1.0f : 0.0f);
          const float ev_d = (t == sl.t_dst ? x : 0.0f) -
                             (t == sl.t_src ? x : 0.0f);
          const float S = st_col(0, loc)[t], E = st_col(1, loc)[t];
          const float y0 = ev_col(0, loc)[t], y1 = ev_col(1, loc)[t];
          const float rate = rate_se(loc, t);
          const float lp_old = binom_lp_rate(S, y0, rate) + binom_lp_nu(E, y1);
          const float lp_new = binom_lp_rate(S - x * w, y0 + ev_d, rate) +
                               binom_lp_nu(E + x * w, y1);
          p += lp_new - lp_old;
        }
        const float col = block_sum(p, &s.red);
        if (tid == 0) s.delta = s.delta + col;
      }
      if (tid == 0) {
        s.log_alpha = s.delta + s.hastings;
        s.acc = log_u_accept(row[o_acc]) < s.log_alpha;
      }
      __syncthreads();
      if (s.acc) {
        for (int i = 0; i < mmax; ++i) {
          const Slot sl = s.slot[i];
          const float x = sl.x;
          for (int t = tid; t < T; t += kThreads) {
            const float w = (t > sl.t_dst ? 1.0f : 0.0f) -
                            (t > sl.t_src ? 1.0f : 0.0f);
            const float ev_d = (t == sl.t_dst ? x : 0.0f) -
                               (t == sl.t_src ? x : 0.0f);
            ev_col(0, sl.loc)[t] += ev_d;
            st_col(0, sl.loc)[t] += (-x) * w;
            st_col(1, sl.loc)[t] += x * w;
          }
        }
      }
    } else {
      // telescoped per-location evaluation with a tentative apply: the
      // next location's delta must see this location's change
      for (int i = 0; i < mmax; ++i) {
        const Slot sl = s.slot[i];
        const int loc = sl.loc;
        const float x = sl.x;
        float p = 0.0f;
        for (int t = tid; t < T; t += kThreads) {
          const float w = (t > sl.t_dst ? 1.0f : 0.0f) -
                          (t > sl.t_src ? 1.0f : 0.0f);
          const float ev_d = (t == sl.t_dst ? x : 0.0f) -
                             (t == sl.t_src ? x : 0.0f);
          const float E = st_col(1, loc)[t], I = st_col(2, loc)[t];
          const float y1 = ev_col(1, loc)[t], y2 = ev_col(2, loc)[t];
          const float lp_old = binom_lp_nu(E, y1) + binom_lp_rate(I, y2, rir[t]);
          const float lp_new = binom_lp_nu(E - x * w, y1 + ev_d) +
                               binom_lp_rate(I + x * w, y2, rir[t]);
          p += lp_new - lp_old;
        }
        const float col = block_sum(p, &s.red);
        const int lo = min(sl.t_src, sl.t_dst) + 1;
        const int hi = max(sl.t_src, sl.t_dst);
        const bool moves = x != 0.0f && lo <= hi;
        float plane = 0.0f;
        if (moves) plane = plane_delta(loc, x, sl.t_src, sl.t_dst, lo, hi);
        if (tid == 0) s.delta = (s.delta + col) + plane;
        // tentative apply (reads above are done: block_sum synchronised)
        for (int t = tid; t < T; t += kThreads) {
          const float w = (t > sl.t_dst ? 1.0f : 0.0f) -
                          (t > sl.t_src ? 1.0f : 0.0f);
          const float ev_d = (t == sl.t_dst ? x : 0.0f) -
                             (t == sl.t_src ? x : 0.0f);
          ev_col(1, loc)[t] += ev_d;
          st_col(1, loc)[t] += (-x) * w;
          st_col(2, loc)[t] += x * w;
        }
        if (moves) add_rank1(loc, x, sl.t_src, sl.t_dst, lo, hi);
        __syncthreads();
      }
      if (tid == 0) {
        s.log_alpha = s.delta + s.hastings;
        s.acc = log_u_accept(row[o_acc]) < s.log_alpha;
      }
      __syncthreads();
      if (!s.acc) {
        // revert by subtraction, in the reference's order
        for (int i = 0; i < mmax; ++i) {
          const Slot sl = s.slot[i];
          const float x = sl.x;
          for (int t = tid; t < T; t += kThreads) {
            const float w = (t > sl.t_dst ? 1.0f : 0.0f) -
                            (t > sl.t_src ? 1.0f : 0.0f);
            const float ev_d = (t == sl.t_dst ? x : 0.0f) -
                               (t == sl.t_src ? x : 0.0f);
            ev_col(1, sl.loc)[t] += -ev_d;
            st_col(1, sl.loc)[t] += x * w;
            st_col(2, sl.loc)[t] += (-x) * w;
          }
          const int lo = min(sl.t_src, sl.t_dst) + 1;
          const int hi = max(sl.t_src, sl.t_dst);
          if (x != 0.0f && lo <= hi)
            add_rank1(sl.loc, -x, sl.t_src, sl.t_dst, lo, hi);
          __syncthreads();
        }
      }
    }
    if (tid == 0) {
      s.lp = s.lp + (s.acc ? s.delta : 0.0f);
      float* r = tr + trace_row * (2 + 4 * mmax);
      r[0] = s.acc ? 1.0f : 0.0f;
      r[1] = s.lp;
      for (int i = 0; i < mmax; ++i) {
        r[2 + i] = static_cast<float>(s.slot[i].loc);
        r[2 + mmax + i] = static_cast<float>(s.slot[i].t_src);
        r[2 + 2 * mmax + i] = static_cast<float>(s.slot[i].d);
        r[2 + 3 * mmax + i] = s.slot[i].x;
      }
    }
    __syncthreads();
  }

  // -------------------------------------------------------------------------
  // One occult add/delete application; fused_sweep.py:_occult
  // -------------------------------------------------------------------------
  __device__ void occult(int k, const float* row, float x_decay,
                         int trace_row) {
    const int mmax = a.mmax;
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
      s.loc = loc;
      s.t = t;
      s.is_add = is_add;
      s.can_delete = can_delete;
      s.count = count;
      s.cap_del = cap_del;
      s.x_add = x_add;
      s.dx = is_add ? x : -x;
    }
    __syncthreads();
    const int t0 = s.t;
    const float dx = s.dx;
    float p = 0.0f;
    for (int t = tid; t < T; t += kThreads) {
      const float w = t > t0 ? 1.0f : 0.0f;
      const float ev_d = t == t0 ? dx : 0.0f;
      const float E = st_col(1, loc)[t];
      const float y1 = ev_col(1, loc)[t];
      if (k == 0) {
        const float S = st_col(0, loc)[t];
        const float y0 = ev_col(0, loc)[t];
        const float rate = rate_se(loc, t);
        p += ((binom_lp_rate(S - dx * w, y0 + ev_d, rate) +
               binom_lp_nu(E + dx * w, y1)) -
              binom_lp_rate(S, y0, rate)) -
             binom_lp_nu(E, y1);
      } else {
        const float I = st_col(2, loc)[t];
        const float y2 = ev_col(2, loc)[t];
        p += ((binom_lp_nu(E - dx * w, y1 + ev_d) +
               binom_lp_rate(I + dx * w, y2, rir[t])) -
              binom_lp_nu(E, y1)) -
             binom_lp_rate(I, y2, rir[t]);
      }
    }
    const float col = block_sum(p, &s.red);
    // rate-only cells: an occult at t0 perturbs I only at days > t0;
    // w(t) = (t > t0) - (t > T) is 1 there
    const bool perturbs = k == 1 && dx != 0.0f && t0 + 1 <= T - 1;
    float plane = 0.0f;
    if (perturbs) plane = plane_delta(loc, dx, T, t0, t0 + 1, T - 1);
    if (tid == 0) {
      s.delta = col + plane;
      const float log_h_add =
          log_mass_geometric(onmax, x_decay) -
          log_mass_geometric(fminf(onmax, s.count + s.x_add), x_decay);
      const float log_h_del = log_mass_geometric(s.cap_del, x_decay) -
                              log_mass_geometric(onmax, x_decay);
      const float hastings = s.is_add ? log_h_add : log_h_del;
      const bool is_null = !s.is_add && !s.can_delete;
      s.log_alpha = s.delta + hastings;
      s.acc = !is_null && (log_u_accept(row[o_acc]) < s.log_alpha);
      s.lp = s.lp + (s.acc ? s.delta : 0.0f);
      float* r = tr + trace_row * (2 + 4 * mmax);
      r[0] = s.acc ? 1.0f : 0.0f;
      r[1] = s.lp;
      r[2] = static_cast<float>(loc);
      r[3] = static_cast<float>(t0);
      r[4] = s.is_add ? 1.0f : -1.0f;
      r[5] = fabsf(dx);
    }
    __syncthreads();
    if (s.acc) {
      for (int t = tid; t < T; t += kThreads) {
        const float w = t > t0 ? 1.0f : 0.0f;
        if (t == t0) ev_col(k, loc)[t] += dx;
        st_col(k, loc)[t] += (-dx) * w;
        st_col(k + 1, loc)[t] += dx * w;
      }
      if (perturbs) add_rank1(loc, dx, T, t0, t0 + 1, T - 1);
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kThreads)
    fused_sweep_kernel(const __grid_constant__ Args a) {
  extern __shared__ float dyn[];
  __shared__ Shared s;
  const int c = blockIdx.x, tid = threadIdx.x;
  const int M = a.M, T = a.T, MT = M * T;
  const size_t c3 = static_cast<size_t>(c) * 3 * MT;
  const size_t c4 = static_cast<size_t>(c) * 4 * MT;
  const size_t c1 = static_cast<size_t>(c) * MT;
  const int tw = 2 + 4 * a.mmax;
  Chain ch{a, s, dyn, dyn + M, M, T, MT,
           a.ev + c3, a.st + c4, a.cm + c1, a.trace + static_cast<size_t>(c) * 4 * tw,
           a.eta + c1, a.pw + static_cast<size_t>(c) * T,
           a.rir + static_cast<size_t>(c) * T, a.dec + static_cast<size_t>(c) * 5,
           tid};

  // copy-in; the sweep then updates the outputs in place
  for (int i = tid; i < 3 * MT; i += kThreads) ch.ev[i] = a.ev_in[c3 + i];
  for (int i = tid; i < 4 * MT; i += kThreads) ch.st[i] = a.st_in[c4 + i];
  for (int i = tid; i < MT; i += kThreads) ch.cm[i] = a.cm_in[c1 + i];
  for (int i = tid; i < 4 * tw; i += kThreads) ch.tr[i] = 0.0f;
  if (tid == 0) s.lp = a.lp_in[c];
  __syncthreads();

  if (a.guided) {
    // case_guide_logits: observed I->R cases over the occult window with a
    // uniform floor; events[..., 2] is never modified by the sweep
    float part = 0.0f;
    for (int m = tid; m < M; m += kThreads) {
      const float* y2 = ch.ev_col(2, m);
      float cw = 0.0f;
      for (int t = a.t_lo; t < a.t_hi; ++t) cw += y2[t];
      ch.guide[m] = cw;
      part += cw;
    }
    const float total = block_sum(part, &s.red);
    for (int m = tid; m < M; m += kThreads) {
      const float w =
          total > 0.0f ? (a.one_minus_gf * ch.guide[m]) / fmaxf(total, 1.0f)
                       : 0.0f;
      ch.guide[m] = logf(w + a.gf_over_m);
    }
    __syncthreads();
  }

  const float* dec = ch.dec;  // [move_se, move_ei, x_se, x_ei, x_occult]
  for (int u = 0; u < a.U; ++u) {
    const size_t cu = static_cast<size_t>(c) * a.U + u;
    const float* row = a.tbl + cu * a.W;
    const float* tsel = a.ttbl + cu * T * a.LT;
    ch.move(0, row, tsel, dec[0], dec[2], 0);
    ch.move(1, row, tsel, dec[1], dec[3], 1);
    ch.occult(0, row, dec[4], 2);
    ch.occult(1, row, dec[4], 3);
  }
  if (tid == 0) a.lp_out[c] = s.lp;
}

}  // namespace

extern "C" int fused_sweep_launch(
    const float* tbl, const float* ttbl, const float* ev_in,
    const float* st_in, const float* cm_in, const float* lp_in,
    const float* eta, const float* pw, const float* rir, const float* N,
    const float* cs, const float* dec, float* ev, float* st, float* cm,
    float* lp_out, float* trace, int C, int M, int T, int U, int W, int LT,
    int mmax, int nmax, int dmax, int onmax, int t_lo, int t_hi, int guided,
    float one_minus_gf, float gf_over_m, void* stream) {
  if (mmax < 1 || mmax > kMmaxLimit) return static_cast<int>(cudaErrorInvalidValue);
  Args a{tbl, ttbl, ev_in, st_in, cm_in, lp_in, eta, pw, rir, N, cs, dec,
         ev, st, cm, lp_out, trace, C, M, T, U, W, LT, mmax, nmax, dmax,
         onmax, t_lo, t_hi, guided, one_minus_gf, gf_over_m};
  const size_t shmem = 2 * static_cast<size_t>(M) * sizeof(float);
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
