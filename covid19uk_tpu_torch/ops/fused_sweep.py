"""The fused event sweep: wrapper, launch counter and plain PyTorch version.

Port of ``covid19uk_tpu/ops/pallas/fused_sweep.py:fused_sweep``.  One call
runs U multiscans of four Metropolis-Hastings applications on every chain
(move S->E, move E->I, occult S->E, occult E->I), with the proposals,
Hastings corrections and accept rules of the JAX kernel.  Randomness is an
input: a ``[C, U, W]`` table of scalar uniforms and a ``[C, U, T, L]``
table of per-day uniforms (``L >= 2 * mmax``; the JAX kernel draws
``L = 128`` and reads the first ``2 * mmax`` lanes).

:func:`fused_sweep` launches the CUDA kernel ``csrc/fused_sweep.cu`` for
tensors on a CUDA device and runs :func:`fused_sweep_reference`, the plain
version of the same function, for tensors on the CPU.  The plain version
writes the kernel's numerics with the same formulas and the same order of
float32 operations, so that the two agree to rounding of the sums and
make the same decisions.  The kernel reads the caller's events and state
as they lie (``[C, M, T, X]``, or the plane-major view this wrapper
returns) and writes fresh outputs; the caller's tensors are not written.

Quirks kept from the JAX kernel: every input is cast to float32, even for
float64 chains; a rejected E->I move is reverted by subtracting the
tentative update, which leaves ulp-level drift in the commute plane.
Changed: ``num_updates < 1`` raises (the JAX kernel returns logp 0.0), and
so does ``M < mmax`` (fewer locations than a move's distinct slots).
"""

import math
from typing import NamedTuple

import torch

from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import RATE_EPS
from covid19uk_tpu_torch.utils import nans

NU = float(seir.NU)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_LOG_P_NU = math.log(-math.expm1(-NU))
# The kernel keeps per-slot proposal scalars in fixed arrays.
MMAX_LIMIT = 8
# Columns of the trace: [accepted, logp_after, m*, t*, d*, x*].
_F32 = torch.float32


def trace_width(mmax):
    return 2 + 4 * mmax


# ---------------------------------------------------------------------------
# In-kernel numerics (the JAX kernel's Stirling/Taylor forms; the CUDA
# kernel's __device__ functions are the same formulas in the same order).
# ---------------------------------------------------------------------------


def _div(x, c):
    """``x / c`` as an IEEE division.  A plain ``x / c`` with a Python
    scalar runs as ``x * (1/c)`` on CUDA tensors, which rounds differently
    from the kernel's division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _log1p(x):
    """log1p without the primitive: exact form above 1e-3, Taylor below."""
    big = torch.log(1.0 + torch.clamp(x, min=1e-3))
    small = x * (1.0 - x * (0.5 - _div(x, 3.0)))
    return torch.where(x > 1e-3, big, small)


def _stirling(z):
    """3-term Stirling series, valid to ~3e-6 for z >= 3."""
    inv = 1.0 / z
    return (
        (z - 0.5) * torch.log(z)
        - z
        + _HALF_LOG_2PI
        + inv * (1.0 / 12.0 - inv * inv * (1.0 / 360.0))
    )


def lgamma_diff(n, k):
    """``lgamma(n+1) - lgamma(n-k+1)`` (0 <= k <= n), shift-by-2 Stirling."""
    b = n - k + 1.0
    a_s = n + 3.0
    b_s = b + 2.0
    s_diff = (
        (a_s - 0.5) * _log1p(k / b_s)
        + k * torch.log(b_s)
        - k
        + (1.0 / 12.0) * (1.0 / a_s - 1.0 / b_s)
        - (1.0 / 360.0) * (1.0 / (a_s * a_s * a_s) - 1.0 / (b_s * b_s * b_s))
    )
    return s_diff - _log1p(k / b) - _log1p(k / (b + 1.0))


def lgamma1p(k):
    """``lgamma(k+1)`` via shift-by-4 Stirling; valid for k >= 0."""
    z = k + 1.0
    return (
        _stirling(z + 4.0)
        - torch.log(z)
        - torch.log(z + 1.0)
        - torch.log(z + 2.0)
        - torch.log(z + 3.0)
    )


def log_pm(r):
    """``log(1 - exp(-r))`` for r > 0, stable at both ends."""
    r_safe = torch.clamp(r, min=1e-30)
    em = torch.exp(-r_safe)
    mid = torch.log(torch.clamp(1.0 - em, min=1e-30))
    small = torch.log(r_safe) + torch.log(
        1.0 - r_safe * (0.5 - r_safe * (1.0 / 6.0 - _div(r_safe, 24.0)))
    )
    large = -em * (1.0 + em * (0.5 + _div(em, 3.0)))
    return torch.where(r > 5.0, large, torch.where(r > 1e-2, mid, small))


def _valid(n, y):
    return (y >= 0.0) & (y <= n) & (n >= 0.0)


def binom_lp_rate(n, y, r):
    """Binomial log-pmf with p = 1 - exp(-r); -inf where invalid."""
    valid = _valid(n, y)
    n_ = torch.where(valid, n, 1.0)
    y_ = torch.where(valid, y, 0.0)
    r_ = torch.clamp(r, min=1e-30)
    lp = lgamma_diff(n_, y_) - lgamma1p(y_) + y_ * log_pm(r_) - (n_ - y_) * r_
    return torch.where(valid, lp, -torch.inf)


def binom_lp_nu(n, y):
    """Binomial log-pmf at the constant E->I rate NU."""
    valid = _valid(n, y)
    n_ = torch.where(valid, n, 1.0)
    y_ = torch.where(valid, y, 0.0)
    lp = lgamma_diff(n_, y_) - lgamma1p(y_) + y_ * _LOG_P_NU - (n_ - y_) * NU
    return torch.where(valid, lp, -torch.inf)


def rate_diff(n, k, r_old, r_new):
    """Log-pmf delta when only the rate changed (the lgammas cancel)."""
    return k * (log_pm(r_new) - log_pm(r_old)) - (n - k) * (r_new - r_old)


# ---------------------------------------------------------------------------
# Proposal samplers: per-chain [C] scalars, uniforms in [0, 1) as input.
# ---------------------------------------------------------------------------


def _clip_decay(decay):
    return torch.clamp(decay, 1e-3, 1.0 - 1e-6)


def _powf(base, expo):
    return torch.exp(expo * torch.log(base))


def _two_sided_geometric(u_side, u_j, left, right, decay):
    """d ~ decay^(|d|-1) on {-left..-1} u {1..right}; (d, log_mass)."""
    decay = _clip_decay(decay)
    left_f = left.to(_F32)
    right_f = right.to(_F32)
    mass_l = 1.0 - _powf(decay, left_f)
    mass_r = 1.0 - _powf(decay, right_f)
    total = torch.clamp(mass_l + mass_r, min=1e-30)
    go_right = u_side < mass_r / total
    side_len = torch.where(go_right, right_f, left_f)
    side_mass = 1.0 - _powf(decay, side_len)
    j = torch.ceil(
        torch.log(torch.clamp(1.0 - u_j * side_mass, min=1e-30))
        / torch.log(decay)
    )
    j = torch.minimum(torch.clamp(j, min=1.0), torch.clamp(side_len, min=1.0))
    d = torch.where(go_right, j, -j).to(torch.int64)
    return d, torch.log(total)


def _truncated_geometric(u, cap, decay):
    """x ~ decay^(x-1) on {1..cap}; (x, log_mass)."""
    decay = _clip_decay(decay)
    cap_f = torch.clamp(cap, min=1.0)
    mass = 1.0 - _powf(decay, cap_f)
    x = torch.ceil(
        torch.log(torch.clamp(1.0 - u * mass, min=1e-30)) / torch.log(decay)
    )
    x = torch.minimum(torch.clamp(x, min=1.0), cap_f)
    return x, torch.log(torch.clamp(mass, min=1e-30))


def _log_mass_geometric(cap, decay):
    decay = _clip_decay(decay)
    cap_f = torch.clamp(cap, min=1.0)
    return torch.log(torch.clamp(1.0 - _powf(decay, cap_f), min=1e-30))


def _gumbel(u):
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Uniform-table layout (the JAX kernel's _Offsets).
# ---------------------------------------------------------------------------


class Offsets:
    """Column offsets of one multiscan's scalar uniforms in the table."""

    def __init__(self, M, mmax):
        move_w = M + 3 * mmax + 1  # loc gumbels, side/j/x per slot, acc
        occ_w = M + 4  # loc gumbels, t, dir, x, acc
        self.move = [
            dict(loc=b, side=b + M, j=b + M + mmax, x=b + M + 2 * mmax,
                 acc=b + M + 3 * mmax)
            for b in (0, move_w)
        ]
        self.occ = [
            dict(loc=b, t=b + M, dir=b + M + 1, x=b + M + 2, acc=b + M + 3)
            for b in (2 * move_w, 2 * move_w + occ_w)
        ]
        # rounded up to a 128-lane tile, as the JAX kernel draws it
        self.width = -(-(2 * move_w + 2 * occ_w) // 128) * 128


class SweepConfig(NamedTuple):
    """Static knobs of one sweep (the JAX kernel's static arguments)."""

    mmax: int
    nmax: int
    dmax: int
    occult_nmax: int
    t_range: tuple
    num_updates: int
    occult_guided: bool
    guide_floor: float = 0.1


def draw_tables(generator, num_chains, M, T, cfg: SweepConfig, device):
    """Uniform tables for one sweep of every chain: ``[C, U, W]`` scalars
    and ``[C, U, T, 2 * mmax]`` per-day uniforms, on ``device``."""
    U = cfg.num_updates
    tbl = torch.rand((num_chains, U, Offsets(M, cfg.mmax).width),
                     generator=generator, device=device)
    ttbl = torch.rand((num_chains, U, T, 2 * cfg.mmax), generator=generator,
                      device=device)
    return tbl, ttbl


# ---------------------------------------------------------------------------
# The plain version, batched over chains.
# ---------------------------------------------------------------------------


class _Planes:
    """One sweep's float32 working set in the kernel's location-major
    layout: events ``[C, 3, M, T]``, state ``[C, 4, M, T]``, commute,
    exp_eta ``[C, M, T]``."""

    def __init__(self, events, state, commute, exp_eta, psi_w, rate_ir_t,
                 N, Cstar):
        # copies: the sweep updates them in place
        fmt = torch.contiguous_format
        self.ev = events.to(_F32).permute(0, 3, 1, 2).clone(memory_format=fmt)
        self.st = state.to(_F32).permute(0, 3, 1, 2).clone(memory_format=fmt)
        self.cm = commute.to(_F32).clone()
        self.eta = exp_eta.to(_F32)
        self.pw = psi_w.to(_F32)
        self.rir = rate_ir_t.to(_F32)
        self.N = N.to(_F32)
        self.cs = Cstar.to(_F32)
        C, _, M, T = self.ev.shape
        self.ar = torch.arange(C, device=self.ev.device)
        self.sub_t = torch.arange(T, device=self.ev.device)
        self.lane = torch.arange(M, device=self.ev.device)

    def col(self, plane, k, loc):
        return plane[self.ar, k, loc]

    def add_col(self, plane, k, loc, delta):
        plane[self.ar, k, loc] = plane[self.ar, k, loc] + delta

    def rate_se_col(self, loc, i_col, cm_col):
        eta_col = self.eta[self.ar, loc]
        return (
            eta_col * (i_col + self.pw * cm_col) / self.N[loc][:, None]
            + RATE_EPS
        )

    def rank1(self, loc, x, w):
        """``(x / N[loc]) * w * Cstar[loc, :]`` as ``[C, M, T']``."""
        xn = (x / self.N[loc])[:, None] * w
        return xn[:, None, :] * self.cs[loc][:, :, None]

    def plane_delta(self, loc, x, w, t0=0):
        """Sum over locations and days ``t >= t0`` of the S->E log-pmf
        change when I at ``loc`` moves by ``x * w`` (``w`` is ``[C, T-t0]``)
        and the commute plane by the matching rank-1 term: the rates
        change, n and k do not.  Cells with w == 0 add exactly 0."""
        sl = slice(t0, None)
        S_c = self.st[:, 0, :, sl]
        y0_c = self.ev[:, 0, :, sl]
        I_c = self.st[:, 2, :, sl]
        cm_c = self.cm[:, :, sl]
        pw_c = self.pw[:, None, sl]
        pref = self.eta[:, :, sl] / self.N[None, :, None]
        mask = (self.lane == loc[:, None]).to(_F32)[:, :, None]
        dI = (x[:, None] * w)[:, None, :] * mask
        dcm = self.rank1(loc, x, w)
        r_old = pref * (I_c + pw_c * cm_c) + RATE_EPS
        r_new = pref * (I_c + dI + pw_c * (cm_c + dcm)) + RATE_EPS
        return torch.sum(rate_diff(S_c, y0_c, r_old, r_new), dim=(1, 2))


def _move(P, k, row, tsel, lp, decay, x_decay, cfg, offs, record):
    """One move application (k = 0: S->E, k = 1: E->I) on every chain."""
    o = offs.move[k]
    M, T = P.lane.shape[0], P.sub_t.shape[0]
    mmax, sub_t = cfg.mmax, P.sub_t
    g = _gumbel(row[:, o["loc"]:o["loc"] + M])
    locs = []
    for _ in range(mmax):
        loc = torch.argmax(g, dim=1)
        locs.append(loc)
        g = torch.where(P.lane == loc[:, None], -torch.inf, g)

    t_srcs, t_dsts, ds_, xs = [], [], [], []
    hastings = torch.zeros_like(lp)
    for i in range(mmax):
        loc = locs[i]
        cnt = P.col(P.ev, k, loc)  # [C, T]
        mask = cnt > 0
        n_nz = mask.sum(dim=1)
        gt = _gumbel(tsel[:, :, k * mmax + i])
        t_src = torch.argmax(torch.where(mask, gt, -torch.inf), dim=1)
        left = torch.clamp(t_src, max=cfg.dmax)
        right = torch.clamp(T - 1 - t_src, max=cfg.dmax)
        d, lm_fwd = _two_sided_geometric(
            row[:, o["side"] + i], row[:, o["j"] + i], left, right, decay
        )
        count_src = cnt.gather(1, t_src[:, None])[:, 0]
        cap_fwd = torch.clamp(count_src, max=float(cfg.nmax))
        x, lm_x_fwd = _truncated_geometric(row[:, o["x"] + i], cap_fwd,
                                           x_decay)
        active = (n_nz > 0) & (left + right > 0)
        x_eff = torch.where(active, x, 0.0)
        t_dst = torch.clamp(t_src + d, 0, T - 1)

        # reverse-side masses from the locally updated count column
        w_ev = (
            torch.where(sub_t == t_dst[:, None], x_eff[:, None], 0.0)
            - torch.where(sub_t == t_src[:, None], x_eff[:, None], 0.0)
        )
        cnt_new = cnt + w_ev
        n_nz_new = (cnt_new > 0).sum(dim=1)
        count_dst_new = cnt_new.gather(1, t_dst[:, None])[:, 0]
        cap_rev = torch.clamp(count_dst_new, max=float(cfg.nmax))
        left_r = torch.clamp(t_dst, max=cfg.dmax)
        right_r = torch.clamp(T - 1 - t_dst, max=cfg.dmax)
        dec_c = _clip_decay(decay)
        mass_rev = (1.0 - _powf(dec_c, left_r.to(_F32))) + (
            1.0 - _powf(dec_c, right_r.to(_F32))
        )
        lq = (
            -torch.log(torch.clamp(n_nz_new, min=1).to(_F32))
            - _log_mass_geometric(cap_rev, x_decay)
            - torch.log(torch.clamp(mass_rev, min=1e-30))
        ) - (
            -torch.log(torch.clamp(n_nz, min=1).to(_F32))
            - lm_x_fwd
            - lm_fwd
        )
        hastings = hastings + torch.where(active, lq, 0.0)
        t_srcs.append(t_src)
        t_dsts.append(t_dst)
        ds_.append(d)
        xs.append(x_eff)

    def window(i):
        ts, td = t_srcs[i][:, None], t_dsts[i][:, None]
        x = xs[i]
        w = (sub_t > td).to(_F32) - (sub_t > ts).to(_F32)
        ev_d = (
            torch.where(sub_t == td, x[:, None], 0.0)
            - torch.where(sub_t == ts, x[:, None], 0.0)
        )
        return locs[i], x, w, ev_d

    delta = torch.zeros_like(lp)
    u_acc = torch.log(torch.clamp(row[:, o["acc"]], 1e-38, 1.0))
    if k == 0:
        # locations are distinct and no rate changes: per-location deltas
        # from the pre-move planes
        for i in range(mmax):
            loc, x, w, ev_d = window(i)
            xc = x[:, None]
            s_row = P.col(P.st, 0, loc)
            e_row = P.col(P.st, 1, loc)
            ev0 = P.col(P.ev, 0, loc)
            ev1 = P.col(P.ev, 1, loc)
            i_row = P.col(P.st, 2, loc)
            rate = P.rate_se_col(loc, i_row, P.cm[P.ar, loc])
            lp_old = binom_lp_rate(s_row, ev0, rate) + binom_lp_nu(e_row, ev1)
            lp_new = binom_lp_rate(
                s_row - xc * w, ev0 + ev_d, rate
            ) + binom_lp_nu(e_row + xc * w, ev1)
            delta = delta + torch.sum(lp_new - lp_old, dim=1)
        log_alpha = delta + hastings
        acc = u_acc < log_alpha
        for i in range(mmax):
            loc, x, w, _ = window(i)
            x = torch.where(acc, x, 0.0)
            xc = x[:, None]
            ev_d = (
                torch.where(sub_t == t_dsts[i][:, None], xc, 0.0)
                - torch.where(sub_t == t_srcs[i][:, None], xc, 0.0)
            )
            P.add_col(P.ev, 0, loc, ev_d)
            P.add_col(P.st, 0, loc, -xc * w)
            P.add_col(P.st, 1, loc, xc * w)
    else:
        # telescoped per-location evaluation with a tentative apply; the
        # rate-only cells run over all locations
        for i in range(mmax):
            loc, x, w, ev_d = window(i)
            xc = x[:, None]
            e_row = P.col(P.st, 1, loc)
            i_row = P.col(P.st, 2, loc)
            ev1 = P.col(P.ev, 1, loc)
            ev2 = P.col(P.ev, 2, loc)
            lp_old = binom_lp_nu(e_row, ev1) + binom_lp_rate(i_row, ev2, P.rir)
            lp_new = binom_lp_nu(e_row - xc * w, ev1 + ev_d) + binom_lp_rate(
                i_row + xc * w, ev2, P.rir
            )
            delta = delta + torch.sum(lp_new - lp_old, dim=1)
            delta = delta + P.plane_delta(loc, x, w)
            P.add_col(P.ev, 1, loc, ev_d)
            P.add_col(P.st, 1, loc, -xc * w)
            P.add_col(P.st, 2, loc, xc * w)
            P.cm += P.rank1(loc, x, w)
        log_alpha = delta + hastings
        acc = u_acc < log_alpha
        # revert on reject, by subtraction (the reference's order)
        for i in range(mmax):
            loc, x, w, ev_d = window(i)
            rej = torch.logical_not(acc)
            x = torch.where(rej, x, 0.0)
            xc = x[:, None]
            ev_d = torch.where(rej[:, None], ev_d, 0.0)
            P.add_col(P.ev, 1, loc, -ev_d)
            P.add_col(P.st, 1, loc, xc * w)
            P.add_col(P.st, 2, loc, -xc * w)
            P.cm += P.rank1(loc, -x, w)
    lp = lp + torch.where(acc, delta, 0.0)
    if record is not None:
        rows = sum((t_dsts[i] - t_srcs[i]).abs() for i in range(mmax))
        rows = rows * int(k == 1)
        record.append(dict(log_alpha=log_alpha, log_u=u_acc, rows=rows))
    vals = (
        [acc.to(_F32), lp]
        + [v.to(_F32) for v in locs + t_srcs + ds_]
        + xs
    )
    return lp, torch.stack(vals, dim=1)


def _occult(P, k, row, lp, x_decay, guide, cfg, offs, record):
    """One occult add/delete application on every chain."""
    o = offs.occ[k]
    M, T = P.lane.shape[0], P.sub_t.shape[0]
    t_lo, t_hi = cfg.t_range
    onmax_f = float(cfg.occult_nmax)
    sub_t = P.sub_t
    g = _gumbel(row[:, o["loc"]:o["loc"] + M])
    if guide is not None:
        g = g + guide
    loc = torch.argmax(g, dim=1)
    t = t_lo + torch.floor(row[:, o["t"]] * float(t_hi - t_lo)).to(torch.int64)
    t = torch.clamp(t, t_lo, t_hi - 1)
    is_add = row[:, o["dir"]] < 0.5

    cnt = P.col(P.ev, k, loc)
    count = cnt.gather(1, t[:, None])[:, 0]
    cap_del = torch.clamp(count, max=onmax_f)
    u_x = row[:, o["x"]]
    x_add, _ = _truncated_geometric(u_x, torch.full_like(u_x, onmax_f),
                                    x_decay)
    x_del, _ = _truncated_geometric(u_x, cap_del, x_decay)
    can_delete = count > 0
    x = torch.where(is_add, x_add, torch.where(can_delete, x_del, 0.0))
    dx = torch.where(is_add, x, -x)
    dxc = dx[:, None]

    w = (sub_t > t[:, None]).to(_F32)
    ev_d = torch.where(sub_t == t[:, None], dxc, 0.0)
    if k == 0:
        s_row = P.col(P.st, 0, loc)
        e_row = P.col(P.st, 1, loc)
        ev0 = P.col(P.ev, 0, loc)
        ev1 = P.col(P.ev, 1, loc)
        i_row = P.col(P.st, 2, loc)
        rate = P.rate_se_col(loc, i_row, P.cm[P.ar, loc])
        delta = torch.sum(
            binom_lp_rate(s_row - dxc * w, ev0 + ev_d, rate)
            + binom_lp_nu(e_row + dxc * w, ev1)
            - binom_lp_rate(s_row, ev0, rate)
            - binom_lp_nu(e_row, ev1),
            dim=1,
        )
    else:
        e_row = P.col(P.st, 1, loc)
        i_row = P.col(P.st, 2, loc)
        ev1 = P.col(P.ev, 1, loc)
        ev2 = P.col(P.ev, 2, loc)
        delta = torch.sum(
            binom_lp_nu(e_row - dxc * w, ev1 + ev_d)
            + binom_lp_rate(i_row + dxc * w, ev2, P.rir)
            - binom_lp_nu(e_row, ev1)
            - binom_lp_rate(i_row, ev2, P.rir),
            dim=1,
        )
        # rate-only cells over [t_lo, T): an occult at t >= t_lo perturbs
        # only t' > t
        delta = delta + P.plane_delta(loc, dx, w[:, t_lo:], t0=t_lo)

    # Hastings (x caps only; location, day and direction cancel)
    onmax = torch.full_like(u_x, onmax_f)
    log_h_add = _log_mass_geometric(onmax, x_decay) - _log_mass_geometric(
        torch.clamp(count + x_add, max=onmax_f), x_decay
    )
    log_h_del = _log_mass_geometric(cap_del, x_decay) - _log_mass_geometric(
        onmax, x_decay
    )
    hastings = torch.where(is_add, log_h_add, log_h_del)
    is_null = torch.logical_not(is_add) & torch.logical_not(can_delete)
    log_alpha = delta + hastings
    u_acc = torch.log(torch.clamp(row[:, o["acc"]], 1e-38, 1.0))
    acc = torch.logical_not(is_null) & (u_acc < log_alpha)
    x_ap = torch.where(acc, dx, 0.0)
    xc = x_ap[:, None]
    P.add_col(P.ev, k, loc, torch.where(sub_t == t[:, None], xc, 0.0))
    P.add_col(P.st, k, loc, -xc * w)
    P.add_col(P.st, k + 1, loc, xc * w)
    if k == 1:
        P.cm += P.rank1(loc, x_ap, w)
    lp = lp + torch.where(acc, delta, 0.0)
    if record is not None:
        rows = (T - 1 - t) * int(k == 1)
        record.append(dict(log_alpha=log_alpha, log_u=u_acc, rows=rows))
    vals = [
        acc.to(_F32), lp, loc.to(_F32), t.to(_F32),
        torch.where(is_add, 1.0, -1.0), torch.abs(dx),
    ]
    return lp, torch.stack(vals, dim=1)


def fused_sweep_reference(tbl, ttbl, events, state, commute, logp, exp_eta,
                          psi_w, rate_ir_t, N, Cstar, decays,
                          cfg: SweepConfig, record=None):
    """The plain PyTorch version of the fused sweep (see the module doc).

    ``record``, when a list, receives one dict per application (in order:
    U x [move S->E, move E->I, occult S->E, occult E->I]) with the
    per-chain ``log_alpha``, ``log_u`` and the number of plane days the
    rate-only delta touched (``rows``)."""
    C, M, T, _ = events.shape
    offs = Offsets(M, cfg.mmax)
    P = _Planes(events, state, commute, exp_eta, psi_w, rate_ir_t, N, Cstar)
    dec = decays.to(_F32)
    lp = logp.to(_F32)
    t_lo, t_hi = cfg.t_range
    if cfg.occult_guided:
        # case_guide_logits: observed I->R cases over the occult window
        # with a uniform floor; no kernel modifies events[..., 2]
        cases_w = torch.sum(P.ev[:, 2, :, t_lo:t_hi], dim=2)
        total = torch.sum(cases_w, dim=1, keepdim=True)
        gf = float(cfg.guide_floor)
        guide = torch.log(
            torch.where(
                total > 0,
                (1.0 - gf) * cases_w / torch.clamp(total, min=1.0),
                0.0,
            )
            + gf / M
        )
    else:
        guide = None
    trace = torch.zeros((C, 4, trace_width(cfg.mmax)), dtype=_F32,
                        device=events.device)
    for u in range(cfg.num_updates):
        row = tbl[:, u].to(_F32)
        tsel = ttbl[:, u].to(_F32)
        lp, r0 = _move(P, 0, row, tsel, lp, dec[:, 0], dec[:, 2], cfg, offs,
                       record)
        lp, r1 = _move(P, 1, row, tsel, lp, dec[:, 1], dec[:, 3], cfg, offs,
                       record)
        lp, r2 = _occult(P, 0, row, lp, dec[:, 4], guide, cfg, offs, record)
        lp, r3 = _occult(P, 1, row, lp, dec[:, 4], guide, cfg, offs, record)
        trace[:, 0] = r0
        trace[:, 1] = r1
        trace[:, 2, :6] = r2
        trace[:, 3, :6] = r3
    return (
        P.ev.permute(0, 2, 3, 1).to(events.dtype),
        P.st.permute(0, 2, 3, 1).to(state.dtype),
        P.cm.to(commute.dtype),
        lp.to(logp.dtype),
        trace,
    )


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _check(tbl, ttbl, events, state, commute, logp, exp_eta, psi_w,
           rate_ir_t, N, Cstar, decays, cfg):
    if cfg.num_updates < 1:
        raise ValueError(f"num_updates must be >= 1, got {cfg.num_updates}")
    if not 1 <= cfg.mmax <= MMAX_LIMIT:
        raise ValueError(f"mmax must be in [1, {MMAX_LIMIT}], got {cfg.mmax}")
    if events.dim() != 4 or events.shape[-1] != 3:
        raise ValueError(f"events must be [C, M, T, 3], got {events.shape}")
    C, M, T, _ = events.shape
    if M < cfg.mmax:
        raise ValueError(f"mmax={cfg.mmax} distinct locations need M >= "
                         f"mmax, got M={M}")
    t_lo, t_hi = cfg.t_range
    if not 0 <= t_lo < t_hi <= T:
        raise ValueError(f"t_range={cfg.t_range} must satisfy "
                         f"0 <= lo < hi <= T={T}")
    U = cfg.num_updates
    want = dict(
        state=(state, (C, M, T, 4)), commute=(commute, (C, M, T)),
        logp=(logp, (C,)), exp_eta=(exp_eta, (C, M, T)),
        psi_w=(psi_w, (C, T)), rate_ir_t=(rate_ir_t, (C, T)), N=(N, (M,)),
        Cstar=(Cstar, (M, M)), decays=(decays, (C, 5)),
    )
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    width = Offsets(M, cfg.mmax).width
    if tbl.dim() != 3 or tuple(tbl.shape[:2]) != (C, U) or tbl.shape[2] < width:
        raise ValueError(f"tbl must be [{C}, {U}, >={width}], "
                         f"got {tuple(tbl.shape)}")
    if (ttbl.dim() != 4 or tuple(ttbl.shape[:3]) != (C, U, T)
            or ttbl.shape[3] < 2 * cfg.mmax):
        raise ValueError(f"ttbl must be [{C}, {U}, {T}, >={2 * cfg.mmax}], "
                         f"got {tuple(ttbl.shape)}")
    tensors = (tbl, ttbl, events, state, commute, logp, exp_eta, psi_w,
               rate_ir_t, N, Cstar, decays)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def fused_sweep(tbl, ttbl, events, state, commute, logp, exp_eta, psi_w,
                rate_ir_t, N, Cstar, decays, cfg: SweepConfig):
    """Runs U multiscans of the four event kernels on every chain.

    Args:
      tbl, ttbl: uniform tables (:func:`draw_tables`).
      events ``[C, M, T, 3]``, state ``[C, M, T, 4]``, commute
      ``[C, M, T]``, logp ``[C]``: the chains' current values.
      exp_eta ``[C, M, T]``, psi_w ``[C, T]``, rate_ir_t ``[C, T]``,
      N ``[M]``, Cstar ``[M, M]``: the LikelihoodContext.
      decays ``[C, 5]``: move decay S->E and E->I, event-count decay of the
        two moves, and of the occults.
      cfg: static knobs.

    Returns:
      ``(events, state, commute, logp, trace)`` with ``trace`` the
      ``[C, 4, 2 + 4 mmax]`` float32 rows (move S->E, move E->I, occult
      S->E, occult E->I) of the last multiscan, columns
      ``[accepted, logp_after, m*, t*, d*, x*]``.

    Tensors on the CPU run the plain version; tensors on a CUDA device run
    the CUDA kernel (counted in ``fused_sweep.launches``); any other
    device raises.  Inside a :class:`~covid19uk_tpu_torch.utils.nans.NanCheck`
    the outputs are checked for NaN (the mode does not see the kernel's).
    """
    _check(tbl, ttbl, events, state, commute, logp, exp_eta, psi_w,
           rate_ir_t, N, Cstar, decays, cfg)
    if events.device.type == "cpu":
        outs = fused_sweep_reference(tbl, ttbl, events, state, commute, logp,
                                     exp_eta, psi_w, rate_ir_t, N, Cstar,
                                     decays, cfg)
    elif events.device.type == "cuda":
        outs = _launch(tbl, ttbl, events, state, commute, logp, exp_eta,
                       psi_w, rate_ir_t, N, Cstar, decays, cfg)
    else:
        raise ValueError(f"no fused_sweep for device {events.device}")
    nans.check("fused_sweep", outs)
    return outs


fused_sweep.launches = 0


def _kernel_layout(t):
    """``(tensor, cell_major)``: the caller's float32 ``[C, M, T, X]``
    tensor as the kernel reads it, without a copy when it is contiguous
    (cell-major) or a permuted view of a contiguous ``[C, X, M, T]``
    (plane-major, as this wrapper returns its outputs); otherwise a
    contiguous cell-major copy.  Float4 loads need 16-byte alignment; a
    tensor that starts off it is copied."""
    t = t.to(_F32)
    planes = t.permute(0, 3, 1, 2)
    if not t.is_contiguous() and planes.is_contiguous():
        t, cell_major = planes, 0
    else:
        t, cell_major = t.contiguous(), 1
    if t.data_ptr() % 16:
        t = t.clone()
    return t, cell_major


def _kernel_args(tbl, ttbl, events, state, commute, logp, exp_eta, psi_w,
                 rate_ir_t, N, Cstar, decays, cfg):
    """The kernel's arguments (but the stream), the tensors they point to
    that must stay alive until the launch is queued, and the outputs.  The
    inputs go to the kernel as the caller holds them (float32, see
    :func:`_kernel_layout`); the kernel converts layout as it copies them
    into the outputs, allocated here in its location-major layout
    ``[C, plane, M, T]``.  The caller's tensors are never written."""
    C, M, T, _ = events.shape
    dev = events.device

    def f32(t):
        return t.to(_F32).contiguous()

    ev_in, ev_cell = _kernel_layout(events)
    st_in, st_cell = _kernel_layout(state)
    cm_in = f32(commute)
    if cm_in.data_ptr() % 16:
        cm_in = cm_in.clone()
    ins = [f32(tbl), f32(ttbl), ev_in, st_in, cm_in, f32(logp),
           f32(exp_eta), f32(psi_w), f32(rate_ir_t), f32(N), f32(Cstar),
           f32(decays)]
    outs = [
        torch.empty((C, 3, M, T), dtype=_F32, device=dev),
        torch.empty((C, 4, M, T), dtype=_F32, device=dev),
        torch.empty((C, M, T), dtype=_F32, device=dev),
        torch.empty((C,), dtype=_F32, device=dev),
        torch.empty((C, 4, trace_width(cfg.mmax)), dtype=_F32, device=dev),
    ]
    # the kernel's workspace: an E->I move's accepted commute cells
    work = torch.empty((C, M, T), dtype=_F32, device=dev)
    t_lo, t_hi = cfg.t_range
    gf = float(cfg.guide_floor)
    args = [t.data_ptr() for t in ins + outs + [work]] + [
        C, M, T, cfg.num_updates, ins[0].shape[2], ins[1].shape[3], cfg.mmax,
        cfg.nmax, cfg.dmax, cfg.occult_nmax, t_lo, t_hi,
        int(bool(cfg.occult_guided)), ev_cell, st_cell, int(T % 4 == 0),
        1.0 - gf, gf / M,
    ]
    # the inputs and the workspace ride along so they stay alive until the
    # launch is queued
    return args, ins + [work], outs


def _public_layout(outs, events, state, commute, logp):
    ev_out, st_out, cm_out, lp_out, trace = outs
    return (
        ev_out.permute(0, 2, 3, 1).to(events.dtype),
        st_out.permute(0, 2, 3, 1).to(state.dtype),
        cm_out.to(commute.dtype),
        lp_out.to(logp.dtype),
        trace,
    )


def _launch(tbl, ttbl, events, state, commute, logp, exp_eta, psi_w,
            rate_ir_t, N, Cstar, decays, cfg):
    from covid19uk_tpu_torch.ops import _build

    lib = _build.fused_sweep_library().lib
    args, _ins, outs = _kernel_args(tbl, ttbl, events, state, commute, logp,
                                    exp_eta, psi_w, rate_ir_t, N, Cstar,
                                    decays, cfg)
    dev = events.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_sweep_launch(*args, stream)
    if err != 0:
        name = _build.error_string(lib.fused_sweep_error_string, err)
        raise RuntimeError(f"fused_sweep kernel launch failed: CUDA error "
                           f"{err} ({name})")
    fused_sweep.launches += 1
    return _public_layout(outs, events, state, commute, logp)
