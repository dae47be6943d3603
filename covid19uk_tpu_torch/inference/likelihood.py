"""Likelihood evaluators for the event-tensor MH kernels (torch).

Port of ``covid19uk_tpu/inference/likelihood.py``, batched over chains:
every tensor leads with the chain dim C (events ``[C, M, T, X]``, state
``[C, M, T, S]``, commute ``[C, M, T]``), and a proposal's location, times
and counts are ``[C]`` (or ``[C, L]`` for L joint moves) index and value
tensors, so all chains are evaluated together with no loop over chains and
no host sync.

* :class:`FullEvaluator` re-evaluates a caller's density
  ``events [C, ...] -> [C]`` per proposal (tests on enumerable targets).
* :class:`WindowedEvaluator` evaluates only the log-pmf cells a move can
  change, over a bounded window of days.  An S->E move changes no rate:
  only the moved row's terms differ.  An E->I move changes I, so the S->E
  rate changes at every location through ``commute = Cstar @ (I/N)``; n
  and k do not, so the lgamma terms cancel and the commute change is a
  rank-1 column update.

Windows follow ``jax.lax.dynamic_slice_in_dim``: the start is clamped into
``[0, T - W]``.  With ``commute=`` a threaded ``Cstar @ (I/N)`` is sliced
instead of recomputed, and :meth:`WindowedEvaluator.apply_commute` keeps it
consistent under applied moves; ``commute=None`` recomputes it through the
block-sparse operator (K2) when the context has one, else densely.
"""

import functools
from typing import Callable, NamedTuple

import torch

from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import (
    RATE_EPS,
    CovidUK,
    Parameters,
    _alpha_timeseries,
    _tail,
)
from covid19uk_tpu_torch.ops.binomial import binomial_log_pmf_from_rate

_STOICH = seir.STOICHIOMETRY


def _ar(x):
    return torch.arange(x.shape[0], device=x.device)


@functools.cache
def _stoich_on(k, dtype, device):
    return torch.as_tensor(_STOICH[k], dtype=dtype, device=device)


def _stoich(k, like):
    """Row k of the stoichiometry on ``like``'s device, made once (a copy
    from the host on every call would wait for the device)."""
    return _stoich_on(k, like.dtype, like.device)


def _window(a, s, W, dim):
    """``a[c]``'s days ``[s[c], s[c] + W)`` along ``dim``, the start clamped
    into ``[0, T - W]`` as ``dynamic_slice`` clamps it; ``a`` leads with
    the chain dim, ``s`` is ``[C]``."""
    T = a.shape[dim]
    s = torch.clamp(s, 0, T - W)
    idx = s[:, None] + torch.arange(W, device=a.device)
    shape = [1] * a.dim()
    shape[0], shape[dim] = a.shape[0], W
    size = list(a.shape)
    size[dim] = W
    return torch.gather(a, dim, idx.reshape(shape).expand(size))


def _windows(a, s, W):
    """``[C, M, T] -> [C, L, M, W]``: one window per start in ``s [C, L]``."""
    C, M, T = a.shape
    s = torch.clamp(s, 0, T - W)
    idx = s[..., None] + torch.arange(W, device=a.device)  # [C, L, W]
    L = s.shape[1]
    return torch.gather(a[:, None].expand(C, L, M, T), 3,
                        idx[:, :, None, :].expand(C, L, M, W))


def _apply_(events, state, loc, t_from, t_to, x, k, occult=False):
    """In place: x events of transition k at ``loc`` move from ``t_from``
    to ``t_to`` (occult: ``x`` signed events added at ``t_to``), and the
    state follows on the open-closed window between the two times."""
    T = events.shape[-2]
    dtype = events.dtype
    ar = _ar(events)
    ts = torch.arange(T, device=events.device)
    # one index per chain, so plain (non-accumulating) index updates are
    # exact; index_put_(accumulate=True) takes a far slower sorting path on
    # CUDA tensors
    ev_k = events[..., k]
    ev_k[ar, loc, t_to] += x
    w = (ts > t_to[:, None]).to(dtype)
    if not occult:
        ev_k[ar, loc, t_from] -= x
        w = w - (ts > t_from[:, None]).to(dtype)
    state[ar, loc] += x[:, None, None] * w[:, :, None] * _stoich(k, state)


def apply_event_delta(events, state, loc, t_from, t_to, x, k, occult=False):
    """Applies an event perturbation to (events, state) consistently and
    returns new tensors.

    Move (``occult=False``): x events of transition k at ``loc`` relocate
    from ``t_from`` to ``t_to``; the state changes by
    ``x * S_k * ([t > t_to] - [t > t_from])``.  Occult (``occult=True``):
    ``x`` is signed; events[loc, t_to, k] += x and the state shifts by
    ``x * S_k`` for all t > t_to (``t_from`` ignored).  ``loc``,
    ``t_from``, ``t_to`` and ``x`` are ``[C]``."""
    ev, st = events.clone(), state.clone()
    _apply_(ev, st, loc, t_from, t_to, x, k, occult)
    return ev, st


def apply_event_deltas(events, state, locs, t_from, t_to, xs, k):
    """Applies L moves of transition ``k`` (``[C, L]`` arguments, distinct
    rows in each chain) and returns new tensors."""
    ev, st = events.clone(), state.clone()
    for i in range(locs.shape[1]):
        _apply_(ev, st, locs[:, i], t_from[:, i], t_to[:, i], xs[:, i], k)
    return ev, st


class LikelihoodContext(NamedTuple):
    """Rate ingredients at fixed parameters (leading chain dim optional)."""

    exp_eta: torch.Tensor  # [..., M, T]
    psi_w: torch.Tensor  # [..., T] = psi * w_t
    rate_ir_t: torch.Tensor  # [..., T]
    nu: torch.Tensor  # scalar
    Cstar: torch.Tensor  # [M, M] dense (rank-1 row gathers)
    N: torch.Tensor  # [M]
    # block-sparse operator for the full Cstar products (K2), or None
    Cstar_bsr: object = None


def make_context(model: CovidUK, params: Parameters) -> LikelihoodContext:
    d = model.data
    dtype = model.initial_state.dtype
    t_abs = model._t_abs()
    w_t = model._gather_t(d.W, t_abs)
    weekday_t = model._gather_t(d.weekday, t_abs)
    alpha = _alpha_timeseries(params.alpha_0, params.alpha_t, t_abs)
    eta = (
        alpha[..., None, :]
        + _tail(params.beta_area, 2) * d.log_area[:, None]
        + _tail(params.sigma_space, 2) * params.spatial_effect[..., :, None]
    )
    return LikelihoodContext(
        exp_eta=torch.exp(eta),
        psi_w=_tail(params.psi, 1) * w_t,
        rate_ir_t=torch.exp(
            _tail(params.gamma0, 1) + _tail(params.gamma1, 1) * weekday_t
        ),
        nu=torch.tensor(seir.NU, dtype=dtype, device=d.N.device),
        Cstar=d.Cstar,
        N=d.N,
        Cstar_bsr=d.Cstar_bsr,
    )


def _rate_diff_no_lgamma(n, k, r_old, r_new):
    """Log-pmf delta when only the rate changed (n, k fixed): the lgamma
    terms cancel analytically."""
    tiny = torch.finfo(n.dtype).tiny
    lp_old = torch.log(-torch.expm1(-torch.clamp(r_old, min=tiny)))
    lp_new = torch.log(-torch.expm1(-torch.clamp(r_new, min=tiny)))
    return k * (lp_new - lp_old) - (n - k) * (r_new - r_old)


class WindowedEvaluator(NamedTuple):
    """Incremental log-likelihood deltas over windows of ``window`` days,
    for every chain at once (the context's rate tensors lead with C)."""

    ctx: LikelihoodContext
    window: int  # dmax + 1 for moves; T - t_range[0] for occults

    def _full_commute(self, i_over_n):
        """``Cstar @ x`` for ``x [..., M, W]``: one K2 launch with a
        block-sparse operator, else a dense matmul."""
        ctx = self.ctx
        if ctx.Cstar_bsr is not None:
            return ctx.Cstar_bsr.matmul(i_over_n)
        return torch.matmul(ctx.Cstar, i_over_n)

    def _delta(self, events, state, loc, s, k, t_from, t_to, x, occult,
               commute=None):
        """Delta over the window ``[s, s + W)`` of every chain.

        k == 0 (S->E changed): only the loc row's transition-{0,1} terms
        differ, rates unchanged.  k == 1 (E->I changed): the S->E rates
        change at all locations (rate-only cells; rank-1 commute update)
        plus the loc row's transition-{1,2} terms."""
        ctx = self.ctx
        W = self.window
        dtype = events.dtype
        ar = _ar(events)
        row_old = _window(state[ar, loc], s, W, 1)  # [C, W, S]
        evrow_old = _window(events[ar, loc], s, W, 1)  # [C, W, X]

        # the loc row's new window, reconstructed from the move
        p = s[:, None] + torch.arange(W, device=events.device)
        xc = x[:, None]
        zero = torch.zeros((), dtype=dtype, device=events.device)
        if occult:
            w_p = (p > t_to[:, None]).to(dtype)
            ev_delta = torch.where(p == t_to[:, None], xc, zero)
        else:
            w_p = (p > t_to[:, None]).to(dtype) - (p > t_from[:, None]).to(
                dtype)
            ev_delta = torch.where(p == t_to[:, None], xc, zero) - torch.where(
                p == t_from[:, None], xc, zero)
        row_new = row_old + (xc * w_p)[:, :, None] * _stoich(k, state)
        evrow_new = evrow_old.clone()
        evrow_new[..., k] += ev_delta
        N_loc = ctx.N[loc][:, None]

        if k == 0:
            if commute is not None:
                commute_row = _window(commute[ar, loc], s, W, 1)  # [C, W]
            else:
                I_cols = _window(state[..., 2], s, W, 2)  # [C, M, W]
                commute_row = torch.einsum(
                    "cm,cmw->cw", ctx.Cstar[loc], I_cols / ctx.N[:, None])
            rate_se = (
                _window(ctx.exp_eta[ar, loc], s, W, 1)
                * (row_old[..., 2] + _window(ctx.psi_w, s, W, 1)
                   * commute_row)
                / N_loc
                + RATE_EPS
            )
            lp_old = binomial_log_pmf_from_rate(
                row_old[..., 0], evrow_old[..., 0], rate_se
            ) + binomial_log_pmf_from_rate(
                row_old[..., 1], evrow_old[..., 1], ctx.nu)
            lp_new = binomial_log_pmf_from_rate(
                row_new[..., 0], evrow_new[..., 0], rate_se
            ) + binomial_log_pmf_from_rate(
                row_new[..., 1], evrow_new[..., 1], ctx.nu)
            return torch.sum(lp_new - lp_old, dim=-1)

        # k == 1: all-location S->E rate-only cells (S and ev0 unchanged)
        I_old = _window(state[..., 2], s, W, 2)  # [C, M, W]
        dI_row = xc * w_p * float(_STOICH[1][2])  # [C, W]
        I_new = I_old.clone()
        I_new[ar, loc] += dI_row
        if commute is not None:
            commute_old = _window(commute, s, W, 2)
        else:
            commute_old = self._full_commute(I_old / ctx.N[:, None])
        dI = dI_row / N_loc  # rank-1: only loc changed
        commute_new = commute_old + ctx.Cstar[loc][:, :, None] * dI[:, None]
        pref = _window(ctx.exp_eta, s, W, 2) / ctx.N[:, None]
        pw = _window(ctx.psi_w, s, W, 1)[:, None, :]
        r_old = pref * (I_old + pw * commute_old) + RATE_EPS
        r_new = pref * (I_new + pw * commute_new) + RATE_EPS
        delta = torch.sum(
            _rate_diff_no_lgamma(
                _window(state[..., 0], s, W, 2),
                _window(events[..., 0], s, W, 2), r_old, r_new),
            dim=(1, 2))
        rate_ir = _window(ctx.rate_ir_t, s, W, 1)
        lp_old = binomial_log_pmf_from_rate(
            row_old[..., 1], evrow_old[..., 1], ctx.nu
        ) + binomial_log_pmf_from_rate(
            row_old[..., 2], evrow_old[..., 2], rate_ir)
        lp_new = binomial_log_pmf_from_rate(
            row_new[..., 1], evrow_new[..., 1], ctx.nu
        ) + binomial_log_pmf_from_rate(
            row_new[..., 2], evrow_new[..., 2], rate_ir)
        return delta + torch.sum(lp_new - lp_old, dim=-1)

    def move_delta(self, events, state, loc, t_from, t_to, x, k,
                   commute=None):
        """``[C]`` delta log-lik for moving x events of transition k at
        ``loc`` from t_from to t_to, from the pre-move tensors."""
        T = events.shape[-2]
        s = torch.clamp(torch.minimum(t_from, t_to), 0, T - self.window)
        return self._delta(events, state, loc, s, k, t_from, t_to, x,
                           occult=False, commute=commute)

    def apply_commute(self, commute, loc, t_from, t_to, x, k, occult=False):
        """Keeps a threaded ``commute`` consistent with an applied event
        delta: a rank-1 column update when it touches I (k == 1), else
        the commute as it is.  Linear in x."""
        if commute is None or k != 1:
            return commute
        ctx = self.ctx
        T = commute.shape[-1]
        dtype = commute.dtype
        ts = torch.arange(T, device=commute.device)
        w = (ts > t_to[:, None]).to(dtype)
        if not occult:
            w = w - (ts > t_from[:, None]).to(dtype)
        xn = (x / ctx.N[loc])[:, None] * w  # [C, T]
        return commute + ctx.Cstar[loc][:, :, None] * xn[:, None, :]

    def joint_move_delta(self, events, state, locs, t_from, t_to, xs, k,
                         commute=None):
        """``[C]`` total delta of applying all L moves (``[C, L]``
        arguments, distinct locations per chain) at once, from the
        pre-move tensors.  k == 0: the sum of per-row deltas.  k == 1: the
        rate-only cells see the joint rank-L commute change, each column
        counted once, over the full time axis when the L windows cover it
        (``L * W >= T``) and over the windows otherwise."""
        T = events.shape[-2]
        W = self.window
        dtype = events.dtype
        ctx = self.ctx
        L = locs.shape[1]
        s = torch.clamp(torch.minimum(t_from, t_to), 0, T - W)  # [C, L]

        if k == 0:
            return torch.stack([
                self.move_delta(events, state, locs[:, i], t_from[:, i],
                                t_to[:, i], xs[:, i], 0, commute=commute)
                for i in range(L)], -1).sum(-1)

        rows = torch.stack([
            self._row_term_ei(events, state, locs[:, i], s[:, i],
                              t_from[:, i], t_to[:, i], xs[:, i])
            for i in range(L)], -1).sum(-1)
        if L * W >= T:
            return self._joint_rate_delta_full(
                events, state, locs, t_from, t_to, xs, commute) + rows

        M = events.shape[1]
        p = s[..., None] + torch.arange(W, device=events.device)  # [C,i,W]
        # w_cross[c, j, i, :]: move j's I change at window i's columns
        w_cross = (p[:, None] > t_to[:, :, None, None]).to(dtype) - (
            p[:, None] > t_from[:, :, None, None]).to(dtype)
        add = xs[:, :, None, None] * w_cross  # [C, j, i, W]
        I_old = _windows(state[..., 2], s, W)  # [C, L, M, W]
        onehot = (locs[..., None] == torch.arange(
            M, device=locs.device)).to(dtype)  # [C, j, M]
        I_new = I_old + torch.einsum("cjm,cjlw->clmw", onehot, add)
        if commute is not None:
            commute_old = _windows(commute, s, W)
        else:
            commute_old = self._full_commute(I_old / ctx.N[:, None])
        commute_new = commute_old + torch.einsum(
            "cjm,cjlw->clmw", ctx.Cstar[locs],
            add / ctx.N[locs][..., None, None])
        pref = _windows(ctx.exp_eta, s, W) / ctx.N[:, None]
        pw = torch.stack([_window(ctx.psi_w, s[:, i], W, 1)
                          for i in range(L)], 1)[:, :, None, :]
        r_old = pref * (I_old + pw * commute_old) + RATE_EPS
        r_new = pref * (I_new + pw * commute_new) + RATE_EPS
        cells = _rate_diff_no_lgamma(
            _windows(state[..., 0], s, W), _windows(events[..., 0], s, W),
            r_old, r_new)  # [C, L, M, W]
        # count-once: window i's column is dropped if an earlier window
        # j < i also holds it
        in_win = (p[:, None] >= s[:, :, None, None]) & (
            p[:, None] < (s + W)[:, :, None, None])  # [C, j, i, W]
        j_before_i = torch.arange(L, device=locs.device)[:, None] < \
            torch.arange(L, device=locs.device)[None, :]
        dup = torch.any(in_win & j_before_i[None, :, :, None], dim=1)
        delta = torch.sum(cells * (~dup).to(dtype)[:, :, None, :],
                          dim=(1, 2, 3))
        return delta + rows

    def _row_term_ei(self, events, state, loc, si, t_f, t_d, x):
        """``[C]``: one moved row's E->I (n_E, ev1) and I->R (n_I) window
        terms."""
        ctx = self.ctx
        W = self.window
        dtype = events.dtype
        ar = _ar(events)
        row_old = _window(state[ar, loc], si, W, 1)
        evrow_old = _window(events[ar, loc], si, W, 1)
        pp = si[:, None] + torch.arange(W, device=events.device)
        w_pp = (pp > t_d[:, None]).to(dtype) - (pp > t_f[:, None]).to(dtype)
        xc = x[:, None]
        row_new = row_old + (xc * w_pp)[:, :, None] * _stoich(1, state)
        zero = torch.zeros((), dtype=dtype, device=events.device)
        ev_d = torch.where(pp == t_d[:, None], xc, zero) - torch.where(
            pp == t_f[:, None], xc, zero)
        evrow_new = evrow_old.clone()
        evrow_new[..., 1] += ev_d
        rate_ir = _window(ctx.rate_ir_t, si, W, 1)
        lp_old = binomial_log_pmf_from_rate(
            row_old[..., 1], evrow_old[..., 1], ctx.nu
        ) + binomial_log_pmf_from_rate(
            row_old[..., 2], evrow_old[..., 2], rate_ir)
        lp_new = binomial_log_pmf_from_rate(
            row_new[..., 1], evrow_new[..., 1], ctx.nu
        ) + binomial_log_pmf_from_rate(
            row_new[..., 2], evrow_new[..., 2], rate_ir)
        return torch.sum(lp_new - lp_old, dim=-1)

    def _joint_rate_delta_full(self, events, state, locs, t_from, t_to, xs,
                               commute):
        """All-location S->E rate-only delta of L joint E->I moves over
        the full time axis (no windows, no count-once mask)."""
        M, T = events.shape[1], events.shape[-2]
        dtype = events.dtype
        ctx = self.ctx
        ts = torch.arange(T, device=events.device)
        w_full = (ts > t_to[..., None]).to(dtype) - (
            ts > t_from[..., None]).to(dtype)  # [C, L, T]
        add = xs[..., None] * w_full * float(_STOICH[1][2])
        I_old = state[..., 2]  # [C, M, T]
        onehot = (locs[..., None] == torch.arange(
            M, device=locs.device)).to(dtype)  # [C, L, M]
        I_new = I_old + torch.einsum("cjm,cjt->cmt", onehot, add)
        if commute is not None:
            commute_old = commute
        else:
            commute_old = self._full_commute(I_old / ctx.N[:, None])
        commute_new = commute_old + torch.einsum(
            "cjm,cjt->cmt", ctx.Cstar[locs], add / ctx.N[locs][..., None])
        pref = ctx.exp_eta / ctx.N[:, None]
        pw = ctx.psi_w[:, None, :]
        r_old = pref * (I_old + pw * commute_old) + RATE_EPS
        r_new = pref * (I_new + pw * commute_new) + RATE_EPS
        return torch.sum(
            _rate_diff_no_lgamma(state[..., 0], events[..., 0], r_old,
                                 r_new), dim=(1, 2))

    def occult_delta(self, events, state, loc, t, x_signed, k,
                     commute=None):
        """``[C]`` delta log-lik for adding (x > 0) or deleting occult
        events of transition k at (loc, t).  The state changes for all
        t' > t, so the window ``[T - window, T)`` must hold every in-range
        t: the caller builds this evaluator with ``window = T -
        t_range[0]``."""
        T = events.shape[-2]
        s = torch.full_like(loc, T - self.window)
        return self._delta(events, state, loc, s, k, t, t, x_signed,
                           occult=True, commute=commute)


class FullEvaluator(NamedTuple):
    """Full re-evaluation of a caller's density ``events [C, ...] -> [C]``
    (toy targets in tests, and the reference of the windowed deltas)."""

    logp_fn: Callable

    def move_delta(self, events, state, loc, t_from, t_to, x, k,
                   commute=None):
        events_new, _ = apply_event_delta(events, state, loc, t_from, t_to,
                                          x, k)
        return self.logp_fn(events_new) - self.logp_fn(events)

    def apply_commute(self, commute, loc, t_from, t_to, x, k, occult=False):
        """The commute as it is: full re-evaluation never reads one."""
        return commute

    def joint_move_delta(self, events, state, locs, t_from, t_to, xs, k,
                         commute=None):
        events_new, _ = apply_event_deltas(events, state, locs, t_from,
                                           t_to, xs, k)
        return self.logp_fn(events_new) - self.logp_fn(events)

    def occult_delta(self, events, state, loc, t, x_signed, k,
                     commute=None):
        events_new, _ = apply_event_delta(events, state, loc, t, t,
                                          x_signed, k, occult=True)
        return self.logp_fn(events_new) - self.logp_fn(events)
