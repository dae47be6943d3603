"""Metropolis-Hastings kernels on the latent event tensor (torch).

Port of ``covid19uk_tpu/inference/event_kernels.py``, batched over chains:
events ``[C, M, T, X]``, state ``[C, M, T, S]``, logp ``[C]``, an optional
threaded commute ``[C, M, T]``.  Each kernel proposes, evaluates and
accepts or rejects for every chain at once, branch-free (``torch.where``),
with no loop over chains and no host sync.  Proposals and Hastings
corrections are the JAX package's; invalid proposals are rejected by the
density (-inf).  Randomness comes from a ``torch.Generator``, so the draws
differ from the JAX package's and the kernels are compared with it in
distribution; the samplers take their uniforms as arguments so that they
can be fed JAX's.

Every kernel returns ``(events, state, commute, logp, EventMoveInfo)``;
``commute`` is None when none was threaded in.  The gamma0-compensated
kernels are not ported yet.
"""

import math
from typing import NamedTuple

import torch

from covid19uk_tpu_torch.inference.likelihood import (
    _apply_,
    apply_event_delta,
    apply_event_deltas,
)


class EventMoveInfo(NamedTuple):
    """Per-draw trace with a leading chain dim (the JAX layout)."""

    is_accepted: torch.Tensor
    target_log_prob: torch.Tensor
    m: torch.Tensor  # proposed location(s)
    t: torch.Tensor  # proposed source time(s)
    delta_t: torch.Tensor  # displacement (moves) or +/-1 (occults)
    x_star: torch.Tensor  # number of events moved/added/deleted


def _uniform(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def _gumbel(gen, shape, like):
    u = torch.clamp(_uniform(gen, shape, like),
                    min=torch.finfo(like.dtype).tiny)
    return -torch.log(-torch.log(u))


def _sample_locations(gen, events, mmax, guide_logits=None):
    """``[C, mmax]`` distinct locations per chain: uniform without
    replacement, or weighted by fixed ``guide_logits [C, M]``; both as a
    Gumbel top-k (the same distribution as ``jax.random.choice(...,
    replace=False)``, other draws)."""
    C, M = events.shape[:2]
    g = _gumbel(gen, (C, M), events)
    if guide_logits is not None:
        g = g + guide_logits
    return torch.topk(g, mmax, dim=-1).indices


def _uniform_nonzero_time(gumbel, counts):
    """t uniform over {t : counts[..., t] > 0} (Gumbel argmax); returns
    ``(t, n_nonzero)``, t arbitrary where n_nonzero == 0."""
    mask = counts > 0
    n_nonzero = torch.sum(mask, dim=-1)
    logits = torch.where(mask, 0.0, -torch.inf).to(gumbel.dtype)
    return torch.argmax(logits + gumbel, dim=-1), n_nonzero


def _static_uniform(decay):
    """True iff ``decay`` is the Python number 1.0: the exactly-uniform
    proposal.  A tensor decay always takes the geometric branch."""
    return isinstance(decay, (float, int)) and decay == 1.0


def _as_decay(decay, ref):
    """A tensor decay clipped into (0, 1), shaped to broadcast against
    ``ref`` (a ``[C]`` decay lines up with ref's leading chain dim);
    Python numbers pass through."""
    if isinstance(decay, (float, int)):
        return decay
    decay = torch.clamp(decay, 1e-3, 1.0 - 1e-6)
    if decay.dim() == 1:
        decay = decay.reshape(decay.shape + (1,) * (ref.dim() - 1))
    return decay


def _log(decay):
    """log of a decay: in double precision for a Python number, as JAX's
    weakly typed scalars are under x64."""
    if isinstance(decay, (float, int)):
        return math.log(decay)
    return torch.log(decay)


def _sample_two_sided_geometric(u_side, u_j, left, right, decay):
    """d from P(d) ~ decay^(|d|-1) on {-left..-1} u {1..right}, from two
    uniforms; returns ``(d, log_mass)`` with log_mass the log of the
    support's total mass (the Hastings piece that does not cancel)."""
    left_f = left.to(torch.float32)
    right_f = right.to(torch.float32)
    uniform = _static_uniform(decay)
    decay = _as_decay(decay, left)
    if uniform:
        mass_l, mass_r = left_f, right_f
    else:
        mass_l = 1.0 - decay**left_f
        mass_r = 1.0 - decay**right_f
    total = torch.clamp(mass_l + mass_r, min=1e-30)
    go_right = u_side < mass_r / total
    side_len = torch.where(go_right, right_f, left_f)
    if uniform:
        j = torch.floor(u_j * torch.clamp(side_len, min=1.0)) + 1.0
    else:
        side_mass = 1.0 - decay**side_len
        j = torch.ceil(
            torch.log(torch.clamp(1.0 - u_j * side_mass, min=1e-30))
            / _log(decay))
    j = torch.minimum(torch.clamp(j, min=1.0),
                      torch.clamp(side_len, min=1.0)).to(left.dtype)
    return torch.where(go_right, j, -j), torch.log(total)


def _sample_truncated_geometric(u, cap, decay):
    """x from P(x) ~ decay^(x-1) on {1..cap} (cap a float tensor), from a
    uniform; returns ``(x, log_mass)``.  decay == 1.0 is uniform."""
    cap_f = torch.clamp(cap, min=1.0)
    if _static_uniform(decay):
        x = torch.floor(u * cap_f) + 1.0
        log_mass = torch.log(cap_f)
    else:
        decay = _as_decay(decay, cap)
        mass = 1.0 - decay**cap_f
        x = torch.ceil(torch.log(torch.clamp(1.0 - u * mass, min=1e-30))
                       / _log(decay))
        log_mass = torch.log(torch.clamp(mass, min=1e-30))
    return torch.minimum(torch.clamp(x, min=1.0), cap_f), log_mass


def _log_mass_geometric(cap, decay):
    """log sum decay^(x-1) over {1..cap} (the reverse-side normaliser)."""
    cap_f = torch.clamp(cap, min=1.0)
    if _static_uniform(decay):
        return torch.log(cap_f)
    decay = _as_decay(decay, cap)
    return torch.log(torch.clamp(1.0 - decay**cap_f, min=1e-30))


def _log_mass_rev(left_r, right_r, decay):
    """log of the displacement mass at the reverse move's source."""
    if _static_uniform(decay):
        mass = (left_r + right_r).to(torch.float32)
    else:
        dec = _as_decay(decay, left_r)
        mass = (1.0 - dec**left_r.to(torch.float32)) + (
            1.0 - dec**right_r.to(torch.float32))
    return torch.log(torch.clamp(mass, min=1e-30))


def _pick(counts, t):
    """``counts[..., t]`` for per-slot times ``t``."""
    return counts.gather(-1, t[..., None])[..., 0]


class _MoveProposal(NamedTuple):
    delta_lp: torch.Tensor  # [C] likelihood delta at fixed parameters
    hastings: torch.Tensor  # [C] log q(reverse)/q(forward)
    locs: torch.Tensor  # [C, mmax]
    t_src: torch.Tensor
    t_dst: torch.Tensor  # clipped destination times
    d: torch.Tensor  # displacements
    x_eff: torch.Tensor  # events moved (0 for null slots)


def _propose_moves(gen, events, state, evaluator, target_id, dmax, mmax,
                   nmax, move_decay, x_decay, commute=None,
                   guide_logits=None):
    """A multi-location move proposal, evaluated from the pre-move
    tensors and not applied.  Per chosen location: t_src uniform over the
    days with events, d two-sided geometric inside [0, T), x truncated
    geometric on {1..min(nmax, count)}; see the JAX package's
    ``_propose_moves`` for the Hastings ratio."""
    C, M, T, _ = events.shape
    dtype = events.dtype
    ar = torch.arange(C, device=events.device)[:, None]
    locs = _sample_locations(gen, events, mmax, guide_logits)
    counts = events[ar, locs, :, target_id]  # [C, mmax, T]
    t_src, n_nonzero = _uniform_nonzero_time(
        _gumbel(gen, counts.shape, events), counts)
    has_events = n_nonzero > 0
    left = torch.clamp(t_src, max=dmax)
    right = torch.clamp(T - 1 - t_src, max=dmax)
    d, log_mass_fwd = _sample_two_sided_geometric(
        _uniform(gen, (C, mmax), events), _uniform(gen, (C, mmax), events),
        left, right, move_decay)
    cap_fwd = torch.clamp(_pick(counts, t_src), max=float(nmax))
    x, log_mass_x_fwd = _sample_truncated_geometric(
        _uniform(gen, (C, mmax), events), cap_fwd, x_decay)
    x = x.to(dtype)
    active = has_events & (left + right > 0)
    x_eff = torch.where(active, x, 0.0)
    t_dst = torch.clamp(t_src + d, 0, T - 1)
    log_mass_rev = _log_mass_rev(torch.clamp(t_dst, max=dmax),
                                 torch.clamp(T - 1 - t_dst, max=dmax),
                                 move_decay)

    delta_total = evaluator.joint_move_delta(
        events, state, locs, t_src, t_dst, x_eff, target_id,
        commute=commute)

    ts = torch.arange(T, device=events.device)
    counts_new = counts + x_eff[..., None] * (
        (ts == t_dst[..., None]).to(dtype) - (ts == t_src[..., None]).to(
            dtype))
    n_nonzero_new = torch.sum(counts_new > 0, dim=-1)
    cap_rev = torch.clamp(_pick(counts_new, t_dst), max=float(nmax))
    log_q_fwd = (
        -torch.log(torch.clamp(n_nonzero, min=1).to(dtype))
        - log_mass_x_fwd.to(dtype)
        - log_mass_fwd.to(dtype)
    )
    log_q_rev = (
        -torch.log(torch.clamp(n_nonzero_new, min=1).to(dtype))
        - _log_mass_geometric(cap_rev, x_decay).to(dtype)
        - log_mass_rev.to(dtype)
    )
    hastings = torch.sum(torch.where(active, log_q_rev - log_q_fwd, 0.0),
                         dim=-1)
    return _MoveProposal(delta_lp=delta_total, hastings=hastings, locs=locs,
                         t_src=t_src, t_dst=t_dst, d=d, x_eff=x_eff)


def event_move_step(gen, events, state, current_logp, evaluator,
                    target_id: int, dmax: int, mmax: int, nmax: int,
                    move_decay=0.9, x_decay=1.0, commute=None,
                    guide_logits=None):
    """Moves up to ``nmax`` events of transition ``target_id`` in time at
    ``mmax`` locations jointly (one accept/reject per chain); the moves are
    applied once, after the decision, with x masked to 0 on rejection.

    Returns ``(events, state, commute, logp, EventMoveInfo)``."""
    dtype = events.dtype
    prop = _propose_moves(gen, events, state, evaluator, target_id, dmax,
                          mmax, nmax, move_decay, x_decay, commute=commute,
                          guide_logits=guide_logits)
    log_alpha = prop.delta_lp + prop.hastings
    u = _uniform(gen, log_alpha.shape, events)
    accepted = torch.log(u) < log_alpha
    x_apply = torch.where(accepted[:, None], prop.x_eff, 0.0)
    ev, st = apply_event_deltas(events, state, prop.locs, prop.t_src,
                                prop.t_dst, x_apply, target_id)
    for i in range(mmax):
        commute = evaluator.apply_commute(
            commute, prop.locs[:, i], prop.t_src[:, i], prop.t_dst[:, i],
            x_apply[:, i], target_id)
    logp = current_logp + torch.where(accepted, prop.delta_lp, 0.0)
    info = EventMoveInfo(
        is_accepted=accepted, target_log_prob=logp,
        m=prop.locs.to(dtype), t=prop.t_src.to(dtype),
        delta_t=prop.d.to(dtype), x_star=prop.x_eff,
    )
    return ev, st, commute, logp, info


class _PairProposal(NamedTuple):
    events: torch.Tensor  # proposed tensors (both moves applied)
    state: torch.Tensor
    commute: object
    delta_lp: torch.Tensor
    hastings: torch.Tensor
    locs: torch.Tensor  # [C, mmax]
    t1: torch.Tensor  # S->E source times
    t2: torch.Tensor  # E->I source times
    t1_dst: torch.Tensor
    t2_dst: torch.Tensor
    d: torch.Tensor
    x_eff: torch.Tensor


def _propose_pairs(gen, events, state, evaluator, dmax, mmax, nmax,
                   move_decay, x_decay, commute=None, guide_logits=None):
    """An episode-translation proposal, applied to copies of the tensors
    (see :func:`pair_move_step`)."""
    C, M, T, _ = events.shape
    dtype = events.dtype
    ar = torch.arange(C, device=events.device)[:, None]
    locs = _sample_locations(gen, events, mmax, guide_logits)
    counts_ei = events[ar, locs, :, 1]  # [C, mmax, T]
    counts_se = events[ar, locs, :, 0]
    t2, n2 = _uniform_nonzero_time(_gumbel(gen, counts_ei.shape, events),
                                   counts_ei)
    ts = torch.arange(T, device=events.device)
    se_before = counts_se * (ts <= t2[..., None])
    t1, n1 = _uniform_nonzero_time(_gumbel(gen, se_before.shape, events),
                                   se_before)
    has_pair = (n2 > 0) & (n1 > 0)
    left = torch.clamp(t1, max=dmax)
    right = torch.clamp(T - 1 - t2, max=dmax)
    d, log_mass_d_fwd = _sample_two_sided_geometric(
        _uniform(gen, (C, mmax), events), _uniform(gen, (C, mmax), events),
        left, right, move_decay)
    cap_fwd = torch.clamp(torch.minimum(_pick(counts_se, t1),
                                        _pick(counts_ei, t2)),
                          max=float(nmax))
    x, log_mass_x_fwd = _sample_truncated_geometric(
        _uniform(gen, (C, mmax), events), cap_fwd, x_decay)
    x = x.to(dtype)
    active = has_pair & (left + right > 0)
    x_eff = torch.where(active, x, 0.0)
    t1_dst = torch.clamp(t1 + d, 0, T - 1)
    t2_dst = torch.clamp(t2 + d, 0, T - 1)

    # apply slot by slot; each single-transition delta is evaluated from
    # the tensors before its own move, so the deltas telescope
    ev, st, cm = events.clone(), state.clone(), commute
    delta_total = torch.zeros(C, dtype=dtype, device=events.device)
    for i in range(mmax):
        for k_id, t_from, t_to in ((0, t1[:, i], t1_dst[:, i]),
                                   (1, t2[:, i], t2_dst[:, i])):
            delta_total = delta_total + evaluator.move_delta(
                ev, st, locs[:, i], t_from, t_to, x_eff[:, i], k_id,
                commute=cm)
            _apply_(ev, st, locs[:, i], t_from, t_to, x_eff[:, i], k_id)
            cm = evaluator.apply_commute(cm, locs[:, i], t_from, t_to,
                                         x_eff[:, i], k_id)

    # Hastings: the reverse move picks t2+d, then t1+d <= t2+d, and -d
    counts_ei_new = ev[ar, locs, :, 1]
    counts_se_new = ev[ar, locs, :, 0]
    n2_new = torch.sum(counts_ei_new > 0, dim=-1)
    n1_new = torch.sum((counts_se_new > 0) & (ts <= t2_dst[..., None]),
                       dim=-1)
    log_mass_d_rev = _log_mass_rev(torch.clamp(t1_dst, max=dmax),
                                   torch.clamp(T - 1 - t2_dst, max=dmax),
                                   move_decay)
    cap_rev = torch.clamp(torch.minimum(_pick(counts_se_new, t1_dst),
                                        _pick(counts_ei_new, t2_dst)),
                          max=float(nmax))
    log_q_fwd = (
        -torch.log(torch.clamp(n2, min=1).to(dtype))
        - torch.log(torch.clamp(n1, min=1).to(dtype))
        - log_mass_x_fwd.to(dtype)
        - log_mass_d_fwd.to(dtype)
    )
    log_q_rev = (
        -torch.log(torch.clamp(n2_new, min=1).to(dtype))
        - torch.log(torch.clamp(n1_new, min=1).to(dtype))
        - _log_mass_geometric(cap_rev, x_decay).to(dtype)
        - log_mass_d_rev.to(dtype)
    )
    hastings = torch.sum(torch.where(active, log_q_rev - log_q_fwd, 0.0),
                         dim=-1)
    return _PairProposal(events=ev, state=st, commute=cm,
                         delta_lp=delta_total, hastings=hastings, locs=locs,
                         t1=t1, t2=t2, t1_dst=t1_dst, t2_dst=t2_dst, d=d,
                         x_eff=x_eff)


def _revert_pairs(prop, accepted, evaluator):
    """Undoes the proposal's moves in the chains that rejected it (in place
    on the proposal's own tensors)."""
    x_revert = torch.where(accepted[:, None], 0.0, prop.x_eff)
    ev, st, cm = prop.events, prop.state, prop.commute
    for i in range(prop.locs.shape[1]):
        for k_id, t_from, t_to in ((0, prop.t1_dst[:, i], prop.t1[:, i]),
                                   (1, prop.t2_dst[:, i], prop.t2[:, i])):
            _apply_(ev, st, prop.locs[:, i], t_from, t_to, x_revert[:, i],
                    k_id)
            cm = evaluator.apply_commute(cm, prop.locs[:, i], t_from, t_to,
                                         x_revert[:, i], k_id)
    return ev, st, cm


def pair_move_step(gen, events, state, current_logp, evaluator, dmax: int,
                   mmax: int, nmax: int, move_decay=0.9, x_decay=1.0,
                   commute=None, guide_logits=None):
    """Translates infection episodes: x S->E events at t1 and x E->I
    events at t2 (same location, t1 <= t2) move by the same displacement
    d, jointly (one accept/reject per chain).

    Proposal per chosen location: t2 uniform over the days with E->I
    events, t1 uniform over the days <= t2 with S->E events, d two-sided
    geometric on {-min(dmax, t1)..-1} u {1..min(dmax, T-1-t2)}, x truncated
    geometric on {1..min(nmax, events[t1, 0], events[t2, 1])}.  The
    reverse move picks t2+d, t1+d and -d; the Hastings ratio is the
    product of the nonzero-count, displacement-mass and count-cap
    normaliser ratios.  The kernel conserves ``sum_t t*(e1 - e0)`` per
    location, so it composes with the single-transition moves.

    Returns ``(events, state, commute, logp, EventMoveInfo)``; ``t``
    traces t2 and ``delta_t`` traces d."""
    dtype = events.dtype
    prop = _propose_pairs(gen, events, state, evaluator, dmax, mmax, nmax,
                          move_decay, x_decay, commute=commute,
                          guide_logits=guide_logits)
    log_alpha = prop.delta_lp + prop.hastings
    u = _uniform(gen, log_alpha.shape, events)
    accepted = torch.log(u) < log_alpha
    ev, st, cm = _revert_pairs(prop, accepted, evaluator)
    logp = current_logp + torch.where(accepted, prop.delta_lp, 0.0)
    info = EventMoveInfo(
        is_accepted=accepted, target_log_prob=logp,
        m=prop.locs.to(dtype), t=prop.t2.to(dtype),
        delta_t=prop.d.to(dtype), x_star=prop.x_eff,
    )
    return ev, st, cm, logp, info


def occult_step(gen, events, state, current_logp, evaluator,
                target_id: int, t_range, nmax: int, x_decay=1.0,
                guide_logits=None, commute=None):
    """Adds or deletes unobserved events of one transition.

    Proposal per chain: location uniform (or ``Categorical(guide_logits
    [C, M])``, fixed weights whose factor cancels), t uniform on
    ``[t_range)``, add or delete with probability 1/2; add x ~
    TruncGeom{1..nmax}, delete x ~ TruncGeom{1..min(nmax, count)}.  A
    delete on an empty cell is a null proposal, not counted as accepted.

    Returns ``(events, state, commute, logp, EventMoveInfo)``."""
    C, M, T, _ = events.shape
    dtype, dev = events.dtype, events.device
    t_lo, t_hi = t_range
    ar = torch.arange(C, device=dev)
    if guide_logits is None:
        loc = torch.randint(0, M, (C,), generator=gen, device=dev)
    else:
        loc = torch.argmax(guide_logits + _gumbel(gen, (C, M), events),
                           dim=-1)
    t = torch.randint(t_lo, t_hi, (C,), generator=gen, device=dev)
    is_add = _uniform(gen, (C,), events) < 0.5
    count = events[ar, loc, t, target_id]
    cap_del = torch.clamp(count, max=float(nmax))
    nmax_f = torch.full_like(count, float(nmax))
    u_x = _uniform(gen, (C,), events)  # one draw for both branches
    x_add, _ = _sample_truncated_geometric(u_x, nmax_f, x_decay)
    x_del, _ = _sample_truncated_geometric(u_x, cap_del, x_decay)
    can_delete = count > 0
    x = torch.where(is_add, x_add, torch.where(can_delete, x_del, 0.0))
    delta_x = torch.where(is_add, x, -x)

    delta_lp = evaluator.occult_delta(events, state, loc, t, delta_x,
                                      target_id, commute=commute)
    log_h_add = _log_mass_geometric(nmax_f, x_decay) - _log_mass_geometric(
        torch.minimum(nmax_f, count + x_add), x_decay)
    log_h_del = _log_mass_geometric(cap_del, x_decay) - _log_mass_geometric(
        nmax_f, x_decay)
    hastings = torch.where(is_add, log_h_add, log_h_del)

    is_null = ~is_add & ~can_delete
    u = _uniform(gen, (C,), events)
    accepted = ~is_null & (torch.log(u) < delta_lp + hastings)
    x_apply = torch.where(accepted, delta_x, 0.0)
    ev, st = apply_event_delta(events, state, loc, t, t, x_apply, target_id,
                               occult=True)
    commute = evaluator.apply_commute(commute, loc, t, t, x_apply, target_id,
                                      occult=True)
    logp = current_logp + torch.where(accepted, delta_lp, 0.0)
    info = EventMoveInfo(
        is_accepted=accepted, target_log_prob=logp, m=loc.to(dtype),
        t=t.to(dtype), delta_t=torch.where(is_add, 1.0, -1.0).to(dtype),
        x_star=torch.abs(delta_x),
    )
    return ev, st, commute, logp, info


def compensated_move_step(*args, **kwargs):
    """The gamma0-compensated move (not ported yet)."""
    raise NotImplementedError(
        "compensated_move_step is not ported yet (off-default kernels)")


def compensated_pair_move_step(*args, **kwargs):
    """The gamma0-compensated pair move (not ported yet)."""
    raise NotImplementedError(
        "compensated_pair_move_step is not ported yet (off-default kernels)")
