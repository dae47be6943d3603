"""Metropolis-within-Gibbs transition: HMC on parameters + the event sweep.

Port of ``covid19uk_tpu/inference/gibbs.py:make_mcmc_step``: HMC over the
flat unconstrained parameters, then U multiscans of the four event kernels
(move S->E, move E->I, occult S->E, occult E->I) and the pair moves.  The
fused sweep runs the multiscans as one CUDA kernel launch
(:mod:`covid19uk_tpu_torch.ops.fused_sweep`) with the pair moves after
it; the unfused sweep (:func:`event_sweep`) runs the kernels of
:mod:`covid19uk_tpu_torch.inference.event_kernels` in order, with the
commute threaded through them at M >= 1024, and with the options that
the fused sweep refuses: the gamma0-compensated moves
(``compensate_gamma0``, ``pair_compensate_gamma0``) and, after the
sweep, the gamma Gibbs refresh (``gamma_gibbs``).  Chains are the leading
dimension of every tensor.
"""

from typing import NamedTuple

import torch

from covid19uk_tpu_torch.inference import hmc
from covid19uk_tpu_torch.inference.event_kernels import (
    EventMoveInfo,
    compensated_move_step,
    compensated_pair_move_step,
    event_move_step,
    occult_step,
    pair_move_step,
)
from covid19uk_tpu_torch.inference.gamma_gibbs import (
    GammaGibbsInfo,
    gamma_gibbs_step,
)
from covid19uk_tpu_torch.inference.likelihood import (
    WindowedEvaluator,
    _rate_diff_no_lgamma,
    make_context,
)
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import (
    constrain_log_det_jacobian,
    constrain_parameters,
    unpack_parameters,
)
from covid19uk_tpu_torch.ops import fused_sweep as _fs


class ChainState(NamedTuple):
    """The chains' state: flat unconstrained params + latent events."""

    u: torch.Tensor  # [C, P]
    events: torch.Tensor  # [C, M, T, X]


class HMCTunables(NamedTuple):
    step_size: torch.Tensor
    inv_mass_diag: torch.Tensor  # [P] posterior-variance estimate
    # Overrides of EventKernelConfig.move_decay per move kernel, and of
    # x_decay for the two move kernels (None -> the config value).
    move_decay_se: object = None
    move_decay_ei: object = None
    x_decay_se: object = None
    x_decay_ei: object = None


class StepTrace(NamedTuple):
    """Per-draw trace, the JAX package's layout with a leading chain dim."""

    hmc: hmc.HMCInfo
    move_se: EventMoveInfo
    move_ei: EventMoveInfo
    occult_se: EventMoveInfo
    occult_ei: EventMoveInfo
    comp_ei: EventMoveInfo  # zeros when compensate_gamma0 is off
    pair: EventMoveInfo  # zeros when num_pair_updates == 0
    gamma: GammaGibbsInfo  # zeros when gamma_gibbs is off


class EventKernelConfig(NamedTuple):
    """Static event-kernel knobs; the JAX package's fields and defaults."""

    dmax: int = 84
    mmax: int = 2
    nmax: int = 25
    occult_nmax: int = 15
    num_event_time_updates: int = 5
    t_range: tuple = (0, 0)
    move_decay: float = 0.9
    x_decay: float = 0.9
    compensate_gamma0: bool = False
    num_compensated_updates: int = 1
    num_pair_updates: int = 1
    pair_mmax: int = 1
    pair_move_decay: float = 1.0
    pair_compensate_gamma0: bool = False
    gamma_gibbs: bool = False
    occult_guided: object = "auto"
    occult_guide_floor: float = 0.1
    move_guided: object = "never"
    move_guide_floor: float = 0.1
    fused_sweep: object = "never"
    thread_commute: object = "auto"


class StepNoise(NamedTuple):
    """Draws a transition uses, for injecting another RNG's numbers:
    momentum ``z [C, P]``, HMC accept uniform ``u_accept [C]`` and the
    fused sweep's uniform tables (:func:`ops.fused_sweep.draw_tables`;
    None for the unfused sweep, which draws from the generator)."""

    z: torch.Tensor
    u_accept: torch.Tensor
    tbl: torch.Tensor = None
    ttbl: torch.Tensor = None


def resolve_event_config(event_config, M):
    """Resolves the "auto"/"always"/"never" knobs to bools for M locations
    and validates them, as the JAX package's make_mcmc_step does."""
    cfg = event_config
    words = {"always": True, "never": False}
    if cfg.thread_commute == "auto":
        cfg = cfg._replace(thread_commute=M >= 1024)
    elif cfg.thread_commute in words:
        cfg = cfg._replace(thread_commute=words[cfg.thread_commute])
    if not isinstance(cfg.thread_commute, bool):
        raise ValueError(
            "thread_commute must be a bool or one of 'auto'/'always'/"
            f"'never', got {event_config.thread_commute!r}"
        )
    for field in ("occult_guided", "move_guided"):
        val = getattr(cfg, field)
        if val == "auto":
            cfg = cfg._replace(**{field: M >= 64})
        elif val in words:
            cfg = cfg._replace(**{field: words[val]})
        if not isinstance(getattr(cfg, field), bool):
            raise ValueError(
                f"{field} must be a bool or one of 'auto'/'always'/'never',"
                f" got {getattr(event_config, field)!r}"
            )
    for field in ("occult_guide_floor", "move_guide_floor"):
        val = getattr(cfg, field)
        if not (0.0 < val <= 1.0):
            raise ValueError(f"{field} must be in (0, 1], got {val!r}")
    if cfg.fused_sweep == "auto":
        cfg = cfg._replace(fused_sweep=False)
    elif cfg.fused_sweep in words:
        cfg = cfg._replace(fused_sweep=words[cfg.fused_sweep])
    if not isinstance(cfg.fused_sweep, bool):
        raise ValueError(
            "fused_sweep must be a bool or one of 'auto'/'always'/'never',"
            f" got {event_config.fused_sweep!r}"
        )
    if cfg.fused_sweep and (
        cfg.compensate_gamma0
        or cfg.gamma_gibbs
        or cfg.move_guided
        or (cfg.num_pair_updates > 0 and cfg.pair_compensate_gamma0)
    ):
        raise ValueError(
            "fused_sweep is incompatible with compensate_gamma0 / "
            "gamma_gibbs / move_guided / pair_compensate_gamma0 — "
            "disable them"
        )
    return cfg


def sweep_config(cfg):
    """The fused sweep's static knobs from a resolved EventKernelConfig."""
    return _fs.SweepConfig(
        mmax=cfg.mmax, nmax=cfg.nmax, dmax=cfg.dmax,
        occult_nmax=cfg.occult_nmax, t_range=tuple(cfg.t_range),
        num_updates=cfg.num_event_time_updates,
        occult_guided=cfg.occult_guided,
        guide_floor=cfg.occult_guide_floor,
    )


def case_guide_logits(events, t_range, floor):
    """``[C, M]`` fixed location weights (log scale) for guided proposals:
    observed I->R cases summed over ``[t_range[0], t_range[1])``, mixed
    with a uniform floor.  No kernel modifies ``events[..., 2]``, so the
    weights are state-independent and their Hastings factor cancels."""
    M = events.shape[-3]
    cases_w = torch.sum(events[..., t_range[0]:t_range[1], 2], dim=-1)
    total = torch.sum(cases_w, dim=-1, keepdim=True)
    share = torch.where(
        total > 0, (1.0 - floor) * cases_w / torch.clamp(total, min=1.0),
        0.0)
    return torch.log(share + floor / M)


def _zero_info(logp, n):
    C = logp.shape[0]
    z = torch.zeros((C, n), dtype=logp.dtype, device=logp.device)
    return EventMoveInfo(
        is_accepted=torch.zeros(C, dtype=torch.bool, device=logp.device),
        target_log_prob=logp, m=z, t=z, delta_t=z, x_star=z,
    )


class SweepResult(NamedTuple):
    events: torch.Tensor
    state: torch.Tensor
    commute: torch.Tensor  # threaded, or the input commute when unthreaded
    logp: torch.Tensor
    infos: tuple  # EventMoveInfo of the last multiscan: the four kernels
    pair: EventMoveInfo  # the last pair move
    comp: EventMoveInfo  # and the last compensated move
    gamma0: torch.Tensor  # [C] after the compensated moves (None: no input)


def _decay(override, default):
    return default if override is None else override


def pair_sweep(model, cfg, ctx, events, state, commute, logp, generator,
               n_pair, guide_logits=None):
    """``n_pair`` pair moves with the commute threaded; returns
    ``(events, state, commute, logp, info of the last)``."""
    move_eval = WindowedEvaluator(ctx=ctx,
                                  window=min(cfg.dmax + 1, model.num_steps))
    info = _zero_info(logp, cfg.pair_mmax)
    for _ in range(n_pair):
        events, state, commute, logp, info = pair_move_step(
            generator, events, state, logp, move_eval, cfg.dmax,
            cfg.pair_mmax, cfg.nmax, cfg.pair_move_decay, cfg.x_decay,
            commute=commute, guide_logits=guide_logits)
    return events, state, commute, logp, info


def moves_gamma0(cfg):
    """Whether a resolved config's sweep moves gamma0 (a compensated move
    or a compensated pair move runs)."""
    return cfg.compensate_gamma0 or (cfg.num_pair_updates > 0
                                     and cfg.pair_compensate_gamma0)


def _potential(state):
    """``[C]`` log infectious person-time: the gamma0 likelihood ridge is
    exp(gamma0) * PT ~ the removals."""
    return torch.log(torch.clamp(torch.sum(state[..., 2], dim=(-2, -1)),
                                 min=1.0))


def _gamma_delta(live_rate):
    """The compensated kernels' ``gamma_delta_fn`` at the I->R rates
    ``live_rate [C, T]``: every gamma0-dependent term at the proposed
    events, the I->R likelihood (rate-only: the lgammas cancel) and the
    N(0, 100) prior."""

    def gamma_delta(ev_new, st_new, g, g_new):
        r_old = live_rate[:, None, :]
        r_new = r_old * torch.exp(g_new - g)[:, None, None]
        d_ir = torch.sum(_rate_diff_no_lgamma(st_new[..., 2], ev_new[..., 2],
                                              r_old, r_new), dim=(-2, -1))
        return d_ir - 0.5 * (g_new**2 - g**2) / 100.0**2

    return gamma_delta


def _live_rate(rate_ir_t, g0, g0_at_rate):
    """The I->R rates ``[C, T]`` at gamma0 ``g0``, from rates computed at
    ``g0_at_rate``."""
    return rate_ir_t * torch.exp(g0 - g0_at_rate)[:, None]


def event_sweep(model, cfg, ctx, events, state, commute, logp, tune,
                generator, gamma0=None):
    """The unfused sweep on every chain: U multiscans of move S->E, move
    E->I, occult S->E, occult E->I, then ``num_pair_updates`` pair moves
    (gamma0-compensated with ``pair_compensate_gamma0``), then with
    ``compensate_gamma0`` ``num_compensated_updates`` compensated E->I
    moves.

    ``cfg`` is a resolved :class:`EventKernelConfig`; ``ctx`` the
    :class:`LikelihoodContext` at the chains' parameters; ``state`` and
    ``commute`` consistent with ``events``, which the guide weights come
    from.  With ``cfg.thread_commute`` the kernels slice the commute and
    rank-1 update it; otherwise every windowed delta recomputes it.
    ``gamma0 [C]`` is the chains' gamma0 at ``ctx``, needed by the
    compensated moves: they move it, and every later kernel sees the I->R
    rates at its live value."""
    T = model.num_steps
    occ_guide = (case_guide_logits(events, cfg.t_range,
                                   cfg.occult_guide_floor)
                 if cfg.occult_guided else None)
    move_guide = (case_guide_logits(events, (0, T), cfg.move_guide_floor)
                  if cfg.move_guided else None)
    md_se = _decay(tune.move_decay_se, cfg.move_decay)
    md_ei = _decay(tune.move_decay_ei, cfg.move_decay)
    xd_se = _decay(tune.x_decay_se, cfg.x_decay)
    xd_ei = _decay(tune.x_decay_ei, cfg.x_decay)
    move_eval = WindowedEvaluator(ctx=ctx, window=min(cfg.dmax + 1, T))
    # an occult at t changes the state at every t' > t: the window spans
    # [t_range[0], T)
    occ_eval = WindowedEvaluator(ctx=ctx, window=T - cfg.t_range[0])
    cm = commute if cfg.thread_commute else None
    pair = _zero_info(logp, cfg.pair_mmax)
    comp = _zero_info(logp, cfg.mmax)
    g0, rate_ir_t = gamma0, ctx.rate_ir_t
    compensated = moves_gamma0(cfg)
    if compensated and g0 is None:
        raise ValueError("the compensated moves need the chains' gamma0")
    for _ in range(cfg.num_event_time_updates):
        if compensated:
            # gamma0 may have moved in the last multiscan
            ctx = ctx._replace(rate_ir_t=rate_ir_t)
            move_eval = WindowedEvaluator(ctx=ctx, window=move_eval.window)
            occ_eval = WindowedEvaluator(ctx=ctx, window=occ_eval.window)
        events, state, cm, logp, i_mse = event_move_step(
            generator, events, state, logp, move_eval, 0, cfg.dmax,
            cfg.mmax, cfg.nmax, md_se, xd_se, commute=cm,
            guide_logits=move_guide)
        events, state, cm, logp, i_mei = event_move_step(
            generator, events, state, logp, move_eval, 1, cfg.dmax,
            cfg.mmax, cfg.nmax, md_ei, xd_ei, commute=cm,
            guide_logits=move_guide)
        events, state, cm, logp, i_ose = occult_step(
            generator, events, state, logp, occ_eval, 0, cfg.t_range,
            cfg.occult_nmax, cfg.x_decay, guide_logits=occ_guide,
            commute=cm)
        events, state, cm, logp, i_oei = occult_step(
            generator, events, state, logp, occ_eval, 1, cfg.t_range,
            cfg.occult_nmax, cfg.x_decay, guide_logits=occ_guide,
            commute=cm)
        if cfg.num_pair_updates > 0 and cfg.pair_compensate_gamma0:
            g0_at_rate = g0
            for _ in range(cfg.num_pair_updates):
                live = _live_rate(rate_ir_t, g0, g0_at_rate)
                ev_live = WindowedEvaluator(
                    ctx=ctx._replace(rate_ir_t=live), window=move_eval.window)
                events, state, cm, logp, g0, pair = (
                    compensated_pair_move_step(
                        generator, events, state, logp, ev_live, g0,
                        _potential, _gamma_delta(live), cfg.dmax,
                        cfg.pair_mmax, cfg.nmax, cfg.pair_move_decay,
                        cfg.x_decay, commute=cm, guide_logits=move_guide))
            rate_ir_t = _live_rate(rate_ir_t, g0, g0_at_rate)
        elif cfg.num_pair_updates > 0:
            events, state, cm, logp, pair = pair_sweep(
                model, cfg, ctx, events, state, cm, logp, generator,
                cfg.num_pair_updates, guide_logits=move_guide)
        if cfg.compensate_gamma0:
            g0_at_rate = g0
            for _ in range(cfg.num_compensated_updates):
                # an accept in an earlier repeat moved the rates
                live = _live_rate(rate_ir_t, g0, g0_at_rate)
                ev_live = WindowedEvaluator(
                    ctx=ctx._replace(rate_ir_t=live), window=move_eval.window)
                events, state, cm, logp, g0, comp = compensated_move_step(
                    generator, events, state, logp, ev_live, g0, _potential,
                    _gamma_delta(live), 1, cfg.dmax, cfg.mmax, cfg.nmax,
                    cfg.move_decay, cfg.x_decay, commute=cm,
                    guide_logits=move_guide)
            rate_ir_t = _live_rate(rate_ir_t, g0, g0_at_rate)
    return SweepResult(events, state, cm if cfg.thread_commute else commute,
                       logp, (i_mse, i_mei, i_ose, i_oei), pair, comp, g0)


def make_mcmc_step(model, num_leapfrog_steps: int,
                   event_config: EventKernelConfig, space=None):
    """Builds the MCMC transition for a batch of chains.

    Returns ``step(state, tune, generator=None, noise=None) ->
    (ChainState, StepTrace)``.  Randomness comes from ``generator`` (on
    the model's device); ``noise`` (:class:`StepNoise`) replaces the HMC
    draws and the fused sweep's tables.

    With ``space`` (``parallel.sharding.SpaceBand``) the state's events
    are this rank's band of locations, and every rank of the space group
    runs the step together with generators seeded alike: the commute once
    from the gathered ``I/N``; HMC on the band's part of the likelihood,
    the log-prior and the Jacobian added once (on the group's first rank),
    each value+grad pass summed over the group; then the event sweep on
    the gathered events (their state recomputed) and the whole commute,
    the same on every rank, each keeping its band.  The sums over
    locations that the off-default kernels read (the compensated moves'
    person-time potential and I->R delta, the gamma refresh's daily
    removals and infectious counts) are then taken over all M on every
    rank, with no collective of their own, and every rank of the group
    ends the transition with the same u.  The step carries ``space`` as
    its attribute.
    """
    T = model.num_steps
    M = model.data.num_locations
    cfg = resolve_event_config(event_config, M)
    if not (0 <= cfg.t_range[0] < cfg.t_range[1] <= T):
        raise ValueError(
            f"t_range={cfg.t_range} must satisfy 0 <= lo < hi <= T={T}"
        )
    compensated = moves_gamma0(cfg)
    sweep_cfg = sweep_config(cfg) if cfg.fused_sweep else None
    rows = slice(None) if space is None else space.rows
    initial_state = model.initial_state[rows]

    def step(state: ChainState, tune: HMCTunables, generator=None,
             noise=None):
        C = state.u.shape[0]
        dtype, device = state.u.dtype, state.u.device
        # The state timeseries, the commuting product and every
        # parameter-independent piece of the likelihood depend only on the
        # events, which HMC holds fixed: computed once per transition.
        full_state = seir.compute_state(initial_state, state.events)
        commute = model.commute_pressure(full_state[..., 2], space)
        loglik = model.reduced_loglik_fn(
            state.events, full_state, commute[..., rows, :], rows)

        def logdensity(u):
            params = unpack_parameters(constrain_parameters(u), T, M)
            if space is None:
                return (
                    model.log_prior(params)
                    + loglik(params)
                    + constrain_log_det_jacobian(u)
                )
            part = loglik(params)
            if space.lead:  # the replicated terms, once over the group
                part = part + (model.log_prior(params)
                               + constrain_log_det_jacobian(u))
            return part

        u_new, hmc_info = hmc.hmc_step(
            state.u, logdensity, tune.step_size, num_leapfrog_steps,
            tune.inv_mass_diag, generator,
            z=None if noise is None else noise.z,
            u_accept=None if noise is None else noise.u_accept,
            reduce=None if space is None else space.sum_value_grad,
        )
        events = state.events
        if space is not None:  # the sweep runs on all M locations
            events = space.gather(events, dim=1)
            # integer counts: the same bits as the bands' states, joined
            full_state = seir.compute_state(model.initial_state, events)

        params = unpack_parameters(constrain_parameters(u_new), T, M)
        ctx0 = make_context(model, params)
        logp0 = hmc_info.target_log_prob  # logp(u_new, old events)
        gamma = GammaGibbsInfo(
            is_accepted=torch.zeros(C, dtype=torch.bool, device=device),
            log_accept_ratio=torch.zeros(C, dtype=dtype, device=device),
        )

        if not cfg.fused_sweep:
            # gamma0 is u[:, 3] (identity bijection)
            res = event_sweep(model, cfg, ctx0, events, full_state,
                              commute, logp0, tune, generator,
                              gamma0=u_new[:, 3] if compensated else None)
            if compensated or cfg.gamma_gibbs:
                u_new = u_new.clone()  # written below: a tensor of its own
            if compensated:
                u_new[:, 3] = res.gamma0
            if cfg.gamma_gibbs:
                wd = model._gather_t(model.data.weekday, model._t_abs())
                g_new, gamma = gamma_gibbs_step(
                    generator, u_new[:, 3:5],
                    torch.sum(res.events[..., 2], dim=1),
                    torch.sum(res.state[..., 2], dim=1), wd)
                u_new[:, 3:5] = g_new
            trace = StepTrace(hmc_info, *res.infos, comp_ei=res.comp,
                              pair=res.pair, gamma=gamma)
            return ChainState(u=u_new, events=band(res.events)), trace

        decays = torch.stack(
            [
                torch.as_tensor(v, dtype=torch.float32, device=device)
                .expand(C)
                for v in (
                    _decay(tune.move_decay_se, cfg.move_decay),
                    _decay(tune.move_decay_ei, cfg.move_decay),
                    _decay(tune.x_decay_se, cfg.x_decay),
                    _decay(tune.x_decay_ei, cfg.x_decay),
                    cfg.x_decay,
                )
            ],
            dim=-1,
        )
        if noise is None or noise.tbl is None:
            tbl, ttbl = _fs.draw_tables(generator, C, M, T, sweep_cfg,
                                        device)
        else:
            tbl, ttbl = noise.tbl, noise.ttbl
        ev_f, st_f, cm_f, logp_f, tr = _fs.fused_sweep(
            tbl, ttbl, events, full_state, commute, logp0,
            ctx0.exp_eta, ctx0.psi_w, ctx0.rate_ir_t, ctx0.N, ctx0.Cstar,
            decays, sweep_cfg,
        )
        # Kernel order within a sweep does not change the stationary
        # distribution, so the pair moves run after the fused multiscans
        # (as many as the unfused sweep runs), with the commute the kernel
        # returns threaded through them.
        logp_f = logp_f.to(dtype)
        if cfg.num_pair_updates > 0:
            ev_f, _, _, logp_f, pair = pair_sweep(
                model, cfg, ctx0, ev_f, st_f.to(dtype), cm_f.to(dtype),
                logp_f, generator,
                cfg.num_event_time_updates * cfg.num_pair_updates)
        else:
            pair = _zero_info(logp_f, cfg.pair_mmax)

        mm = cfg.mmax
        cols = [2 + j * mm for j in range(5)]

        def move_info(r):
            return EventMoveInfo(
                is_accepted=tr[:, r, 0] > 0.5,
                target_log_prob=tr[:, r, 1].to(dtype),
                m=tr[:, r, cols[0]:cols[1]].to(dtype),
                t=tr[:, r, cols[1]:cols[2]].to(dtype),
                delta_t=tr[:, r, cols[2]:cols[3]].to(dtype),
                x_star=tr[:, r, cols[3]:cols[4]].to(dtype),
            )

        def occ_info(r):
            return EventMoveInfo(
                *[tr[:, r, 0] > 0.5] + [tr[:, r, j].to(dtype)
                                        for j in range(1, 6)]
            )

        trace = StepTrace(
            hmc=hmc_info,
            move_se=move_info(0),
            move_ei=move_info(1),
            occult_se=occ_info(2),
            occult_ei=occ_info(3),
            comp_ei=_zero_info(logp_f, cfg.mmax),
            pair=pair,
            gamma=gamma,
        )
        return ChainState(u=u_new, events=band(ev_f)), trace

    def band(events):
        return events if space is None else events[:, rows].contiguous()

    step.space = space
    return step
