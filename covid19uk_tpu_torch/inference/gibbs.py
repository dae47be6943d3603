"""Metropolis-within-Gibbs transition: HMC on parameters + the event sweep.

Port of ``covid19uk_tpu/inference/gibbs.py:make_mcmc_step`` for the
sampling transition: HMC over the flat unconstrained parameters, then U
multiscans of the four event kernels as one fused CUDA kernel launch
(:mod:`covid19uk_tpu_torch.ops.fused_sweep`).  Chains are the leading
dimension of every tensor.  Pair moves, the unfused sweep and the
off-default kernels are later slices of the port and raise
``NotImplementedError``.
"""

from typing import NamedTuple

import torch

from covid19uk_tpu_torch.inference import hmc
from covid19uk_tpu_torch.inference.likelihood import make_context
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


class EventMoveInfo(NamedTuple):
    is_accepted: torch.Tensor
    target_log_prob: torch.Tensor
    m: torch.Tensor  # proposed location(s)
    t: torch.Tensor  # proposed source time(s)
    delta_t: torch.Tensor  # displacement (moves) or +/-1 (occults)
    x_star: torch.Tensor  # number of events moved/added/deleted


class GammaGibbsInfo(NamedTuple):
    is_accepted: torch.Tensor
    log_accept_ratio: torch.Tensor


class StepTrace(NamedTuple):
    """Per-draw trace, the JAX package's layout with a leading chain dim."""

    hmc: hmc.HMCInfo
    move_se: EventMoveInfo
    move_ei: EventMoveInfo
    occult_se: EventMoveInfo
    occult_ei: EventMoveInfo
    comp_ei: EventMoveInfo  # zeros: compensate_gamma0 is not ported
    pair: EventMoveInfo  # zeros: num_pair_updates == 0
    gamma: GammaGibbsInfo  # zeros: gamma_gibbs is not ported


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
    sweep's uniform tables (:func:`ops.fused_sweep.draw_tables`)."""

    z: torch.Tensor
    u_accept: torch.Tensor
    tbl: torch.Tensor
    ttbl: torch.Tensor


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


def make_mcmc_step(model, num_leapfrog_steps: int,
                   event_config: EventKernelConfig):
    """Builds the MCMC transition for a batch of chains.

    Returns ``step(state, tune, generator=None, noise=None) ->
    (ChainState, StepTrace)``.  Randomness comes from ``generator`` (on
    the model's device) unless ``noise`` (:class:`StepNoise`) is given.
    """
    T = model.num_steps
    M = model.data.num_locations
    cfg = resolve_event_config(event_config, M)
    if not (0 <= cfg.t_range[0] < cfg.t_range[1] <= T):
        raise ValueError(
            f"t_range={cfg.t_range} must satisfy 0 <= lo < hi <= T={T}"
        )
    if not cfg.fused_sweep:
        raise NotImplementedError(
            "the unfused event sweep is not ported yet (a later slice: "
            "likelihood.WindowedEvaluator and event_kernels); use "
            "fused_sweep='always'"
        )
    if cfg.num_pair_updates > 0:
        raise NotImplementedError(
            "pair moves are not ported yet (the pair-move slice: "
            "WindowedEvaluator + event_kernels.pair_move_step); use "
            "num_pair_updates=0"
        )
    sweep_cfg = sweep_config(cfg)

    def step(state: ChainState, tune: HMCTunables, generator=None,
             noise=None):
        C = state.u.shape[0]
        dtype, device = state.u.dtype, state.u.device
        # The state timeseries, the commuting product and every
        # parameter-independent piece of the likelihood depend only on the
        # events, which HMC holds fixed: computed once per transition.
        full_state = seir.compute_state(model.initial_state, state.events)
        commute = model.commute_pressure(full_state[..., 2])
        loglik = model.reduced_loglik_fn(state.events, full_state, commute)

        def logdensity(u):
            params = unpack_parameters(constrain_parameters(u), T, M)
            return (
                model.log_prior(params)
                + loglik(params)
                + constrain_log_det_jacobian(u)
            )

        u_new, hmc_info = hmc.hmc_step(
            state.u, logdensity, tune.step_size, num_leapfrog_steps,
            tune.inv_mass_diag, generator,
            z=None if noise is None else noise.z,
            u_accept=None if noise is None else noise.u_accept,
        )

        params = unpack_parameters(constrain_parameters(u_new), T, M)
        ctx0 = make_context(model, params)
        logp0 = hmc_info.target_log_prob  # logp(u_new, old events)

        def pick(override, default):
            return default if override is None else override

        decays = torch.stack(
            [
                torch.as_tensor(v, dtype=torch.float32, device=device)
                .expand(C)
                for v in (
                    pick(tune.move_decay_se, cfg.move_decay),
                    pick(tune.move_decay_ei, cfg.move_decay),
                    pick(tune.x_decay_se, cfg.x_decay),
                    pick(tune.x_decay_ei, cfg.x_decay),
                    cfg.x_decay,
                )
            ],
            dim=-1,
        )
        if noise is None:
            tbl, ttbl = _fs.draw_tables(generator, C, M, T, sweep_cfg,
                                        device)
        else:
            tbl, ttbl = noise.tbl, noise.ttbl
        ev_f, _, _, logp_f, tr = _fs.fused_sweep(
            tbl, ttbl, state.events, full_state, commute, logp0,
            ctx0.exp_eta, ctx0.psi_w, ctx0.rate_ir_t, ctx0.N, ctx0.Cstar,
            decays, sweep_cfg,
        )

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

        def zero_info(n):
            z = torch.zeros((C, n), dtype=dtype, device=device)
            return EventMoveInfo(
                is_accepted=torch.zeros(C, dtype=torch.bool, device=device),
                target_log_prob=logp_f.to(dtype), m=z, t=z, delta_t=z,
                x_star=z,
            )

        trace = StepTrace(
            hmc=hmc_info,
            move_se=move_info(0),
            move_ei=move_info(1),
            occult_se=occ_info(2),
            occult_ei=occ_info(3),
            comp_ei=zero_info(cfg.mmax),
            pair=zero_info(cfg.pair_mmax),
            gamma=GammaGibbsInfo(
                is_accepted=torch.zeros(C, dtype=torch.bool, device=device),
                log_accept_ratio=torch.zeros(C, dtype=dtype, device=device),
            ),
        )
        return ChainState(u=u_new, events=ev_f), trace

    return step
