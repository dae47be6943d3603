"""Top-level MCMC driver: warmup windows, sampling bursts, posterior store.

Port of ``covid19uk_tpu/inference/driver.py``.  ``num_chains`` chains run
as the leading axis of every tensor; with one chain the output layout
matches the reference exactly, with several the datasets gain a chain
axis.  The sampler state is checkpointed per burst for resume.

The device waits for the host once per window and once per burst: a
window's or a burst's draws and traces stay on the device until its end
and then come to the host in one copy (:func:`to_host`).  Burst b is
written to the posterior store by a worker thread while burst b+1
computes; the checkpoint lags one burst.  Runs on ``device="cuda"``
unless the caller asks for the CPU, and raises without a card.

With ``use_mesh`` over several ranks (``parallel/distributed.py``), the
ranks form a (chain, space) mesh of ``world / space_devices`` chain
slices.  Each slice's ``C / (world / space_devices)`` chains run as one
batch, on each rank's own device, with a generator of the slice's own
(:func:`rank_seed` of the chain rank).  With ``space_devices > 1`` the
slice's ``space_devices`` ranks (its space group) hold its chains'
events on their bands of locations and run each transition together
(``parallel/sharding.py:SpaceBand``), with every event kernel: the
sweep, the gamma0-compensated moves and the gamma refresh run on the
gathered events, the same on every rank of the group, so the sums over
locations that they read are whole there.  The chain slices meet only at
window and burst boundaries, where the driver waits for the host anyway:
they pool the step size and mass over all chains, tune the move decays on
the acceptance of all chains, run the convergence gate on the draws of
all chains, and send their draws (bands joined first) and traces to rank
0, which alone writes the posterior, the checkpoint and the log.  These
collectives go through the host (``parallel/sharding.py:gather_chains``,
``gather_space``) on gloo and NCCL alike.
"""

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from covid19uk_tpu_torch.config import McmcConfig
from covid19uk_tpu_torch.inference import dual_averaging, welford
from covid19uk_tpu_torch.inference.gibbs import (
    ChainState,
    EventKernelConfig,
    make_mcmc_step,
)
from covid19uk_tpu_torch.inference.warmup import (
    WarmupSchedule,
    make_fixed_runner,
    make_window_runner,
    regularized_variance,
)
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import (
    CovidUK,
    ModelData,
    constrain_parameters,
)
from covid19uk_tpu_torch.parallel import distributed
from covid19uk_tpu_torch.parallel.diagnostics import (
    effective_sample_size,
    gate_statistics,
    potential_scale_reduction,
)
from covid19uk_tpu_torch.parallel.mesh import (
    axis,
    chain_mesh,
    chain_space_mesh,
)
from covid19uk_tpu_torch.parallel.sharding import (
    SpaceBand,
    chain_rows,
    gather_chains,
    gather_space,
    shard_chain_state,
)
from covid19uk_tpu_torch.utils import checkpoint as ckpt
from covid19uk_tpu_torch.utils import impute, nans, ncio
from covid19uk_tpu_torch.utils.logging import RunLog
from covid19uk_tpu_torch.utils.store import Posterior

NUM_LEAPFROG_STEPS = 16  # reference inference.py:326
INITIAL_STEP_SIZE = 0.1  # reference inference.py:325


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_device(device):
    """``device`` as a ``torch.device``, an index-free ``cuda`` on this
    rank's card (``distributed.local_device``); raises for a CUDA device
    when there is no card (the driver never falls back to the CPU)."""
    device = distributed.local_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the driver runs on the card; pass "
            "device='cpu' (the CLI's --device cpu) to run on the CPU"
        )
    return device


def check_ported(config, world=1, num_chains=1):
    """Checks the multi-device options of the ``Mcmc`` config against the
    ``world`` ranks of the run, as the JAX driver checks them against its
    device count.  With one rank ``use_mesh`` and ``space_devices`` do
    nothing: the run takes the plain path.  With several, ``use_mesh`` is
    required, ``space_devices`` must divide ``world`` and ``num_chains``
    must be a multiple of ``world / space_devices`` (``ValueError``; the
    location count must be a multiple of ``space_devices`` too, which
    ``run_mcmc`` checks).  ``space_devices > 1`` runs the location axis
    sharded with every event kernel, the off-default ones included."""
    if world == 1:
        return
    if not config.use_mesh:
        raise ValueError(
            f"{world} ranks need use_mesh: without it every rank would run "
            f"all {num_chains} chains and write the same store")
    space = config.space_devices
    if world % space != 0:
        raise ValueError(
            f"space_devices={space} must divide device count {world}")
    chain_dev = world // space
    if num_chains % chain_dev != 0:
        raise ValueError(
            f"num_chains={num_chains} must be a multiple of the chain-axis "
            f"device count {chain_dev} when use_mesh is set")


def rank_seed(seed, rank, world):
    """The seed of rank ``rank``'s generator in a run over ``world``
    ranks: ``seed`` itself for one rank, so a one-process run is
    unchanged, else 64 bits of ``SeedSequence(seed).spawn(world)[rank]``,
    which differ for every ``(seed, rank)``."""
    if world == 1:
        return seed
    child = np.random.SeedSequence(seed).spawn(world)[rank]
    return int(child.generate_state(1, np.uint64)[0])


def draws_to_dict(u_constrained, events, num_steps, num_locations):
    """Splits flat constrained parameter draws into the reference's named
    sample layout (inference.py:285-300)."""
    T1 = num_steps - 1
    return {
        "psi": u_constrained[..., 0],
        "sigma_space": u_constrained[..., 1],
        "beta_area": u_constrained[..., 2],
        "gamma0": u_constrained[..., 3],
        "gamma1": u_constrained[..., 4],
        "alpha_0": u_constrained[..., 5],
        "alpha_t": u_constrained[..., 6 : 6 + T1],
        "spatial_effect": u_constrained[..., 6 + T1 : 6 + T1 + num_locations],
        "seir": events,
    }


def pool_adaptation(step_size, wf):
    """Cross-chain pooled adaptation at window granularity: all chains share
    the geometric-mean step size and the moment-pooled mass matrix.

    The pooled variance is the population variance of the concatenated
    chains' draws (law of total variance): mean within-chain variance plus
    the between-chain variance of the means.  Exact when every chain's
    accumulator holds the same count (the driver's windows guarantee this).

    Args:
      step_size: ``[C]`` per-chain step sizes.
      wf: chain-batched :class:`welford.RunningVariance`.

    Returns:
      (step_size, wf) with identical pooled values broadcast to every chain.
    """
    C = step_size.shape[0]
    step_size = torch.exp(torch.mean(torch.log(step_size))).expand(C)
    count = torch.mean(wf.count) * C
    mean = torch.mean(wf.mean, dim=0)
    var = torch.mean(welford.variance(wf), dim=0) + torch.var(
        wf.mean, dim=0, correction=0
    )
    pooled = welford.from_stats(count, mean, var)
    wf = welford.RunningVariance(
        pooled.count.expand(C), pooled.mean.expand(C, -1),
        pooled.m2.expand(C, -1)
    )
    return step_size, wf


def _move_results(info, per_location):
    """Mirrors the reference's per-kernel results (inference.py:262-274).

    ``per_location``: move kernels carry an [mmax] payload per draw (stack
    the 4 fields one axis in); occult kernels carry scalars (stack at -1).
    """
    fields = [info.m, info.t, info.delta_t, info.x_star]
    return {
        "is_accepted": np.asarray(info.is_accepted),
        "target_log_prob": np.asarray(info.target_log_prob),
        "proposed_delta": np.stack(fields, axis=-2 if per_location else -1),
    }


def _tree_map(fn, tree):
    """``fn`` over a NamedTuple tree's array leaves (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        mapped = [_tree_map(fn, t) for t in tree]
        return tuple(mapped) if type(tree) is tuple else type(tree)(*mapped)
    return fn(tree)


def trace_to_results(traces, squeeze_chain):
    """StepTrace of numpy arrays (stacked over draws [, chains]) -> nested
    dict."""

    def fix(x):
        x = np.asarray(x)
        if squeeze_chain:
            x = x[:, 0] if x.ndim > 1 else x
        return x

    traces = _tree_map(fix, traces)
    return {
        "hmc": {
            "is_accepted": traces.hmc.is_accepted,
            "target_log_prob": traces.hmc.target_log_prob,
            "step_size": traces.hmc.step_size,
        },
        "move/S->E": _move_results(traces.move_se, per_location=True),
        "move/E->I": _move_results(traces.move_ei, per_location=True),
        "occult/S->E": _move_results(traces.occult_se, per_location=False),
        "occult/E->I": _move_results(traces.occult_ei, per_location=False),
        # Framework extensions (additive to the reference layout): the
        # joint (gamma0, E->I) ridge-move kernel and the episode-
        # translation pair-move kernel.
        "move/E->I_compensated": _move_results(
            traces.comp_ei, per_location=True
        ),
        "move/S->E+E->I_pair": _move_results(traces.pair, per_location=True),
        "gamma": {
            "is_accepted": traces.gamma.is_accepted,
            "log_accept_ratio": traces.gamma.log_accept_ratio,
        },
    }


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def to_host(tree):
    """A NamedTuple tree of device tensors as the same tree of numpy
    arrays, through one device-to-host copy: the leaves' bytes are packed
    into one device buffer (widest dtypes first, so every array stays
    aligned), copied, and split again on the host."""
    leaves = _leaves(tree)
    order = sorted(range(len(leaves)),
                   key=lambda i: -leaves[i].element_size())
    packed = torch.cat([leaves[i].contiguous().reshape(-1).view(torch.uint8)
                        for i in order])
    host = packed.cpu().numpy()
    arrays, pos = [None] * len(leaves), 0
    for i in order:
        x = leaves[i]
        n = x.numel() * x.element_size()
        np_dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
        arrays[i] = host[pos:pos + n].view(np_dtype).reshape(tuple(x.shape))
        pos += n
    it = iter(arrays)
    return _tree_map(lambda _: next(it), tree)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mcmc(
    model: CovidUK,
    initial_chain_state: ChainState,
    event_config: EventKernelConfig,
    config,
    output_file,
    num_chains=1,
    seed=1,
    schedule=None,
    checkpoint_path=None,
    device="cuda",
):
    """Runs warmup + bursts, writing every stored draw to the posterior.

    Args:
      model: CovidUK model on ``device``.
      initial_chain_state: single-chain ChainState (replicated over
        chains), or one with a leading ``num_chains`` axis.
      event_config: event-kernel knobs with t_range set.
      config: McmcConfig (or its dict) with num_bursts / num_burst_samples
        / thin.
      output_file: posterior HDF5 path, or an object with
        :class:`Posterior`'s ``write_samples``, ``write_results``,
        ``truncate``, ``__getitem__`` and ``create_dataset`` (written into
        as it is, with no preallocation).
      num_chains: chains run together as the leading tensor axis (over
        all ranks; each rank holds its rows of them).
      seed: seed of the run's ``torch.Generator`` on ``device`` (of
        each rank's: :func:`rank_seed`).
      schedule: WarmupSchedule (reference defaults if None).
      checkpoint_path: optional path for burst-granular resume.
      device: the run's device; ``"cuda"`` raises without a card.

    Returns:
      the posterior store (open) on rank 0, None on the other ranks.
    """
    if isinstance(config, dict):
        config = McmcConfig.from_dict(config)
    world = distributed.world()
    check_ported(config, world, num_chains)
    device = run_device(device)
    if initial_chain_state.u.device.type != device.type:
        raise ValueError(
            f"the chain state is on {initial_chain_state.u.device}, the run "
            f"on {device}: build the model and state on the run's device"
        )
    schedule = schedule or (
        WarmupSchedule(**config.warmup) if config.warmup else WarmupSchedule()
    )
    C = num_chains
    dtype = initial_chain_state.u.dtype
    T, M = model.num_steps, model.data.num_locations
    P = initial_chain_state.u.shape[-1]

    if initial_chain_state.u.dim() == 1:
        state = ChainState(
            *[x.expand((C,) + x.shape).contiguous()
              for x in initial_chain_state])
    elif initial_chain_state.u.shape[0] == C:
        state = initial_chain_state
    else:
        raise ValueError(
            f"initial_chain_state has {initial_chain_state.u.shape[0]} "
            f"chains, num_chains is {C}"
        )
    mesh = None
    space = config.space_devices if world > 1 else 1
    if world > 1:
        mesh = chain_space_mesh(world, space) if space > 1 else chain_mesh()
        state = shard_chain_state(state, mesh, shard_space=space > 1)
        _log(f"Sharding {C} chains over {world} ranks"
             + (f", {M} locations over {space}" if space > 1 else ""))
    lead = distributed.rank() == 0
    squeeze = C == 1
    resuming = checkpoint_path is not None and ckpt.exists(checkpoint_path)

    # ---- posterior store (preallocate via shape templates) --------------
    # Sampling draws are stored every `thin`-th (draws thin-1, 2*thin-1,
    # ...); warmup draws in full when store_warmup.
    thin = config.thin
    if config.num_burst_samples % thin != 0:
        raise ValueError(
            f"num_burst_samples={config.num_burst_samples} must be a "
            f"multiple of thin={thin}"
        )
    stored_per_burst = config.num_burst_samples // thin
    warmup_stored = schedule.total if config.store_warmup else 0
    num_samples = warmup_stored + stored_per_burst * config.num_bursts
    chain_shape = () if squeeze else (C,)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    sample_template = draws_to_dict(
        np.zeros((1,) + chain_shape + (P,), np_dtype),
        np.zeros((1,) + chain_shape + (M, T, 3), np_dtype),
        T,
        M,
    )

    def move_template(n):
        return {
            "is_accepted": np.zeros((1,) + chain_shape, bool),
            "target_log_prob": np.zeros((1,) + chain_shape, np_dtype),
            "proposed_delta": np.zeros((1,) + chain_shape + n, np_dtype),
        }

    results_template = {
        "hmc": {
            "is_accepted": np.zeros((1,) + chain_shape, bool),
            "target_log_prob": np.zeros((1,) + chain_shape, np_dtype),
            "step_size": np.zeros((1,) + chain_shape, np_dtype),
        },
        "move/S->E": move_template((4, event_config.mmax)),
        "move/E->I": move_template((4, event_config.mmax)),
        "occult/S->E": move_template((4,)),
        "occult/E->I": move_template((4,)),
        # framework extensions (trace_to_results writes these too)
        "move/E->I_compensated": move_template((4, event_config.mmax)),
        "move/S->E+E->I_pair": move_template((4, event_config.pair_mmax)),
        "gamma": {
            "is_accepted": np.zeros((1,) + chain_shape, bool),
            "log_accept_ratio": np.zeros((1,) + chain_shape, np_dtype),
        },
    }
    owns_store = lead and isinstance(output_file, (str, os.PathLike))
    if not lead:
        posterior = None  # rank 0 writes every rank's chains
    elif not owns_store:
        posterior = output_file
    elif resuming:
        # Never truncate an existing run: reopen and append past the
        # checkpointed offset.
        posterior = Posterior.open(
            output_file, sample_template, results_template
        )
    else:
        posterior = Posterior(
            output_file, sample_template, results_template, num_samples
        )
    log = RunLog(config.log_file if lead else os.devnull)
    try:
        _sample(model, state, event_config, config, schedule, posterior,
                log, checkpoint_path, resuming, seed, device, mesh)
    except BaseException:
        if owns_store:
            posterior.close()
        raise
    finally:
        log.close()
    return posterior


def _sample(model, state, event_config, config, schedule, posterior, log,
            checkpoint_path, resuming, seed, device, mesh):
    """run_mcmc's warmup, bursts and diagnostics on ``[C, ...]`` chains,
    writing to a prepared store; with ``resuming``, restarts from the
    checkpoint instead of warming up.  With a ``mesh``, ``state`` holds
    this rank's rows of the chains, and rank 0 alone writes (``posterior``
    is None elsewhere)."""
    local, P = state.u.shape  # this rank's chains
    rank = distributed.rank()
    # one generator a chain slice: the ranks of a space group draw alike
    world, chain_rank = (1, 0) if mesh is None else axis(mesh, "chain")
    space_size, space_rank = (1, 0) if mesh is None else axis(mesh, "space")
    C = local * world
    dtype = state.u.dtype
    T, M = model.num_steps, model.data.num_locations
    squeeze = C == 1
    thin = config.thin
    stored_per_burst = config.num_burst_samples // thin
    warmup_stored = schedule.total if config.store_warmup else 0
    offset = 0
    gen = torch.Generator(device=device)
    gen.manual_seed(rank_seed(seed, chain_rank, world))
    space = SpaceBand(mesh, M) if space_size > 1 else None

    def gather(tree, axis=0, dst=None):
        """``tree``'s chain axis over all ranks (on ``dst`` only; only
        the first rank of each space group takes part then)."""
        if mesh is None:
            return tree
        if dst is not None and space_rank != 0:
            return None
        return gather_chains(tree, mesh, axis, dst)

    def gather_draws(tree, axis=0):
        """``gather(tree, axis, dst=0)`` of a ``(ChainState, ...)`` tree,
        the bands of its events joined first."""
        if space is not None:
            events = gather_space(tree[0].events, mesh, axis + 1,
                                  to_lead=True)
            tree = (tree[0]._replace(events=events),) + tuple(tree[1:])
        return gather(tree, axis, dst=0)

    # Phase-split kernel stacks: the episode-translation pair moves exist
    # to equilibrate the slow infectious-person-time mode, which is a
    # *warmup* concern; warmup windows run with the configured
    # num_pair_updates, sampling bursts with num_pair_updates_sampling
    # (default 0).  Both stacks leave the same distribution invariant.
    step = make_mcmc_step(model, NUM_LEAPFROG_STEPS, event_config, space)
    step_sample = make_mcmc_step(
        model,
        NUM_LEAPFROG_STEPS,
        event_config._replace(
            num_pair_updates=config.num_pair_updates_sampling),
        space,
    )
    if config.debug_nans:
        agree = None if space is None else space.any
        step, step_sample = (nans.checked_step(step, agree),
                             nans.checked_step(step_sample, agree))

    def to_samples(draws):
        u_con = constrain_parameters(torch.from_numpy(draws.u)).numpy()
        events = draws.events
        if squeeze:
            u_con, events = u_con[:, 0], events[:, 0]
        return draws_to_dict(u_con, events, T, M)

    def write_at(draws, traces, off):
        posterior.write_samples(to_samples(draws), first_dim_offset=off)
        posterior.write_results(
            trace_to_results(traces, squeeze), first_dim_offset=off
        )

    # ---- adaptation state ------------------------------------------------
    da = dual_averaging.init(
        torch.full((local,), INITIAL_STEP_SIZE, dtype=dtype, device=device))
    wf = welford.init((local, P), dtype, device)
    inv_mass = torch.ones((local, P), dtype=dtype, device=device)

    # ---- Robbins–Monro acceptance autotuning of the move decays ----------
    # Each move kernel's displacement decay AND event-count (x) decay are
    # retuned between warmup windows toward config.move_accept_target,
    # then frozen for sampling.  Both knobs raise acceptance when lowered;
    # which one binds is scale-dependent (config.autotune_x): the same
    # error signal drives both at half the single-knob gain, so the joint
    # response stays inside the stability region gain*|slope| < 2.
    autotune = config.autotune_acceptance
    accept_target = config.move_accept_target
    autotune_x = (
        model.data.num_locations < 64 if config.autotune_x == "auto"
        else config.autotune_x == "always"
    )
    rm_gain = 0.4 if autotune_x else 0.8
    # [move_decay_se, move_decay_ei, x_decay_se, x_decay_ei] in log space
    log_decays = [float(np.log(config.move_decay))] * 2 + [
        float(np.log(config.x_decay))
    ] * 2

    def decay_tensors():
        if not autotune:
            return None
        return tuple(torch.tensor(float(np.exp(ld)), dtype=dtype,
                                  device=device) for ld in log_decays)

    decays = decay_tensors()

    def update_decays(traces):
        nonlocal decays
        if not autotune:
            return
        for i, tr in enumerate((traces.move_se, traces.move_ei)):
            acc = float(tr.is_accepted.mean())
            delta = float(np.clip(rm_gain * (acc - accept_target), -0.5, 0.5))
            knobs = (i, i + 2) if autotune_x else (i,)
            for j in knobs:  # displacement (+ event-count when gated on)
                log_decays[j] = float(
                    np.clip(
                        log_decays[j] + delta,
                        np.log(0.05), np.log(0.999999),
                    )
                )
        decays = decay_tensors()

    def pool(step_size, wf):
        if not config.pooled_adaptation or C == 1:
            return step_size, wf
        if mesh is None:
            return pool_adaptation(step_size, wf)
        # every rank pools the statistics of all C chains, as one process
        # would, and keeps its rows
        step_size, wf = pool_adaptation(*gather((step_size, wf)))
        rows = chain_rows(C, mesh)
        return step_size[rows], welford.RunningVariance(
            *[x[rows] for x in wf])

    def window(name, n, adapt_mass, state, da, wf, inv_mass):
        """One warmup window: the runner, one copy to the host and the
        store write (which advances ``offset``)."""
        nonlocal offset
        _log(f"{name.capitalize()} window {n}")
        run = make_window_runner(step, n, adapt_mass,
                                 keep_events_every=int(config.store_warmup))
        t0 = time.perf_counter()
        state, da, wf, inv_mass, draws, traces = run(
            state, da, wf, inv_mass, gen, decays)
        # only the stored draws come to the host; Welford reads the
        # device's u.  Every rank holds all chains' traces (the decays
        # tune on them), rank 0 all chains' draws.
        host_draws, host_traces = to_host(
            (draws if config.store_warmup else None, traces))
        host_traces = gather(host_traces, axis=1)
        if config.store_warmup:
            (host_draws,) = gather_draws((host_draws,), axis=1) or (None,)
            if rank == 0:
                write_at(host_draws, host_traces, offset)
            offset += n
        wall = time.perf_counter() - t0
        return state, da, wf, inv_mass, draws, traces, host_traces, wall

    def log_window(name, n, traces, wall, step_size, inv_mass):
        """The window's log event; ``step_size`` and ``inv_mass`` are what
        the next window (or sampling) starts from."""
        ranges = gather(torch.stack([step_size.min(), step_size.max(),
                                     inv_mass.min(), inv_mass.max()])
                        .cpu().numpy()[None])
        ranges = [ranges[:, 0].min(), ranges[:, 1].max(),
                  ranges[:, 2].min(), ranges[:, 3].max()]
        extra = {}
        if autotune:
            extra = dict(
                move_se_accept=round(
                    float(traces.move_se.is_accepted.mean()), 4),
                move_ei_accept=round(
                    float(traces.move_ei.is_accepted.mean()), 4),
                move_decay_se=round(float(np.exp(log_decays[0])), 4),
                move_decay_ei=round(float(np.exp(log_decays[1])), 4),
                x_decay_se=round(float(np.exp(log_decays[2])), 4),
                x_decay_ei=round(float(np.exp(log_decays[3])), 4),
            )
        log.event(
            "window", name=name, draws=n,
            hmc_accept=round(float(traces.hmc.is_accepted.mean()), 4),
            step_size=float(np.mean(traces.hmc.step_size[-1])),
            draws_per_sec=round(n * C / max(wall, 1e-9), 2),
            wall_s=wall,
            adapted_step_size_min=float(ranges[0]),
            adapted_step_size_max=float(ranges[1]),
            inv_mass_min=float(ranges[2]),
            inv_mass_max=float(ranges[3]),
            **extra,
        )

    if resuming:
        # Warmup already ran in the interrupted run; restore everything.
        host_state, key, step_size, inv_mass, offset, extra = ckpt.load(
            checkpoint_path, state
        )
        # a run over several chain slices saves every slice's generator
        saved = key.shape[0] if key.ndim == 2 else 1
        if saved != world:
            raise ValueError(
                f"the checkpoint is of a run over {saved} ranks, this run "
                f"has {world}: resume with as many ranks")
        state = ChainState(*[torch.as_tensor(x, device=device)
                             for x in host_state])
        if mesh is not None:
            rows = chain_rows(C, mesh)
            state = shard_chain_state(state, mesh, space is not None)
            key, step_size, inv_mass = key[chain_rank], step_size[
                rows], inv_mass[rows]
        gen.set_state(torch.as_tensor(key, dtype=torch.uint8))
        step_size = torch.as_tensor(step_size, device=device)
        inv_mass = torch.as_tensor(inv_mass, device=device)
        start_burst = int(extra.get("burst", 0))
        if autotune and "log_decays" in extra:
            log_decays[:] = [float(v) for v in extra["log_decays"]]
            decays = decay_tensors()
        _log(f"Resumed from checkpoint at burst {start_burst}")
    else:
        start_burst = 0

        # ---- fast window ---------------------------------------------------
        n = schedule.first_window
        state, da, wf, inv_mass, draws, _, traces, wall = window(
            "fast", n, False, state, da, wf, inv_mass)
        update_decays(traces)
        step_size = dual_averaging.step_size(da)
        # seed Welford per chain from the window's last half (reference
        # inference.py:36-47,119)
        wf = welford.from_draws(draws.u)
        step_size, wf = pool(step_size, wf)
        inv_mass = regularized_variance(wf)
        log_window("fast", n, traces, wall, step_size, inv_mass)

        # ---- slow windows ---------------------------------------------------
        for k in range(schedule.num_slow_windows):
            n = schedule.slow_window * (2**k)
            da = dual_averaging.init(step_size)
            state, da, wf, inv_mass, draws, _, traces, wall = window(
                "slow", n, True, state, da, wf, inv_mass)
            update_decays(traces)
            step_size = dual_averaging.step_size(da)
            wf = welford.from_draws(draws.u)
            step_size, wf = pool(step_size, wf)
            log_window("slow", n, traces, wall, step_size, inv_mass)

        # ---- final fast window ----------------------------------------------
        n = schedule.last_window
        da = dual_averaging.init(step_size)
        state, da, _, inv_mass, _, dev_traces, traces, wall = window(
            "fast", n, False, state, da, wf, inv_mass)
        # final step size: mean over the last half of the window's trace
        # (reference inference.py:439-441)
        step_size = torch.mean(dev_traces.hmc.step_size[n // 2:], dim=0)
        log_window("fast", n, traces, wall, step_size, inv_mass)

    # ---- sampling bursts ------------------------------------------------------
    _log("Sampling...")
    burst = make_fixed_runner(step_sample, config.num_burst_samples,
                              keep_events_every=thin)
    # rank 0's checkpoint holds every chain's tunables
    host_tunables = gather(to_host((step_size, inv_mass)), dst=0)

    # Host-side writes run on a single worker thread so burst b's write
    # overlaps burst b+1's device compute; checkpoints lag one burst
    # (saved only once the corresponding write has landed).
    executor = ThreadPoolExecutor(max_workers=1)
    pending_write = None
    pending_ckpt = None

    def flush_pending():
        nonlocal pending_write, pending_ckpt
        if pending_write is not None:
            pending_write.result()
            pending_write = None
        if checkpoint_path and pending_ckpt is not None:
            ckpt.save(checkpoint_path, **pending_ckpt)
            pending_ckpt = None

    # Between-burst convergence gate: scalar-parameter draws accumulate
    # host-side (they come back for the store anyway); sampling stops once
    # every enabled criterion holds.  On resume the gate sees only
    # post-resume draws.  Every rank gates on all chains' draws, so all
    # stop at the same burst.
    gating = config.rhat_stop is not None or config.ess_stop is not None
    gate_hist = []
    stopped_early = False

    sampling_t0 = time.perf_counter()
    try:
        for b in range(start_burst, config.num_bursts):
            profiler = None
            if config.profile_dir and rank == 0 and b == max(start_burst, 1):
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            t0 = time.perf_counter()
            state, draws, traces = burst(state, step_size, inv_mass, gen,
                                         decays)
            # the generator's state right after this burst's launches
            # (CUDA's Philox offset advances on the host at launch)
            key = gen.get_state().numpy()
            flush_pending()  # overlaps with the device computing this burst
            _synchronize(device)
            t1 = time.perf_counter()
            draws, traces = to_host((draws, traces))
            copy_ms = (time.perf_counter() - t1) * 1e3
            if profiler is not None:
                profiler.stop()
                os.makedirs(config.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(config.profile_dir, f"burst_{b}.json"))
            # keep draws thin-1, 2*thin-1, ... (draws.events holds only
            # those already)
            kept = ChainState(u=draws.u[thin - 1 :: thin],
                              events=draws.events)
            traces_w = _tree_map(lambda x: x[thin - 1 :: thin], traces)
            last = ChainState(u=draws.u[-1], events=draws.events[-1])
            accepted = traces.hmc.is_accepted
            if mesh is not None:  # every chain's, on rank 0
                sent = gather_draws((kept, traces_w, accepted), axis=1)
                ends = gather_draws((last, key[None]))
                if rank == 0:
                    (kept, traces_w, accepted), (last, key) = sent, ends
            wall = time.perf_counter() - t0
            if rank == 0:
                log.event(
                    "burst", index=b, draws=config.num_burst_samples,
                    hmc_accept=round(float(accepted.mean()), 4),
                    draws_per_sec=round(
                        config.num_burst_samples * C / max(wall, 1e-9), 2
                    ),
                    wall_s=wall,
                    copy_ms=copy_ms,
                )
                pending_write = executor.submit(write_at, kept, traces_w,
                                                offset)
                pending_ckpt = dict(
                    state=last,
                    key=key,
                    step_size=host_tunables[0],
                    inv_mass_diag=host_tunables[1],
                    offset=offset + stored_per_burst,
                    extra={"burst": b + 1, "log_decays": list(log_decays)},
                )
            offset += stored_per_burst
            _log(f"burst {b + 1}/{config.num_bursts}")
            if gating:
                u_scal = gather(np.array(np.swapaxes(draws.u[..., :6], 0,
                                                     1)))  # [C, n, 6]
                u_scal[..., :2] = np.logaddexp(0.0, u_scal[..., :2])
                gate_hist.append(u_scal)
                max_rhat, min_ess = gate_statistics(
                    np.concatenate(gate_hist, axis=1))
                ok_rhat = (
                    config.rhat_stop is None or max_rhat < config.rhat_stop
                )
                ok_ess = config.ess_stop is None or min_ess >= config.ess_stop
                log.event(
                    "gate", burst=b, max_rhat=round(max_rhat, 4),
                    min_ess=round(min_ess, 1),
                    converged=bool(ok_rhat and ok_ess),
                )
                if ok_rhat and ok_ess:
                    _log(
                        f"Convergence gate met at burst {b + 1} "
                        f"(max R-hat {max_rhat:.4f}, min ESS "
                        f"{min_ess:.0f}); stopping early"
                    )
                    stopped_early = True
                    break
        flush_pending()
    finally:
        executor.shutdown()  # waits for a write in flight
    if rank != 0:
        return
    if stopped_early:
        posterior.truncate(offset)
    sampling_wall = time.perf_counter() - sampling_t0

    # ---- cross-chain convergence diagnostics ------------------------------
    _report_diagnostics(
        posterior, warmup_stored, C, squeeze, sampling_wall, log
    )


def _report_diagnostics(posterior, warmup_total, C, squeeze, sampling_wall,
                        log):
    """Split R-hat + ESS + ESS/sec over the sampling phase for the scalar
    parameters, logged as a ``diagnostics`` event."""
    scalars = ["psi", "sigma_space", "beta_area", "gamma0", "gamma1",
               "alpha_0"]
    summary = {}
    for name in scalars:
        draws = np.asarray(posterior[f"samples/{name}"][warmup_total:])
        if squeeze:
            draws = draws[None, :]  # [1, N]
        else:
            draws = draws.T  # [C, N]
        draws = torch.as_tensor(draws)
        ess = float(torch.min(effective_sample_size(draws)))
        entry = {"ess": round(ess, 1),
                 "ess_per_sec": round(ess / max(sampling_wall, 1e-9), 2)}
        if draws.shape[0] > 1:
            entry["rhat"] = round(
                float(torch.max(potential_scale_reduction(draws))), 4)
        summary[name] = entry
    log.event("diagnostics", sampling_wall_s=round(sampling_wall, 2),
              **summary)
    for name, entry in summary.items():
        _log(f"  {name}: ESS={entry['ess']} ({entry['ess_per_sec']}/s)"
             + (f" R-hat={entry['rhat']}" if "rhat" in entry else ""))


def initialize_from_cases(cases, N, seed, impute_rates=(0.25, 0.5)):
    """The production initialization (reference inference.py:490-513):
    tile the last week 3x as an occult runway, geometrically impute the
    latent S->E / E->I events from the observed I->R cases, reconstruct
    the state (float64, on the CPU), take the initial state at the
    inference start, and clip the 21-day runway off the events.

    Args:
      cases: ``[M, T0]`` observed daily case (removal) counts.
      N: ``[M]`` population sizes.
      seed: imputation RNG seed.
      impute_rates: geometric lag rates (I->R->E->I, E->I->S->E); the
        default is the reference's (0.25, 0.5).

    Returns:
      (initial_state ``[M, 4]`` float64 numpy, events ``[M, T, 3]`` float64
      numpy) with ``T = T0``.
    """
    cases = np.asarray(cases, np.float64)
    cases_ext = np.concatenate(
        [cases, np.tile(cases[:, -7:], (1, 3))], axis=1
    )
    events_full = impute.impute_censored_events(
        cases_ext, seed=seed, rates=impute_rates
    )
    N = np.squeeze(np.asarray(N, np.float64))
    init0 = np.concatenate([N[:, None], np.zeros((N.shape[0], 3))], axis=-1)
    state_full = seir.compute_state(
        torch.as_tensor(init0), torch.as_tensor(events_full)
    ).numpy()
    start_time = state_full.shape[1] - cases_ext.shape[1]
    initial_state = state_full[:, start_time, :]
    events = events_full[:, start_time:-21, :]  # clip the runway
    return initial_state, events


def event_kernel_config(config, num_steps):
    """The event kernels' configuration of an ``Mcmc`` config section
    (reference inference.py:517-540), the occults confined to the last 21
    of ``num_steps`` days."""
    words = {"auto": "auto", "always": True, "never": False}
    return EventKernelConfig(
        dmax=config.dmax,
        mmax=config.m,
        nmax=config.nmax,
        occult_nmax=config.occult_nmax,
        num_event_time_updates=config.num_event_time_updates,
        t_range=(num_steps - 21, num_steps),
        move_decay=config.move_decay,
        x_decay=config.x_decay,
        compensate_gamma0=config.compensate_gamma0,
        num_compensated_updates=config.num_compensated_updates,
        num_pair_updates=config.num_pair_updates,
        pair_mmax=config.pair_mmax,
        pair_move_decay=config.pair_move_decay,
        pair_compensate_gamma0=config.pair_compensate_gamma0,
        gamma_gibbs=config.gamma_gibbs,
        occult_guided=words[config.occult_guided],
        move_guided=words[config.move_guided],
        move_guide_floor=config.move_guide_floor,
        occult_guide_floor=config.occult_guide_floor,
        fused_sweep=config.fused_sweep,
    )


def prepare(data_file, config, device):
    """The model, the single-chain initial state and the event kernels'
    configuration that :func:`mcmc` runs (reference inference.py:490-576),
    from the data file and the ``Mcmc`` config on ``device``; every rank
    builds the same.  Returns ``(model, chain_state, event_config,
    initial_state, dates)``."""
    dtype = torch.float64 if config.dtype == "float64" else torch.float32
    constant_data = ncio.load_group(data_file, "constant_data")
    observations = ncio.load_group(data_file, "observations")
    cases = np.asarray(observations["cases"], np.float64)  # [M, T0]
    dates = observations.coords.get("time")

    initial_state, events = initialize_from_cases(
        cases, constant_data["N"], config.seed,
        impute_rates=tuple(config.impute_rates),
    )

    T = events.shape[1]
    M = events.shape[0]

    # keep_C=False: the raw directed flow matrix is only used by the
    # within/between verb (which builds its own ModelData)
    sparse = {"auto": "auto", "always": True, "never": False}[config.sparse]
    data = ModelData.create(
        constant_data.variables, dtype, sparse=sparse, keep_C=False,
        num_chains=config.num_chains, device=device,
    )
    model = CovidUK(
        data=data,
        initial_state=torch.as_tensor(initial_state, dtype=dtype,
                                      device=device),
        initial_step=0,
        num_steps=T,
    )

    # reference inference.py:563-576
    u0 = torch.zeros((6 + (T - 1) + M,), dtype=dtype, device=device)
    chain_state = ChainState(
        u=u0, events=torch.as_tensor(events, dtype=dtype, device=device))
    return (model, chain_state, event_kernel_config(config, T),
            initial_state, dates)


def mcmc(data_file, output_file, config, device="cuda"):
    """Constructs and runs the MCMC (reference inference.py:473-608).

    Joins a group of ranks first when the launcher's environment names
    one (``parallel/distributed.py:initialize``); rank 0 then writes the
    posterior of every rank's chains.

    Args:
      data_file: HDF5 with groups ``constant_data`` and ``observations``.
      output_file: posterior HDF5 output path.
      config: the ``Mcmc`` config section (example_config.yaml:25-34), plus
        optional extras: num_chains, dtype, seed, checkpoint.
      device: the run's device; ``"cuda"`` raises without a card.
    """
    if isinstance(config, dict):
        config = McmcConfig.from_dict(config)
    distributed.initialize()
    check_ported(config, distributed.world(), config.num_chains)
    device = run_device(device)
    model, chain_state, event_config, initial_state, dates = prepare(
        data_file, config, device)

    if distributed.rank() == 0:
        lp0 = model.joint_log_prob_unconstrained(chain_state.u,
                                                 chain_state.events)
        print("Initial logpi:", float(lp0), flush=True)

    posterior = run_mcmc(
        model,
        chain_state,
        event_config,
        config,
        output_file,
        num_chains=config.num_chains,
        seed=config.seed,
        checkpoint_path=config.checkpoint,
        device=device,
    )
    if posterior is None:
        return  # this rank's chains are in rank 0's store
    posterior.create_dataset("initial_state", initial_state)
    if dates is not None:
        posterior.create_dataset(
            "time",
            np.asarray(dates).astype("datetime64[D]").astype(str).astype("S"),
        )

    for name, key_ in [
        ("theta", "results/hmc/is_accepted"),
        ("move S->E", "results/move/S->E/is_accepted"),
        ("move E->I", "results/move/E->I/is_accepted"),
        ("occult S->E", "results/occult/S->E/is_accepted"),
        ("occult E->I", "results/occult/E->I/is_accepted"),
    ] + (
        [("gamma", "results/gamma/is_accepted")] if config.gamma_gibbs else []
    ):
        print(f"Acceptance {name}: {posterior[key_][:].mean()}")

    posterior.close()
