"""One sharded multi-chain MCMC transition on tiny shapes, over every rank.

Port of ``covid19uk_tpu/parallel/dryrun.py``, the body of the per-rank
dry-run worker (``python -m covid19uk_tpu_torch.parallel.distributed``):
each rank builds the same tiny synthetic model, and the (chain, space)
mesh of all ranks (``chain_space_mesh``'s default: a space axis of 2 from
4 ranks on) advances two chains a chain slice by one transition (the
fused sweep, so K1 runs on a card), the location axis sharded when the
space axis has more than one rank; the ranks agree on a checksum made by
an ``all_reduce``.
"""

import torch
import torch.distributed as dist

CHAINS_PER_SLICE = 2
T = 8  # and M = 8 * the space axis's ranks


def run_sharded_step(device="cuda"):
    """Runs one sharded transition on this rank's ``device`` and returns
    ``(checksum, info)``: ``checksum`` is the sum over ranks of ``sum(u)
    + sum(events)`` of the rank's new state (its chains' u, counted once
    a space rank, and its band of their events), the same float on all of
    them.  Raises if a target log-probability is not finite."""
    from covid19uk_tpu_torch.inference.driver import rank_seed, run_device
    from covid19uk_tpu_torch.inference.gibbs import (
        EventKernelConfig,
        HMCTunables,
        make_mcmc_step,
    )
    from covid19uk_tpu_torch.parallel import distributed
    from covid19uk_tpu_torch.parallel.mesh import axis, chain_space_mesh
    from covid19uk_tpu_torch.parallel.sharding import (
        SpaceBand,
        make_sharded_step,
        shard_chain_state,
        shard_tunables,
    )
    from covid19uk_tpu_torch.utils.synthetic import (
        build_synthetic_model,
        initial_chain_state,
    )

    device = run_device(distributed.local_device(device))
    mesh = chain_space_mesh()
    world = distributed.world()
    (slices, chain_rank), (space, space_rank) = (axis(mesh, "chain"),
                                                 axis(mesh, "space"))
    chains, M = CHAINS_PER_SLICE * slices, 8 * space
    model = build_synthetic_model(M, T, torch.float32, device=device)
    single = initial_chain_state(
        model, torch.Generator(device=device).manual_seed(0))
    sharded = space > 1
    state = shard_chain_state(type(single)(
        *[x.expand((chains,) + x.shape) for x in single]), mesh, sharded)
    cfg = EventKernelConfig(
        dmax=3, mmax=2, nmax=5, occult_nmax=3, num_event_time_updates=2,
        t_range=(T - 4, T), num_pair_updates=0, fused_sweep="always")
    band = SpaceBand(mesh, M) if sharded else None
    step = make_sharded_step(make_mcmc_step(model, 4, cfg, band), mesh,
                             sharded)
    tune = shard_tunables(HMCTunables(
        step_size=torch.full((chains, 1), 0.05, device=device),
        inv_mass_diag=torch.ones((chains,) + single.u.shape, device=device),
    ), mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(rank_seed(0, chain_rank, slices))
    new_state, trace = step(state, tune, gen)

    local = torch.stack([
        torch.sum(new_state.u, dtype=torch.float64) * (space_rank == 0)
        + torch.sum(new_state.events, dtype=torch.float64),
        torch.all(torch.isfinite(trace.hmc.target_log_prob)).double(),
    ])
    comm = local if dist.get_backend() == "nccl" else local.cpu()
    dist.all_reduce(comm)
    checksum, finite = comm.tolist()
    if finite != world:
        raise FloatingPointError("non-finite target_log_prob in the "
                                 "sharded step")
    if (new_state.u.shape != (CHAINS_PER_SLICE,) + single.u.shape
            or new_state.events.shape[1] != M // space):
        raise AssertionError(f"rank state {tuple(new_state.u.shape)}, "
                             f"{tuple(new_state.events.shape)}")
    info = (f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"chains={chains} M={M} T={T} ranks={world} device={device}")
    return checksum, info
