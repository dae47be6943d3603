"""Two-rank scenarios of the port's chain-parallel layer, for the tests.

Imports neither JAX nor the JAX package.  :func:`spawn` starts ``world``
ranks of ``python tests/torch_ranks.py <scenario> <dir> <rank> <world>
<device>`` joined through a file store in ``<dir>``; each rank runs the
scenario and writes what it found into ``<dir>`` for the calling test to
check.  ``parallel`` runs the sharded step on a replayed ``StepNoise``,
pooled adaptation and the gate statistics over gathered chains, and the
meshes; ``driver`` runs ``mcmc`` over the ranks on the NI data;
``space`` runs the sharded step, with the default event kernels and
with the off-default ones (the refresh's inputs recorded), and ``mcmc``
with the location axis sharded over the two ranks (``space_devices=2``)
on the data files that the calling test wrote into ``<dir>``.
"""

import json
import os
import pickle
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NI_DATA = os.path.join(ROOT, "ni_run", "inferencedata.h5")

# the sharded step's case: 8 chains of the synthetic model, float64
STEP_M, STEP_T, STEP_C = 10, 16, 8
# the gathered statistics' case
STATS_C, STATS_P, GATE_N = 8, 7, 24


def _step_config():
    from covid19uk_tpu_torch.inference.gibbs import EventKernelConfig

    return EventKernelConfig(dmax=5, mmax=2, nmax=6, occult_nmax=4,
                             num_event_time_updates=2,
                             t_range=(STEP_T - 6, STEP_T),
                             num_pair_updates=0, fused_sweep="always",
                             occult_guided=True)


# the off-default event kernels: the unfused sweep with the compensated
# E->I move, the compensated pair move and the gamma refresh
OFF_DEFAULT = dict(fused_sweep="never", compensate_gamma0=True,
                   pair_compensate_gamma0=True, num_pair_updates=1,
                   gamma_gibbs=True)
OFF_DEFAULT_SEED = 7  # the off-default step's generator, alike on all ranks


def off_default_step_config():
    return _step_config()._replace(**OFF_DEFAULT)


def record_refresh(calls):
    """Wraps the transition's gamma refresh (``gibbs.gamma_gibbs_step``)
    so that each call appends its inputs, its draws and its output
    ``(g, K_t, N_t, wd, noise, g_new)`` to ``calls``; returns the
    original."""
    from covid19uk_tpu_torch.inference import gamma_gibbs, gibbs

    original = gibbs.gamma_gibbs_step

    def wrapped(generator, g, k_t, n_t, wd, noise=None):
        g = g.clone()  # a view of the u that the step writes g_new into
        if noise is None:
            noise = gamma_gibbs.draw_noise(generator, g)
        g_new, info = original(generator, g, k_t, n_t, wd, noise=noise)
        calls.append((g, k_t, n_t, wd, noise, g_new))
        return g_new, info

    gibbs.gamma_gibbs_step = wrapped
    return original


def spawn(scenario, tmp, world=2, device="cpu", timeout=120):
    """Runs ``scenario`` on ``world`` ranks; returns their outputs and
    raises with them if a rank fails."""
    from covid19uk_tpu_torch.parallel.distributed import run_ranks

    return run_ranks(lambda r: [
        sys.executable, os.path.abspath(__file__), scenario, str(tmp),
        str(r), str(world), device], world, timeout)


def step_case(device="cpu", dtype=torch.float64):
    """The sharded step's model, 8-chain state, tunables, ``StepNoise``
    (drawn once from numpy) and transition (fused sweep, no pair moves):
    the same on every rank and in the calling test."""
    from covid19uk_tpu_torch.inference.gibbs import (
        ChainState, HMCTunables, StepNoise,
        make_mcmc_step, resolve_event_config, sweep_config)
    from covid19uk_tpu_torch.ops import fused_sweep as fs
    from covid19uk_tpu_torch.utils.synthetic import (
        build_synthetic_model, initial_chain_state)

    M, T, C = STEP_M, STEP_T, STEP_C
    model = build_synthetic_model(M, T, dtype, device=device)
    single = initial_chain_state(model, torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(5)
    P = single.u.shape[0]

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    u = single.u + t(np.pad(rng.normal(0.0, 0.05, (C, 6)),
                            ((0, 0), (0, P - 6))))
    state = ChainState(u=u, events=single.events.expand(C, -1, -1, -1)
                       .contiguous())
    cfg = _step_config()
    W = fs.Offsets(M, cfg.mmax).width
    scfg = sweep_config(resolve_event_config(cfg, M))
    U = scfg.num_updates
    noise = StepNoise(
        z=t(rng.normal(size=(C, P))), u_accept=t(rng.uniform(size=C)),
        tbl=t(rng.uniform(size=(C, U, W)), torch.float32),
        ttbl=t(rng.uniform(size=(C, U, T, 2 * cfg.mmax)), torch.float32))
    tune = HMCTunables(step_size=t(np.full((C, 1), 0.003)),
                       inv_mass_diag=t(np.ones((C, P))))
    return model, state, tune, noise, make_mcmc_step(model, 3, cfg)


def leaves(tree):
    """The tensor leaves of a NamedTuple tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in leaves(t)]


def stats_case():
    """Per-chain step sizes, Welford statistics and gate draws of 8
    chains, as numpy."""
    rng = np.random.default_rng(11)
    C, P = STATS_C, STATS_P
    return dict(
        step_size=rng.uniform(0.01, 0.2, C),
        count=np.full(C, 12.0),
        mean=rng.normal(size=(C, P)),
        var=rng.uniform(0.1, 2.0, (C, P)),
        draws=rng.normal(size=(C, GATE_N, 6)).cumsum(axis=1),
    )


def _parallel(tmp, rank, device):
    from covid19uk_tpu_torch.inference import welford
    from covid19uk_tpu_torch.inference.driver import pool_adaptation
    from covid19uk_tpu_torch.parallel.diagnostics import gate_statistics
    from covid19uk_tpu_torch.parallel.mesh import (
        chain_mesh, chain_space_mesh)
    from covid19uk_tpu_torch.parallel.sharding import (
        chain_rows, gather_chains, make_sharded_step, shard_chain_state,
        shard_tunables)

    mesh = chain_mesh()
    shapes = {name: dict(zip(m.mesh_dim_names, m.shape)) for name, m in
              (("chain", mesh), ("chain_space", chain_space_mesh()))}

    dtype = torch.float32 if device == "cuda" else torch.float64
    model, state, tune, noise, step_fn = step_case(device, dtype)
    step = make_sharded_step(step_fn, mesh)
    new_state, trace = step(shard_chain_state(state, mesh),
                            shard_tunables(tune, mesh), None, noise)
    full = gather_chains((new_state, trace), mesh)
    out = {f"step_{i}": x.cpu().numpy() for i, x in enumerate(leaves(full))}
    out["rows"] = np.arange(STEP_C)[chain_rows(STEP_C, mesh)]

    case = stats_case()
    rows = chain_rows(STATS_C, mesh)
    wf = welford.from_stats(torch.as_tensor(case["count"][rows]),
                            torch.as_tensor(case["mean"][rows]),
                            torch.as_tensor(case["var"][rows]))
    step_size, pooled = pool_adaptation(*gather_chains(
        (torch.as_tensor(case["step_size"][rows]), wf), mesh))
    out.update(pool_step_size=step_size.numpy(), pool_count=pooled.count,
               pool_mean=pooled.mean, pool_m2=pooled.m2)
    out["gate"] = np.array(gate_statistics(
        gather_chains(case["draws"][rows], mesh)))
    np.savez(os.path.join(tmp, f"parallel_{rank}.npz"), **out)
    with open(os.path.join(tmp, f"meshes_{rank}.json"), "w") as f:
        json.dump(shapes, f)


class Preempted(Exception):
    pass


def driver_config(**kw):
    """The NI runs' small configuration: 8 chains over the ranks."""
    base = dict(
        dmax=4, nmax=8, m=2, occult_nmax=4, num_event_time_updates=2,
        num_bursts=3, num_burst_samples=3, thin=1, dtype="float64", seed=1,
        num_chains=8, use_mesh=True,
        warmup=dict(first_window=6, slow_window=4, num_slow_windows=1,
                    last_window=4))
    base.update(kw)
    return base


def record_tunables(driver, calls):
    """Wraps the MCMC driver's window and burst runners so that each call
    appends what it starts from (step size, inverse mass, decays) to
    ``calls``."""
    from covid19uk_tpu_torch.inference import dual_averaging

    make_window, make_fixed = driver.make_window_runner, \
        driver.make_fixed_runner

    def host(x):
        return None if x is None else [np.asarray(v.cpu()) for v in x]

    def window_runner(*a, **k):
        run = make_window(*a, **k)

        def wrapped(state, da, wf, inv_mass, gen=None, decays=None):
            calls.append(("window", dual_averaging.step_size(da).cpu()
                          .numpy(), inv_mass.cpu().numpy(), host(decays)))
            return run(state, da, wf, inv_mass, gen, decays)

        return wrapped

    def fixed_runner(*a, **k):
        run = make_fixed(*a, **k)

        def wrapped(state, step_size, inv_mass, gen=None, decays=None):
            calls.append(("burst", step_size.cpu().numpy(),
                          inv_mass.cpu().numpy(), host(decays)))
            return run(state, step_size, inv_mass, gen, decays)

        return wrapped

    driver.make_window_runner = window_runner
    driver.make_fixed_runner = fixed_runner
    return make_window, make_fixed


def _driver(tmp, rank, device):
    from covid19uk_tpu_torch.inference import driver

    def path(name):
        return os.path.join(tmp, name)

    # (b) independent chains: no pooling, no autotuning
    plain = driver_config(pooled_adaptation=False, autotune_acceptance=False)
    driver.mcmc(NI_DATA, path("b.h5"), plain, device=device)

    # (c) the defaults and a gate; what each runner starts from, per rank
    calls = []
    originals = record_tunables(driver, calls)
    driver.mcmc(NI_DATA, path("c.h5"), driver_config(
        num_bursts=4, num_burst_samples=5, rhat_stop=5.0,
        log_file=path("c.jsonl")), device=device)
    driver.make_window_runner, driver.make_fixed_runner = originals
    with open(path(f"c_calls_{rank}.pkl"), "wb") as f:
        pickle.dump(calls, f)

    # (d) (b) interrupted when its third burst starts, then resumed
    ck = dict(plain, checkpoint=path("d.npz"))
    make_fixed, bursts = driver.make_fixed_runner, []

    def dying(*a, **k):
        run = make_fixed(*a, **k)

        def wrapped(*args):
            bursts.append(1)
            if len(bursts) == 3:
                raise Preempted
            return run(*args)

        return wrapped

    driver.make_fixed_runner = dying
    try:
        driver.mcmc(NI_DATA, path("d.h5"), ck, device=device)
        raise AssertionError("the run was not interrupted")
    except Preempted:
        pass
    driver.make_fixed_runner = make_fixed
    driver.mcmc(NI_DATA, path("d.h5"), ck, device=device)

    # (e) splits that a run over several ranks refuses: (type, message)
    refused = {}
    for name, cfg in (("space", driver_config(space_devices=2,
                                              gamma_gibbs=True)),
                      ("chains", driver_config(num_chains=3)),
                      ("no_mesh", driver_config(use_mesh=False))):
        try:
            driver.mcmc(NI_DATA, path(f"e_{name}.h5"), cfg, device=device)
            refused[name] = None
        except (NotImplementedError, ValueError) as e:
            refused[name] = (type(e).__name__, str(e))
    with open(path(f"e_{rank}.json"), "w") as f:
        json.dump(refused, f)


def space_config(M, **kw):
    """The space-sharded driver runs' configuration (the JAX package's
    ``tests/test_mesh_driver.py`` cases): 4 chains, float64."""
    base = dict(
        dmax=4, nmax=8, m=2, occult_nmax=4, num_event_time_updates=2,
        num_bursts=1, num_burst_samples=5, thin=1, dtype="float64", seed=1,
        num_chains=4,
        warmup=dict(first_window=6 if M < 128 else 4, slow_window=4,
                    num_slow_windows=1, last_window=4))
    base.update(kw)
    return base


def record_u(driver, sums):
    """Wraps the MCMC driver's window and burst runners so that each call
    appends the checksum of the chains' u it ends with to ``sums``."""
    make_window, make_fixed = driver.make_window_runner, \
        driver.make_fixed_runner

    def wrap(make):
        def runner(*a, **k):
            run = make(*a, **k)

            def wrapped(*args):
                out = run(*args)
                sums.append(float(out[0].u.sum()).hex())
                return out

            return wrapped

        return runner

    driver.make_window_runner = wrap(make_window)
    driver.make_fixed_runner = wrap(make_fixed)
    return make_window, make_fixed


def _space(tmp, rank, device):
    from covid19uk_tpu_torch.inference import driver, gibbs
    from covid19uk_tpu_torch.inference.gibbs import make_mcmc_step
    from covid19uk_tpu_torch.ops import block_sparse
    from covid19uk_tpu_torch.parallel.mesh import chain_space_mesh
    from covid19uk_tpu_torch.parallel.sharding import (
        SpaceBand, gather_space, make_sharded_step, shard_chain_state,
        shard_tunables)

    # the step: 8 chains, their locations over the two ranks
    mesh = chain_space_mesh(space=2)
    model, state, tune, noise, _ = step_case(device)
    band = SpaceBand(mesh, STEP_M)
    step = make_sharded_step(make_mcmc_step(model, 3, _step_config(), band),
                             mesh, shard_space=True)
    new, trace = step(shard_chain_state(state, mesh, True),
                      shard_tunables(tune, mesh), None, noise)
    events = gather_space(new.events, mesh, 1)
    out = {"u": new.u.numpy(), "events": events.numpy(),
           "band": new.events.numpy(),
           "accepted": trace.hmc.is_accepted.numpy()}

    # the step with the off-default kernels, generators seeded alike
    calls = []
    original = record_refresh(calls)
    step = make_sharded_step(make_mcmc_step(
        model, 3, off_default_step_config(), band), mesh, shard_space=True)
    new, trace = step(shard_chain_state(state, mesh, True),
                      shard_tunables(tune, mesh),
                      torch.Generator().manual_seed(OFF_DEFAULT_SEED),
                      noise._replace(tbl=None, ttbl=None))
    gibbs.gamma_gibbs_step = original
    (g, k_t, n_t, wd, gnoise, g_new), = calls
    out.update(off_u=new.u.numpy(), off_band=new.events.numpy(),
               off_events=gather_space(new.events, mesh, 1).numpy(),
               off_g=g.numpy(), off_k=k_t.numpy(), off_n=n_t.numpy(),
               off_wd=wd.numpy(), off_g_new=g_new.numpy(),
               **{f"off_noise_{k}": v.numpy()
                  for k, v in gnoise._asdict().items()})

    # the driver, dense (with debug_nans: the ranks agree on each check),
    # block-sparse, and dense with the off-default kernels
    for name, kw in (("dense", dict(debug_nans=True)),
                     ("sparse", dict(sparse="always")),
                     ("off_default", dict(debug_nans=True, **OFF_DEFAULT))):
        sums = []
        originals = record_u(driver, sums)
        calls = block_sparse.bsr_band_matmul.calls
        M = 256 if name == "sparse" else 4
        driver.mcmc(os.path.join(tmp, f"data{M}.h5"),
                    os.path.join(tmp, f"{name}.h5"), space_config(
                        M, use_mesh=True, space_devices=2, **kw),
                    device=device)
        driver.make_window_runner, driver.make_fixed_runner = originals
        out[f"{name}_sums"] = np.array(sums)
        out[f"{name}_band_calls"] = (block_sparse.bsr_band_matmul.calls
                                     - calls)
    np.savez(os.path.join(tmp, f"space_{rank}.npz"), **out)


def main(argv):
    scenario, tmp, rank, world, device = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)  # tiny shapes; the ranks share the host
    from covid19uk_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{tmp}/store", world, rank)
    try:
        {"parallel": _parallel, "driver": _driver, "space": _space}[
            scenario](tmp, rank, device)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
