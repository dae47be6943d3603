"""Port parity for the whole sampling transition (HMC + fused sweep)
against JAX make_mcmc_step(fused_sweep="always", num_pair_updates=0), the
transition with the gamma0-compensated moves and the gamma refresh, the
port's config checks, its import boundary and the chip smoke rehearsal."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import gibbs as jg
from covid19uk_tpu.ops.pallas import fused_sweep as jfs
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.inference import gibbs as tg
from covid19uk_tpu_torch.utils import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, T, U, L = 10, 16, 2, 3


def _cfg(**kw):
    base = dict(dmax=5, mmax=2, nmax=6, occult_nmax=4,
                num_event_time_updates=U, t_range=(T - 6, T),
                num_pair_updates=0, fused_sweep="always", occult_guided=True)
    base.update(kw)
    return base


def _jax_noise(key, P):
    """The draws of one JAX transition, split as gibbs.py:311,
    hmc.py:52, gibbs.py:389 and fused_sweep.py:799 split them."""
    k_hmc, k_events = jax.random.split(key)
    k_mom, k_acc = jax.random.split(k_hmc)
    k_fused, _ = jax.random.split(k_events)
    k_tbl, k_ttbl = jax.random.split(k_fused)
    width = jfs._Offsets(M, 2).width
    return (jax.random.normal(k_mom, (P,), jnp.float64),
            jax.random.uniform(k_acc, (), jnp.float64),
            jax.random.uniform(k_tbl, (U, width), jnp.float32),
            jax.random.uniform(k_ttbl, (U, T, 128), jnp.float32))


def test_transition_matches_jax():
    jm = jsyn.build_synthetic_model(M, T, jnp.float64)
    st = jsyn.initial_chain_state(jm)
    C = 2
    u = np.stack([np.asarray(st.u), np.asarray(st.u) + 0.03])
    ev = np.stack([np.asarray(st.events)] * C)
    tune = jg.HMCTunables(step_size=jnp.asarray(0.01),
                          inv_mass_diag=jnp.ones_like(st.u))
    step = jax.jit(jg.make_mcmc_step(jm, L, jg.EventKernelConfig(**_cfg())))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    outs = [step(k, jg.ChainState(jnp.asarray(u[c]), jnp.asarray(ev[c])),
                 tune) for c, k in enumerate(keys)]
    noise = [_jax_noise(k, u.shape[1]) for k in keys]

    tm = convert.model(jm, "cpu")
    tstep = tg.make_mcmc_step(tm, L, tg.EventKernelConfig(**_cfg()))
    tnoise = tg.StepNoise(*[convert.tensor(np.stack([np.asarray(n[i])
                                                     for n in noise]), "cpu")
                            for i in range(4)])
    state = tg.ChainState(convert.tensor(u, "cpu"), convert.tensor(ev, "cpu"))
    ts, ttr = tstep(state, convert.hmc_tunables(tune, "cpu"), noise=tnoise)

    for c, (js, jtr) in enumerate(outs):
        np.testing.assert_allclose(ts.u[c].numpy(), np.asarray(js.u),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(ts.events[c].numpy(),
                                      np.asarray(js.events))
        assert bool(ttr.hmc.is_accepted[c]) == bool(jtr.hmc.is_accepted)
        for f in ("move_se", "move_ei", "occult_se", "occult_ei"):
            a, b = getattr(ttr, f), getattr(jtr, f)
            assert bool(a.is_accepted[c]) == bool(b.is_accepted), f
            np.testing.assert_allclose(float(a.target_log_prob[c]),
                                       float(b.target_log_prob), rtol=1e-5)
            for g in ("m", "t", "delta_t", "x_star"):
                np.testing.assert_array_equal(
                    getattr(a, g)[c].numpy(), np.asarray(getattr(b, g)))
    # the trace has the JAX layout with a leading chain dim
    jl = jax.tree.leaves(outs[0][1])
    tl = [x for x in _leaves(ttr)]
    assert [tuple(x.shape[1:]) for x in tl] == [np.shape(x) for x in jl]


def _leaves(t):
    if isinstance(t, torch.Tensor):
        yield t
    else:
        for x in t:
            yield from _leaves(x)


def test_config_checks():
    tm = tsyn.build_synthetic_model(6, 16, torch.float32, device="cpu")
    make = lambda **kw: tg.make_mcmc_step(  # noqa: E731
        tm, 2, tg.EventKernelConfig(**_cfg(**kw)))
    for bad in (dict(gamma_gibbs=True), dict(compensate_gamma0=True),
                dict(move_guided="always"), dict(fused_sweep="sometimes"),
                dict(occult_guided="yes"), dict(t_range=(0, 99))):
        with pytest.raises(ValueError):
            make(**bad)
    gen = torch.Generator().manual_seed(0)
    st = tsyn.initial_chain_state(tm, gen)
    state = tg.ChainState(st.u[None], st.events[None])
    tune = tg.HMCTunables(step_size=torch.tensor(0.005),
                          inv_mass_diag=torch.ones(st.u.shape[0]))
    for later in (dict(fused_sweep="never", compensate_gamma0=True),
                  dict(fused_sweep="never", gamma_gibbs=True),
                  dict(fused_sweep="never", num_pair_updates=1,
                       pair_compensate_gamma0=True)):
        s2, tr = make(**later)(state, tune, gen)  # builds and steps
        assert bool(torch.isfinite(s2.u).all())
        assert bool(torch.isfinite(tr.comp_ei.target_log_prob).all())
    make()  # the slices' configurations build
    make(fused_sweep="never", num_pair_updates=1, move_guided="always")
    make(num_pair_updates=1)


def _compensated_chains(C=4, M=8, T=14):
    tm = tsyn.build_synthetic_model(M, T, torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(2)
    st = tsyn.initial_chain_state(tm, gen)
    u = st.u.expand(C, -1).clone()
    u[:, :6] += 0.05 * torch.randn((C, 6), generator=gen,
                                   dtype=torch.float64)
    state = tg.ChainState(u, st.events.expand(C, -1, -1, -1).clone())
    tune = tg.HMCTunables(step_size=torch.tensor(0.001, dtype=torch.float64),
                          inv_mass_diag=torch.ones(u.shape[1],
                                                   dtype=torch.float64))
    cfg = dict(dmax=6, mmax=2, nmax=8, occult_nmax=4,
               num_event_time_updates=3, t_range=(T - 7, T),
               num_pair_updates=1, fused_sweep="never",
               compensate_gamma0=True, num_compensated_updates=2,
               pair_compensate_gamma0=True)
    return tm, state, tune, cfg


@pytest.mark.parametrize("threaded", ["always", "never"])
def test_compensated_step_keeps_logp_consistent(threaded):
    """tests/test_inference.py's production check of the compensated
    moves, 4 chains batched, float64: with two compensated moves and the
    compensated pair move in each multiscan the moves accept, gamma0
    moves, and the threaded logp after the last sweep equals the joint
    density of the final state (rtol 1e-8, atol 1e-6): the live-rate
    refresh, the u[:, 3] write-back and the windowed I->R/gamma0 deltas
    end to end, with the commute threaded and recomputed."""
    tm, state, tune, cfg = _compensated_chains()
    step = tg.make_mcmc_step(tm, 4, tg.EventKernelConfig(
        **cfg, thread_commute=threaded))
    gen = torch.Generator().manual_seed(14)
    acc, pair_acc = [], []
    s = state
    for _ in range(40):
        s, tr = step(s, tune, gen)
        acc.append(tr.comp_ei.is_accepted)
        pair_acc.append(tr.pair.is_accepted)
    assert float(torch.stack(acc).double().mean()) > 0.02
    assert float(torch.stack(pair_acc).double().mean()) > 0.02
    assert bool(((s.u[:, 3] - state.u[:, 3]).abs() > 1e-6).all())
    np.testing.assert_allclose(
        tr.comp_ei.target_log_prob.numpy(),
        tm.joint_log_prob_unconstrained(s.u, s.events).numpy(),
        rtol=1e-8, atol=1e-6)


def test_gamma_refresh_changes_only_gamma():
    """tests/test_gamma_gibbs.py's integration check: from the same
    generator state, gamma_gibbs=True leaves the events and every
    parameter but u[:, 3:5] as they are without it (its draws come after
    the sweep's), accepts, and moves u[:, 3:5] where it accepts."""
    tm, state, tune, cfg = _compensated_chains()
    outs = []
    for on in (False, True):
        step = tg.make_mcmc_step(tm, 4, tg.EventKernelConfig(
            **cfg, gamma_gibbs=on))
        outs.append(step(state, tune, torch.Generator().manual_seed(9)))
    (s_off, tr_off), (s_on, tr_on) = outs
    assert torch.equal(s_off.events, s_on.events)
    assert torch.equal(s_off.u[:, :3], s_on.u[:, :3])
    assert torch.equal(s_off.u[:, 5:], s_on.u[:, 5:])
    assert not bool(tr_off.gamma.is_accepted.any())
    acc = tr_on.gamma.is_accepted
    assert bool(acc.any())
    moved = (s_on.u[:, 3:5] != s_off.u[:, 3:5]).all(-1)
    assert torch.equal(moved, acc)
    assert bool(torch.isfinite(tr_on.gamma.log_accept_ratio).all())


def test_chain_state_and_step_on_cpu():
    tm = tsyn.build_synthetic_model(6, 16, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    st = tsyn.initial_chain_state(tm, gen)
    state = tg.ChainState(st.u.expand(2, -1), st.events.expand(2, -1, -1, -1))
    step = tg.make_mcmc_step(tm, 2, tg.EventKernelConfig(**_cfg()))
    tune = tg.HMCTunables(step_size=torch.tensor(0.005),
                          inv_mass_diag=torch.ones(st.u.shape[0]))
    s2, tr = step(state, tune, gen)
    assert s2.events.shape == (2, 6, 16, 3) and s2.u.shape == state.u.shape
    assert bool((s2.events >= 0).all())
    assert torch.isfinite(tr.occult_ei.target_log_prob).all()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        "import covid19uk_tpu_torch, covid19uk_tpu_torch.convert\n"
        "import covid19uk_tpu_torch.inference.gibbs\n"
        "import covid19uk_tpu_torch.inference.gamma_gibbs\n"
        "import covid19uk_tpu_torch.models.gp\n"
        "import covid19uk_tpu_torch.inference.event_kernels\n"
        "import covid19uk_tpu_torch.inference.likelihood\n"
        "import covid19uk_tpu_torch.ops._build\n"
        "import covid19uk_tpu_torch.ops.banded\n"
        "import covid19uk_tpu_torch.ops.block_sparse\n"
        "import covid19uk_tpu_torch.utils.synthetic\n"
        "import covid19uk_tpu_torch.config\n"
        "import covid19uk_tpu_torch.inference.dual_averaging\n"
        "import covid19uk_tpu_torch.inference.welford\n"
        "import covid19uk_tpu_torch.inference.warmup\n"
        "import covid19uk_tpu_torch.inference.driver\n"
        "import covid19uk_tpu_torch.inference.inference\n"
        "import covid19uk_tpu_torch.parallel.diagnostics\n"
        "import covid19uk_tpu_torch.parallel.distributed\n"
        "import covid19uk_tpu_torch.parallel.dryrun\n"
        "import covid19uk_tpu_torch.parallel.mesh\n"
        "import covid19uk_tpu_torch.parallel.sharding\n"
        "import covid19uk_tpu_torch.utils.nans\n"
        "import covid19uk_tpu_torch.version\n"
        "import covid19uk_tpu_torch.utils.checkpoint\n"
        "import covid19uk_tpu_torch.utils.impute\n"
        "import covid19uk_tpu_torch.utils.logging\n"
        "import covid19uk_tpu_torch.utils.ncio\n"
        "import covid19uk_tpu_torch.utils.store\n"
        "import covid19uk_tpu_torch.models.ngm\n"
        "import covid19uk_tpu_torch.posterior.thin\n"
        "import covid19uk_tpu_torch.posterior.predict\n"
        "import covid19uk_tpu_torch.posterior.reproduction_number\n"
        "import covid19uk_tpu_torch.posterior.within_between\n"
        "import covid19uk_tpu_torch.utils.diagnostics\n"
        "import covid19uk_tpu_torch.utils.settings\n"
        "import covid19uk_tpu_torch.data\n"
        "import covid19uk_tpu_torch.data.assemble\n"
        "import covid19uk_tpu_torch.data.tiers\n"
        "import covid19uk_tpu_torch.data.util\n"
        "import covid19uk_tpu_torch.utils.hdf5_plain\n"
        "import bench_torch\n"
        "import bench_mixing_torch\n"
        "from covid19uk_tpu_torch.utils.synthetic import "
        "build_synthetic_model\n"
        "m = build_synthetic_model(150, 8, sparse=True, device='cpu')\n"
        "assert m.data.Cstar_bsr is not None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'covid19uk_tpu' or m.startswith('covid19uk_tpu.')]\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_rehearsal_on_cpu():
    """The chip smoke script's CPU rehearsal runs the slices, the driver
    phases, the posterior verbs, the two-rank phases (the space axis
    with the off-default kernels among them) and the ESS/sec entry points
    at a tiny size and, having no card, exits non-zero without a result
    line."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rehearse"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 3, out.stderr
    assert "phase 3 slice" in out.stdout
    assert "phase 6 driver on the CPU" in out.stdout
    assert "phase 7 driver on the CPU" in out.stdout
    assert "phase 8 posterior verbs on the CPU" in out.stdout
    for part in ("9a", "9b", "9c"):
        assert f"phase {part} " in out.stdout and f"phase {part} done" in \
            out.stdout
    # phase 10 on two CPU ranks
    for line in ("phase 10a dry run over 2 ranks", "phase 10b sharded",
                 "phase 10c rank 0 on cpu", "phase 10c rank 1 on cpu",
                 "phase 10b-c on the CPU", "phase 10d debug_nans"):
        assert line in out.stdout, line
    # phase 11, the space axis, on two CPU ranks
    for line in ("phase 11a sharded transition over a 1 x 2",
                 "phase 11b driver over a 1 x 2", "phase 11c MSOA M=256",
                 "not a multiple of 2): the operator stays whole",
                 "phase 11 on the CPU"):
        assert line in out.stdout, line
    # phase 12, the off-default kernels over the space axis, on the same
    # two CPU ranks
    for line in ("phase 12a off-default transition over a 1 x 2",
                 "bitwise equal on the ranks of every space group: True",
                 "phase 12b off-default driver over a 1 x 2",
                 "phase 12c MSOA off-default transition",
                 "phase 12 on the CPU: every check held"):
        assert line in out.stdout, line
    # phase 13, the ESS/sec entry points (bench_torch, bench_mixing_torch)
    for line in ("phase 13a bench_torch synthetic UK on the CPU: "
                 '{"metric": "ess_per_sec_fulluk"',
                 "phase 13b bench_torch real UK data on the CPU: "
                 '{"metric": "ess_per_sec_fulluk_real"',
                 "phase 13c bench_mixing_torch",
                 "phase 13 on the CPU: every check held"):
        assert line in out.stdout, line
    assert '"ok"' not in out.stdout
