"""Port parity for the whole sampling transition (HMC + fused sweep)
against JAX make_mcmc_step(fused_sweep="always", num_pair_updates=0), the
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
    for later in (dict(fused_sweep="never", compensate_gamma0=True),
                  dict(fused_sweep="never", gamma_gibbs=True),
                  dict(fused_sweep="never", num_pair_updates=1,
                       pair_compensate_gamma0=True)):
        with pytest.raises(NotImplementedError):
            make(**later)
    make()  # the slices' configurations build
    make(fused_sweep="never", num_pair_updates=1, move_guided="always")
    make(num_pair_updates=1)


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
        "import covid19uk_tpu_torch.inference.event_kernels\n"
        "import covid19uk_tpu_torch.inference.likelihood\n"
        "import covid19uk_tpu_torch.ops._build\n"
        "import covid19uk_tpu_torch.ops.banded\n"
        "import covid19uk_tpu_torch.ops.block_sparse\n"
        "import covid19uk_tpu_torch.utils.synthetic\n"
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
    """The chip smoke script's CPU rehearsal runs the slice at a tiny size
    and, having no card, exits non-zero without a result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rehearse"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 3, out.stderr
    assert "phase 3 slice" in out.stdout
    assert '"ok"' not in out.stdout
