"""The MSOA-path transition of the port on the CPU at a small size: the
unfused sweep with pair moves through the block-sparse commute and the
banded CAR prior (forced with sparse=True at M=150, T=12).

Tolerances: the threaded logp against a full recomputation rtol 1e-9 in
float64 (f32 fused sweep: rtol 1e-5, its logp comes back rounded to
float32); the HMC half against the JAX package rtol 1e-9 (positions) as
tests/test_torch_hmc.py holds the dense model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import hmc as jhmc
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.inference import gibbs as tg
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.utils import synthetic as tsyn

M, T = 150, 12


def _cfg(**kw):
    base = dict(dmax=5, mmax=2, nmax=10, occult_nmax=5,
                num_event_time_updates=3, t_range=(T - 6, T),
                num_pair_updates=1)
    base.update(kw)
    return tg.EventKernelConfig(**base)


def _chains(dtype, C, seed=0):
    model = tsyn.build_synthetic_model(M, T, dtype, sparse=True,
                                       device="cpu")
    gen = torch.Generator().manual_seed(seed)
    st = tsyn.initial_chain_state(model, gen)
    state = tg.ChainState(st.u.expand(C, -1).clone(),
                          st.events.expand(C, -1, -1, -1).clone())
    tune = tg.HMCTunables(step_size=torch.tensor(0.005, dtype=dtype),
                          inv_mass_diag=torch.ones(st.u.shape[0],
                                                   dtype=dtype))
    return model, state, tune, gen


def test_sparse_unfused_transition_runs():
    model, state, tune, gen = _chains(torch.float32, C=2)
    assert model.data.Cstar_bsr is not None
    assert model.data.car_band is not None
    step = tg.make_mcmc_step(model, 4, _cfg())
    for _ in range(2):
        state, tr = step(state, tune, gen)
    ev = state.events
    assert bool(torch.isfinite(tr.pair.target_log_prob).all())
    assert bool(torch.isfinite(state.u).all())
    assert bool((ev >= 0).all()) and bool((ev == torch.round(ev)).all())
    assert bool((seir.compute_state(model.initial_state, ev) >= 0).all())
    assert tr.pair.m.shape == (2, 1) and tr.move_se.m.shape == (2, 2)
    assert tr.occult_ei.m.shape == (2,)


@pytest.mark.parametrize("fused", [False, True])
def test_threaded_logp_matches_full_recompute(fused):
    """The logp carried through the sweep (pairs last) equals the joint
    density recomputed at the new state."""
    model, state, tune, gen = _chains(torch.float64, C=3, seed=2)
    step = tg.make_mcmc_step(
        model, 4, _cfg(thread_commute=True,
                       fused_sweep="always" if fused else "never"))
    for _ in range(2):
        state, tr = step(state, tune, gen)
    full = model.joint_log_prob_unconstrained(state.u, state.events)
    np.testing.assert_allclose(tr.pair.target_log_prob.numpy(),
                               full.numpy(), rtol=1e-5 if fused else 1e-9)


def test_threading_parity():
    """Commute threaded or recomputed through the block-sparse operator:
    identical chains from identical draws."""
    outs = []
    for threaded in (True, False):
        model, state, tune, gen = _chains(torch.float64, C=2, seed=3)
        step = tg.make_mcmc_step(model, 4, _cfg(thread_commute=threaded))
        for _ in range(3):
            state, tr = step(state, tune, gen)
        outs.append((state, tr))
    (s1, t1), (s2, t2) = outs
    assert torch.equal(s1.events, s2.events)
    np.testing.assert_allclose(s1.u.numpy(), s2.u.numpy(), rtol=1e-12)
    np.testing.assert_allclose(t1.pair.target_log_prob.numpy(),
                               t2.pair.target_log_prob.numpy(), rtol=1e-9)


def test_event_sweep_keeps_commute_and_state_consistent():
    model, state, tune, gen = _chains(torch.float64, C=2, seed=4)
    step = tg.make_mcmc_step(model, 2, _cfg(thread_commute=True))
    state, _ = step(state, tune, gen)
    cfg = tg.resolve_event_config(_cfg(thread_commute=True), M)
    from covid19uk_tpu_torch.inference.likelihood import make_context
    from covid19uk_tpu_torch.models.spec import (constrain_parameters,
                                                 unpack_parameters)

    params = unpack_parameters(constrain_parameters(state.u), T, M)
    st = seir.compute_state(model.initial_state, state.events)
    cm = model.commute_pressure(st[..., 2])
    lp = model.joint_log_prob_unconstrained(state.u, state.events)
    res = tg.event_sweep(model, cfg, make_context(model, params),
                         state.events, st, cm, lp, tune, gen)
    torch.testing.assert_close(
        res.state, seir.compute_state(model.initial_state, res.events))
    torch.testing.assert_close(
        res.commute, model.commute_pressure(res.state[..., 2]),
        rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        res.logp.numpy(),
        model.joint_log_prob_unconstrained(state.u, res.events).numpy(),
        rtol=1e-9)


def test_hmc_half_matches_jax():
    """The step's HMC on the sparse model, fed the JAX package's momentum
    and accept uniform, reaches JAX's hmc_step endpoint on the JAX sparse
    model (block-sparse commute, banded CAR prior)."""
    jm = jsyn.build_synthetic_model(M, T, jnp.float64, sparse=True)
    st = jsyn.initial_chain_state(jm)
    events = np.asarray(st.events)
    rng = np.random.default_rng(5)
    C, L, step_size = 2, 4, 0.01
    u0 = np.asarray(st.u)[None] + rng.normal(0, 0.01, (C, st.u.shape[0]))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    logdens = jax.jit(lambda u: jm.joint_log_prob_unconstrained(u, events))
    want, z, u_acc = [], [], []
    for c, key in enumerate(keys):
        k_mom, k_acc = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(k_mom, u0.shape[1:],
                                              jnp.float64)))
        u_acc.append(float(jax.random.uniform(k_acc, (), jnp.float64)))
        want.append(jhmc.hmc_step(key, jnp.asarray(u0[c]), logdens,
                                  step_size, L,
                                  jnp.ones(u0.shape[1], jnp.float64)))

    tm = convert.model(jm, "cpu")
    assert tm.data.Cstar_bsr is not None and tm.data.car_band is not None
    step = tg.make_mcmc_step(tm, L, _cfg(num_pair_updates=0,
                                         num_event_time_updates=1))
    tune = tg.HMCTunables(step_size=torch.tensor(step_size,
                                                 dtype=torch.float64),
                          inv_mass_diag=torch.ones(u0.shape[1],
                                                   dtype=torch.float64))
    state = tg.ChainState(torch.tensor(u0),
                          torch.tensor(events).expand(C, -1, -1, -1))
    noise = tg.StepNoise(z=torch.tensor(np.stack(z)),
                         u_accept=torch.tensor(u_acc))
    got, tr = step(state, tune, torch.Generator().manual_seed(0),
                   noise=noise)
    for c, (qj, ij) in enumerate(want):
        np.testing.assert_allclose(got.u[c].numpy(), np.asarray(qj),
                                   rtol=1e-9, atol=1e-12)
        assert bool(tr.hmc.is_accepted[c]) == bool(ij.is_accepted)
        np.testing.assert_allclose(float(tr.hmc.target_log_prob[c]),
                                   float(ij.target_log_prob), rtol=1e-9)
