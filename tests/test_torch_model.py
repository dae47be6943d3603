"""Port parity for the model: ModelData, the joint log-density and its
gradient, and the reduced HMC likelihood, against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.models import spec as jspec
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.models import seir as tseir
from covid19uk_tpu_torch.models import spec as tspec
from covid19uk_tpu_torch.utils import synthetic as tsyn


def _covariates(rng, M=6, T=12):
    C = rng.uniform(0, 100, size=(M, M))
    adjacency = (rng.uniform(size=(M, M)) < 0.4).astype(float)
    adjacency = np.maximum(adjacency, adjacency.T)
    np.fill_diagonal(adjacency, 0)
    for i in range(M):
        if adjacency[i].sum() == 0:
            j = (i + 1) % M
            adjacency[i, j] = adjacency[j, i] = 1.0
    return dict(C=C, W=np.ones(T), N=rng.uniform(5e4, 5e5, size=M),
                adjacency=adjacency,
                weekday=(np.arange(T) % 7 < 5).astype(float),
                area=rng.uniform(1e8, 5e9, size=M))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_model_data_create_arrays_equal(dtype):
    cov = _covariates(np.random.default_rng(0))
    jd = jspec.ModelData.create(cov, getattr(jnp, dtype), sparse=False)
    td = tspec.ModelData.create(cov, getattr(torch, dtype), sparse=False,
                                device="cpu")
    for f in tspec.ModelData._fields[:8]:
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    assert td.Cstar_bsr is None and td.car_band is None
    # "auto" (the default) builds no sparse operator below M = 1024
    auto = tspec.ModelData.create(cov, torch.float64, device="cpu")
    assert auto.Cstar_bsr is None and auto.car_band is None


def test_synthetic_covariates_equal():
    jm = jsyn.build_synthetic_model(9, 14, jnp.float64)
    tm = tsyn.build_synthetic_model(9, 14, torch.float64, device="cpu")
    for f in tspec.ModelData._fields[:8]:
        np.testing.assert_array_equal(getattr(tm.data, f).numpy(),
                                      np.asarray(getattr(jm.data, f)))
    assert tm.data.Cstar_bsr is None and jm.data.Cstar_bsr is None
    np.testing.assert_array_equal(tm.initial_state.numpy(),
                                  np.asarray(jm.initial_state))
    jp = jsyn.initial_chain_state(jm).u
    tp = tspec.unconstrain_parameters(tspec.pack_parameters(
        tsyn.initial_parameters(tm)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-14)


def _jax_case(M, T):
    jm = jsyn.build_synthetic_model(M, T, jnp.float64)
    st = jsyn.initial_chain_state(jm)
    rng = np.random.default_rng(2)
    u = np.asarray(st.u) + rng.normal(0, 0.05, st.u.shape)
    return jm, u, np.asarray(st.events)


def _value_and_grad_t(fn, u):
    u = torch.tensor(u, requires_grad=True)
    v = fn(u)
    (g,) = torch.autograd.grad(v.sum(), u)
    return v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("M,T", [(7, 15), (380, 120)])
def test_joint_log_prob_value_and_grad_match_jax(M, T):
    jm, u, events = _jax_case(M, T)
    vj, gj = jax.jit(jax.value_and_grad(jm.joint_log_prob_unconstrained))(
        jnp.asarray(u), jnp.asarray(events))
    tm = convert.model(jm, "cpu")
    ev = torch.tensor(events)
    vt, gt = _value_and_grad_t(
        lambda x: tm.joint_log_prob_unconstrained(x, ev), u)
    np.testing.assert_allclose(vt, np.asarray(vj), rtol=1e-10)
    np.testing.assert_allclose(gt, np.asarray(gj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(gj)).max())


def test_reduced_loglik_equals_full_log_prob_batched():
    """The HMC density (prior + reduced likelihood + Jacobian) equals the
    full joint density in value and gradient, for a chain batch."""
    jm, u, events = _jax_case(8, 16)
    tm = convert.model(jm, "cpu")
    C = 3
    rng = np.random.default_rng(4)
    us = u[None] + rng.normal(0, 0.02, (C,) + u.shape)
    ev = torch.tensor(np.stack([events] * C))
    st = tseir.compute_state(tm.initial_state, ev)
    cm = tm.commute_pressure(st[..., 2])
    loglik = tm.reduced_loglik_fn(ev, st, cm)

    def reduced(x):
        p = tspec.unpack_parameters(tspec.constrain_parameters(x), 16, 8)
        return (tm.log_prior(p) + loglik(p)
                + tspec.constrain_log_det_jacobian(x))

    vr, gr = _value_and_grad_t(reduced, us)
    vf, gf = _value_and_grad_t(
        lambda x: tm.joint_log_prob_unconstrained(x, ev), us)
    assert vr.shape == (C,)
    np.testing.assert_allclose(vr, vf, rtol=1e-10)
    np.testing.assert_allclose(gr, gf, rtol=1e-8, atol=1e-8)
    # each chain's gradient is its own: chain 0 alone gives the same
    v0, g0 = _value_and_grad_t(
        lambda x: tm.joint_log_prob_unconstrained(x, ev[:1]), us[:1])
    np.testing.assert_allclose(g0[0], gf[0], rtol=1e-12)


def test_bijector_roundtrip_and_jacobian_match_jax():
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(0.01, 3.0, 2), rng.normal(size=9)])
    u_j = np.asarray(jspec.unconstrain_parameters(jnp.asarray(x)))
    u_t = tspec.unconstrain_parameters(torch.tensor(x))
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=1e-12)
    np.testing.assert_allclose(
        tspec.constrain_parameters(u_t).numpy(), x, rtol=1e-12)
    np.testing.assert_allclose(
        tspec.constrain_log_det_jacobian(u_t).numpy(),
        np.asarray(jspec.constrain_log_det_jacobian(jnp.asarray(u_j))),
        rtol=1e-12)


def test_sample_seir_gives_valid_events():
    tm = tsyn.build_synthetic_model(6, 20, torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    p = tsyn.initial_parameters(tm)
    batched = tspec.Parameters(*[a.expand((4,) + a.shape) for a in p])
    ev = tm.sample_seir(gen, batched)
    assert ev.shape == (4, 6, 20, 3)
    st = tseir.compute_state(tm.initial_state, ev)
    assert bool((ev >= 0).all()) and bool((st >= 0).all())
    assert torch.isfinite(tm.log_prob(batched, ev)).all()


@pytest.mark.parametrize("stoich", ["default", "reversed"])
def test_transition_source_counts_and_stoichiometry_match_jax(stoich):
    """transition_source_counts, compute_state and the log-density with
    the default and with a caller's stoichiometry, against JAX."""
    from covid19uk_tpu.models import seir as jseir

    rng = np.random.default_rng(7)
    S = None if stoich == "default" else np.array(
        [[0, 0, -1, 1], [0, 1, -1, 0], [1, -1, 0, 0]], np.float32)
    init = rng.integers(50, 200, (2, 5, 4)).astype(np.float64)
    ev = rng.integers(0, 4, (2, 5, 9, 3)).astype(np.float64)
    rates = rng.uniform(0.01, 0.5, (2, 5, 9, 3))
    got = tseir.transition_source_counts(torch.tensor(init),
                                         torch.tensor(ev), S)
    want = jseir.transition_source_counts(init, ev, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tseir.compute_state(torch.tensor(init), torch.tensor(ev), S).numpy(),
        np.asarray(jseir.compute_state(init, ev, S)))
    np.testing.assert_allclose(
        tseir.chain_binomial_log_prob(torch.tensor(ev), torch.tensor(rates),
                                      torch.tensor(init), S).numpy(),
        np.asarray(jseir.chain_binomial_log_prob(ev, rates, init, S)),
        rtol=1e-12)
    # the JAX package's top-level names, the model API among them
    import covid19uk_tpu
    import covid19uk_tpu_torch

    missing = [n for n in covid19uk_tpu.__all__ if n != "__version__"
               and not hasattr(covid19uk_tpu_torch, n)]
    assert missing == []
