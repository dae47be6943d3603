"""The port's prediction against the JAX package's on the CPU.

The deterministic parts (each sample's state at ``init_step`` and the
out-of-sample re-basing of alpha_0) equal JAX's at float64.  The
simulation itself draws from another generator, so it is held in
distribution: per (sample, location, transition) mean events over 1000
replicates of each of two samples in each package agree within 5
standard errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.models import spec as jspec
from covid19uk_tpu.posterior import predict as jpredict
from covid19uk_tpu_torch.models import spec as tspec
from covid19uk_tpu_torch.posterior import predict as tpredict
from tests.test_spec import make_test_data

M, T = 4, 20


def _covariates(rng):
    C = rng.uniform(0, 100, size=(M, M))
    adjacency = np.zeros((M, M))
    for i in range(M - 1):
        adjacency[i, i + 1] = adjacency[i + 1, i] = 1.0
    return dict(C=C, W=np.ones(T), N=rng.uniform(5e4, 5e5, size=M),
                adjacency=adjacency,
                weekday=(np.arange(T) % 7 < 5).astype(float),
                area=rng.uniform(1e8, 5e9, size=M))


def _samples(rng, covariates, S, trend=0.0):
    """S posterior-like samples: per-sample scalars and walks, events a
    valid counting process with a trend in S->E."""
    N = covariates["N"]
    init = np.stack([N - 600, np.full(M, 250.0), np.full(M, 350.0),
                     np.zeros(M)], -1)
    se = rng.integers(20, 60, (S, M, T)).astype(float)
    ei = np.minimum(se, rng.integers(10, 40, (S, M, T))).astype(float)
    ir = np.minimum(ei, rng.integers(10, 40, (S, M, T))).astype(float)
    return dict(
        psi=rng.uniform(0.2, 0.4, S), sigma_space=rng.uniform(0.02, 0.1, S),
        beta_area=rng.normal(0.1, 0.02, S), gamma0=rng.normal(-1.0, 0.1, S),
        gamma1=rng.normal(0.05, 0.01, S), alpha_0=rng.normal(-2.5, 0.1, S),
        alpha_t=trend + rng.normal(0, 0.005, (S, T - 1)),
        spatial_effect=rng.normal(0, 0.3, (S, M)),
        seir=np.stack([se, ei, ir], -1),
    ), init


@pytest.mark.parametrize("init_step", [0, 10, T - 1])
def test_deterministic_parts_match_jax(rng, monkeypatch, init_step):
    """``new_init_state`` and the alpha_0 that out-of-sample prediction
    simulates with equal JAX's at float64.  Both packages' ``sample_seir``
    is replaced by one that returns the parameters' alpha_0, so the
    re-based value comes out where the events would."""
    cov = _covariates(rng)
    samples, init = _samples(rng, cov, S=5, trend=0.05)
    jdata = jspec.ModelData.create(cov, jnp.float64, sparse=False)
    tdata = tspec.ModelData.create(cov, torch.float64, sparse=False,
                                   device="cpu")
    n = 3
    monkeypatch.setattr(jspec.CovidUK, "sample_seir", lambda self, key, p:
                        jnp.broadcast_to(p.alpha_0, (M, n, 3)))
    monkeypatch.setattr(tspec.CovidUK, "sample_seir", lambda self, gen, p:
                        p.alpha_0[:, None, None, None].expand(-1, M, n, 3))
    for oos in (False, True):
        j_init, j_a0 = jpredict.predicted_incidence(
            dict(samples), init, jdata, init_step, n, out_of_sample=oos,
            dtype=jnp.float64)
        t_init, t_a0 = tpredict.predicted_incidence(
            dict(samples), init, tdata, init_step, n, out_of_sample=oos,
            dtype=torch.float64)
        np.testing.assert_allclose(t_init.numpy(), np.asarray(j_init),
                                   rtol=1e-10, atol=0)
        np.testing.assert_allclose(t_a0.numpy(), np.asarray(j_a0),
                                   rtol=1e-10, atol=0)
    walk = samples["alpha_0"][:, None] + np.cumsum(samples["alpha_t"], -1)
    want = walk[:, init_step - 1] if init_step > 0 else samples["alpha_0"]
    np.testing.assert_allclose(t_a0[:, 0, 0, 0].numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("oos", [False, True], ids=["in", "out"])
def test_prediction_matches_jax_in_distribution(rng, oos):
    """At M=4 over 7 days, 1000 replicates of each of two posterior
    samples whose states differ sharply (the second's S->E events ten
    times the first's), interleaved, in each package: the mean events per
    (sample, location, transition), summed over the window, agree within
    5 standard errors of their difference."""
    R, n, init_step = 1000, 7, 12
    cov = _covariates(rng)
    two, init = _samples(rng, cov, S=2)
    two["seir"][1, ..., 0] *= 10.0
    samples = {k: np.tile(v, (R,) + (1,) * (v.ndim - 1))
               for k, v in two.items()}  # sample order 0, 1, 0, 1, ...
    jdata = jspec.ModelData.create(cov, jnp.float32, sparse=False)
    tdata = tspec.ModelData.create(cov, torch.float32, sparse=False,
                                   device="cpu")
    _, j_ev = jpredict.predicted_incidence(
        dict(samples), init, jdata, init_step, n, out_of_sample=oos, seed=3)
    _, t_ev = tpredict.predicted_incidence(
        dict(samples), init, tdata, init_step, n, out_of_sample=oos, seed=3)
    assert t_ev.shape == (2 * R, M, n, 3)
    # [R, 2, M, 3]: replicate, sample, location, transition
    j_tot = np.asarray(j_ev, np.float64).sum(-2).reshape(R, 2, M, 3)
    t_tot = t_ev.double().numpy().sum(-2).reshape(R, 2, M, 3)
    assert (t_tot > 0).all(), "a transition never fired: a vacuous test"
    se_ = np.sqrt(j_tot.var(0, ddof=1) / R + t_tot.var(0, ddof=1) / R)
    z = np.abs(j_tot.mean(0) - t_tot.mean(0)) / se_
    assert z.max() < 5.0, z
    # the two samples' predictions tell apart: the test can see a mix-up
    se_01 = np.sqrt(t_tot[:, 0].var(0, ddof=1) / R
                    + t_tot[:, 1].var(0, ddof=1) / R)
    assert (np.abs(t_tot[:, 1].mean(0) - t_tot[:, 0].mean(0))
            / se_01)[:, 0].min() > 10.0


@pytest.mark.parametrize("oos", [False, True], ids=["in", "out"])
def test_each_sample_simulates_from_its_own_state(rng, oos):
    """Three samples, the first without exposed or infectious people from
    day 1: it draws no event at all, while the other two draw S->E events,
    so no other sample's state reaches its simulation."""
    cov = _covariates(rng)
    samples, init = _samples(rng, cov, S=3)
    quiet = np.zeros((M, T, 3))
    quiet[:, 0, 1] = init[:, 1]  # every E -> I on day 0
    quiet[:, 0, 2] = init[:, 1] + init[:, 2]  # and every I -> R
    samples["seir"][0] = quiet
    data = tspec.ModelData.create(cov, torch.float32, sparse=False,
                                  device="cpu")
    new_init, ev = tpredict.predicted_incidence(
        samples, init, data, 12, 7, out_of_sample=oos, seed=5)
    assert (new_init[0, :, 1:3] == 0).all()
    assert bool((ev[0] == 0).all())
    assert bool((ev[1:, ..., 0].sum(-1) > 0).all())


def test_sample_prior_alpha_t_moments():
    """0.005 * N(0, 1) over the prediction window's T-1 increments, on the
    generator's device and in the dtype asked for."""
    data = tspec.ModelData.create(_covariates(np.random.default_rng(0)),
                                  torch.float64, sparse=False, device="cpu")
    model = tspec.CovidUK(data, torch.zeros(M, 4, dtype=torch.float64), 5, 7)
    gen = torch.Generator().manual_seed(0)
    one = model.sample_prior_alpha_t(gen, torch.float64)
    assert one.shape == (6,) and one.dtype == torch.float64
    draws = model.sample_prior_alpha_t(gen, torch.float64,
                                       batch_shape=(20000,)).numpy()
    assert draws.shape == (20000, 6)
    n = draws.size
    assert abs(draws.mean()) < 5 * 0.005 / np.sqrt(n)
    # the variance's standard error is sigma^2 sqrt(2 / (n - 1))
    assert abs(draws.var() / 0.005**2 - 1.0) < 5 * np.sqrt(2.0 / (n - 1))
    corr = np.corrcoef(draws[:, 0], draws[:, 1])[0, 1]
    assert abs(corr) < 5 / np.sqrt(20000)


def test_oos_alpha_walk_at_positive_init_step_matches_jax(rng):
    """Out of sample from init_step > 0 the rate function reads a fresh
    prediction-window walk at clipped absolute time, in both packages:
    for init_step >= num_steps - 1 every day reads the walk's endpoint
    (a reference quirk, kept)."""
    data = make_test_data(rng, 3, 30, jnp.float64)
    init = np.stack([np.asarray(data.N) - 30, np.full(3, 10.0),
                     np.full(3, 20.0), np.zeros(3)], -1)
    for init_step, horizon in [(3, 8), (10, 8), (25, 5)]:
        model = tspec.CovidUK(None, torch.as_tensor(init), init_step,
                              horizon)
        fresh = model.sample_prior_alpha_t(
            torch.Generator().manual_seed(7), torch.float64)
        assert fresh.shape == (horizon - 1,)
        alpha_0 = torch.tensor(-1.3, dtype=torch.float64)
        t_abs = init_step + torch.arange(horizon)
        got = tspec._alpha_timeseries(alpha_0, fresh, t_abs).numpy()
        want = np.asarray(jspec._alpha_timeseries(
            jnp.float64(-1.3), jnp.asarray(fresh.numpy()),
            jnp.asarray(t_abs.numpy())))
        np.testing.assert_allclose(got, want, rtol=1e-12)
        b = -1.3 + np.cumsum(fresh.numpy())
        if init_step >= horizon - 1:
            np.testing.assert_allclose(got, b[-1])
