"""Port parity for the GP regression conditional against the JAX package
at float64: mean and covariance (rtol 1e-10), log_prob (rtol 1e-10),
noiseless interpolation, sample moments, both kernels, a prior mean
function and scalar index points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.models import gp as jgp
from covid19uk_tpu_torch.models import gp as tgp

X = np.linspace(0.0, 4.0, 5)[:, None]


def _pair(kernel, noise, mean_fn=None, index_points=X):
    """The same prior in both packages."""
    jmean = tmean = None
    if mean_fn is not None:
        jmean = lambda x: mean_fn(jnp, x)  # noqa: E731
        tmean = lambda x: mean_fn(torch, x)  # noqa: E731
    jk = getattr(jgp, kernel)(amplitude=1.3, length_scale=0.8)
    tk = getattr(tgp, kernel)(amplitude=1.3, length_scale=0.8)
    return (jgp.GaussianProcess(jk, jnp.asarray(index_points), noise, jmean),
            tgp.GaussianProcess(tk, torch.tensor(index_points), noise, tmean))


@pytest.mark.parametrize("kernel", ["rbf_kernel", "matern32_kernel"])
@pytest.mark.parametrize("noise,pred_noise", [(0.1, None), (0.05, 0.0),
                                              (0.0, 0.2)])
@pytest.mark.parametrize("with_mean", [False, True])
def test_conditional_matches_jax(kernel, noise, pred_noise, with_mean):
    rng = np.random.default_rng(1)
    mean_fn = ((lambda xp, x: 0.3 * x[:, 0] - 0.1) if with_mean else None)
    jprior, tprior = _pair(kernel, noise, mean_fn)
    y = rng.normal(size=5)
    xs = np.linspace(-0.7, 4.9, 7)[:, None]
    want = jgp.conditional_gp(jprior, jnp.asarray(y), jnp.asarray(xs),
                              pred_noise)
    got = tgp.conditional_gp(tprior, torch.tensor(y), torch.tensor(xs),
                             pred_noise)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.covariance.numpy(),
                               np.asarray(want.covariance), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got.stddev().numpy(),
                               np.asarray(want.stddev()), rtol=1e-10,
                               atol=1e-12)
    probe = rng.normal(size=(3, 7))
    np.testing.assert_allclose(
        got.log_prob(torch.tensor(probe)).numpy(),
        [float(want.log_prob(jnp.asarray(p))) for p in probe], rtol=1e-10)


def test_scalar_index_points_and_noiseless_interpolation():
    """A plain (N,) vector is N scalar points; with no noise the posterior
    passes through the observations."""
    jprior, tprior = _pair("rbf_kernel", 0.0, index_points=X[:, 0])
    y = np.sin(X[:, 0])
    got = tgp.conditional_gp(tprior, torch.tensor(y), torch.tensor(X[:, 0]),
                             predictive_noise_variance=0.0)
    want = jgp.conditional_gp(jprior, jnp.asarray(y), jnp.asarray(X[:, 0]),
                              predictive_noise_variance=0.0)
    assert got.mean.shape == (5,) and got.covariance.shape == (5, 5)
    np.testing.assert_allclose(got.mean.numpy(), y, atol=1e-6)
    np.testing.assert_allclose(got.stddev().numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-10, atol=1e-12)


def test_sample_moments():
    _, tprior = _pair("rbf_kernel", 0.05)
    post = tgp.conditional_gp(tprior, torch.zeros(5, dtype=torch.float64),
                              torch.tensor([[1.7], [3.1]]))
    gen = torch.Generator().manual_seed(0)
    draws = post.sample(gen, sample_shape=(20000,))
    assert draws.shape == (20000, 2)
    sd = post.stddev()
    se = sd / np.sqrt(20000)
    assert bool(((draws.mean(0) - post.mean).abs() < 5 * se).all())
    np.testing.assert_allclose(draws.std(0).numpy(), sd.numpy(), rtol=0.03)
    np.testing.assert_allclose(np.cov(draws.numpy().T),
                               post.covariance.numpy(), rtol=0.06,
                               atol=0.03 * float(sd.max()) ** 2)
