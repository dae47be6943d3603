"""Port parity for the gamma Gibbs refresh (Laplace independence MH of
(gamma0, gamma1) given the events) against the JAX package.

Tolerances: the conditional's value, gradient, Hessian and Newton mode in
float64 at rtol 1e-10; a step fed JAX's draws (its normals, chi2 and
uniform from the same split keys) gives the same accept flags and
``g_new`` and the log ratio at rtol 1e-10; the batched chains' moments
against 2-D quadrature of the conditional within 6 standard errors
(mean), 15% (variances) and 0.1 (correlation), the bounds of the JAX
package's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import gamma_gibbs as jgg
from covid19uk_tpu_torch.inference import gamma_gibbs as tgg
from tests.test_gamma_gibbs import _quadrature_moments, _stats


def _batch(seeds, T=14, zero_days=()):
    """``[C, T]`` removals and exposures, one seed a chain, the first
    ``zero_days[c]`` days of chain c without removals; the shared
    weekday covariate of the first seed."""
    stats = [_stats(T, s) for s in seeds]
    K = np.stack([np.asarray(k) for k, _, _ in stats])
    N = np.stack([np.asarray(n) for _, n, _ in stats])
    for c, z in enumerate(zero_days):
        K[c, :z] = 0.0
    return K, N, np.asarray(stats[0][2])


# starts: near the mode, an off-mode start, and the far starts of the
# JAX package's convergence test
STARTS = np.array([[-1.5, 0.1], [0.5, -0.5], [5.0, 3.0], [-8.0, 0.0]])


def test_conditional_and_newton_mode_match_jax():
    K, N, wd = _batch([0, 3, 4, 4], zero_days=(0, 0, 5, 14))
    g = torch.tensor(STARTS)
    Kt, Nt, wdt = map(torch.tensor, (K, N, wd))
    jf = jax.vmap(jgg._f_grad_hess, in_axes=(0, 0, 0, None))
    jm = jax.vmap(jgg._newton_mode, in_axes=(0, 0, 0, None))
    for got, want in zip(tgg._f_grad_hess(g, Kt, Nt, wdt),
                         jf(jnp.asarray(STARTS), K, N, wd)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10)
    mode = tgg._newton_mode(g, Kt, Nt, wdt)
    np.testing.assert_allclose(mode.numpy(),
                               np.asarray(jm(jnp.asarray(STARTS), K, N, wd)),
                               rtol=1e-10)


def _jax_noise(key):
    """The draws of one JAX step, split as gamma_gibbs.py splits them."""
    k_prop, k_chi, k_acc = jax.random.split(key, 3)
    return (jax.random.normal(k_prop, (2,), jnp.float64),
            2.0 * jax.random.gamma(k_chi, jgg._T_DF / 2.0, (), jnp.float64),
            jax.random.uniform(k_acc, (), jnp.float64))


def test_step_replays_jax_draws():
    """40 chains (four data sets, ten starts each) through 3 steps."""
    K, N, wd = _batch([0, 3, 4, 4], zero_days=(0, 0, 5, 14))
    rng = np.random.default_rng(0)
    C = 40
    K, N = np.repeat(K, 10, 0), np.repeat(N, 10, 0)
    g = np.concatenate([STARTS, rng.normal([-1.5, 0.0], [2.0, 1.0],
                                           (C - 4, 2))])
    jstep = jax.jit(jax.vmap(jgg.gamma_gibbs_step,
                             in_axes=(0, 0, 0, 0, None)))
    tg = torch.tensor(g)
    accepted = 0
    for key in jax.random.split(jax.random.PRNGKey(5), 3):
        keys = jax.random.split(key, C)
        normal, chi2, uniform = jax.vmap(_jax_noise)(keys)
        noise = tgg.GammaNoise(*map(lambda a: torch.tensor(np.asarray(a)),
                                    (normal, chi2, uniform)))
        g_j, info_j = jstep(keys, jnp.asarray(g), K, N, wd)
        tg, info_t = tgg.gamma_gibbs_step(None, tg, torch.tensor(K),
                                          torch.tensor(N), torch.tensor(wd),
                                          noise=noise)
        np.testing.assert_array_equal(info_t.is_accepted.numpy(),
                                      np.asarray(info_j.is_accepted))
        np.testing.assert_allclose(info_t.log_accept_ratio.numpy(),
                                   np.asarray(info_j.log_accept_ratio),
                                   rtol=1e-10)
        np.testing.assert_allclose(tg.numpy(), np.asarray(g_j), rtol=1e-10)
        g = np.asarray(g_j)
        accepted += int(info_t.is_accepted.sum())
    assert bool(torch.isfinite(tg).all())
    assert 0 < accepted < 3 * C  # both branches of the decision ran


@pytest.mark.parametrize("start", [0, 1, 2, 3],
                         ids=["near", "off-mode", "far-right", "far-left"])
def test_batched_chains_match_quadrature(start):
    """4,000 chains from one start, 40 steps each: the last step's draws
    against 2-D quadrature of the conditional (the independence sampler
    forgets its start within a few accepts)."""
    K, N, wd = _stats(seed=3 if start >= 2 else 0)
    mean_q, cov_q = _quadrature_moments(K, N, wd)
    C = 4000
    Kt = torch.tensor(np.asarray(K)).expand(C, -1)
    Nt = torch.tensor(np.asarray(N)).expand(C, -1)
    wdt = torch.tensor(np.asarray(wd))
    g = torch.tensor(STARTS[start]).expand(C, 2)
    gen = torch.Generator().manual_seed(start)
    acc = []
    for _ in range(40):
        g, info = tgg.gamma_gibbs_step(gen, g, Kt, Nt, wdt)
        acc.append(info.is_accepted.double().mean())
    draws = g.numpy()
    # the JAX package's bound: the t tails cost ~0.13 acceptance
    assert float(torch.stack(acc[10:]).mean()) > 0.80
    se = np.sqrt(np.diag(cov_q) / C)
    assert np.all(np.abs(draws.mean(0) - mean_q) < 6 * se), (
        draws.mean(0), mean_q, se)
    cov_e = np.cov(draws.T)
    np.testing.assert_allclose(np.diag(cov_e), np.diag(cov_q), rtol=0.15)
    corr_q = cov_q[0, 1] / np.sqrt(cov_q[0, 0] * cov_q[1, 1])
    corr_e = cov_e[0, 1] / np.sqrt(cov_e[0, 0] * cov_e[1, 1])
    assert abs(corr_e - corr_q) < 0.1, (corr_e, corr_q)


def test_draws_come_from_the_generator():
    """chi2(5) as five squared normals: its mean and variance, and the
    same generator state gives the same step."""
    g = torch.zeros((20000, 2), dtype=torch.float64)
    noise = tgg.draw_noise(torch.Generator().manual_seed(0), g)
    assert noise.normal.shape == (20000, 2) and noise.chi2.shape == (20000,)
    assert abs(float(noise.chi2.mean()) - 5.0) < 0.1
    assert abs(float(noise.chi2.var()) - 10.0) < 0.5
    assert float(noise.uniform.min()) >= 0.0
    K, N, wd = map(lambda a: torch.tensor(np.asarray(a)), _stats())
    a = tgg.gamma_gibbs_step(torch.Generator().manual_seed(1), g[:3],
                             K.expand(3, -1), N.expand(3, -1), wd)
    b = tgg.gamma_gibbs_step(torch.Generator().manual_seed(1), g[:3],
                             K.expand(3, -1), N.expand(3, -1), wd)
    assert torch.equal(a[0], b[0])
