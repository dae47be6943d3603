"""Port parity: binomial pmf forms, compute_state / chain-binomial log-prob
and the fused sweep's in-kernel numerics, covid19uk_tpu_torch against the
JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.models import seir as jseir
from covid19uk_tpu.ops import binomial as jbin
from covid19uk_tpu.ops.pallas import fused_sweep as jfs
from covid19uk_tpu_torch.models import seir as tseir
from covid19uk_tpu_torch.ops import binomial as tbin
from covid19uk_tpu_torch.ops import fused_sweep as tfs

# f64: the same formulas, so only the last bits differ.  f32: the two
# frameworks' lgamma/log/exp differ by an ulp or so; atol covers values
# near zero (log C(n, 0) = 0).
TOL = {np.float64: dict(rtol=1e-12, atol=0.0),
       np.float32: dict(rtol=1e-5, atol=1e-5)}
JDT = {np.float64: jnp.float64, np.float32: jnp.float32}
TDT = {np.float64: torch.float64, np.float32: torch.float32}


def _counts(rng):
    n = np.concatenate(
        [rng.integers(0, 30, 200), rng.integers(30, 2_000_000, 200)]
    ).astype(np.float64)
    k = np.minimum(rng.integers(0, 25, 400), n).astype(np.float64)
    r = 10.0 ** rng.uniform(-6, 0.8, 400)
    return n, k, r


def _both(fn_j, fn_t, dtype, *arrays):
    got_j = np.asarray(fn_j(*[jnp.asarray(a, JDT[dtype]) for a in arrays]))
    got_t = fn_t(*[torch.tensor(a, dtype=TDT[dtype]) for a in arrays])
    return got_j, got_t.numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["lgamma_diff", "log_choose",
                                  "binomial_log_pmf_from_rate"])
def test_binomial_forms_match_jax(dtype, name):
    n, k, r = _counts(np.random.default_rng(1))
    args = (n, k) if name != "binomial_log_pmf_from_rate" else (n, k, r)
    j, t = _both(getattr(jbin, name), getattr(tbin, name), dtype, *args)
    np.testing.assert_allclose(t, j, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_binomial_log_pmf_and_invalid_cells(dtype):
    n = np.array([10.0, 5.0, 3.0, -1.0, 1e6])
    k = np.array([4.0, 6.0, -1.0, 0.0, 250.0])
    log_p = np.log(np.array([0.3, 0.3, 0.3, 0.3, 1e-4]))
    log1m = np.log1p(-np.exp(log_p))
    j, t = _both(jbin.binomial_log_pmf, tbin.binomial_log_pmf, dtype,
                 n, k, log_p, log1m)
    assert np.array_equal(np.isneginf(t), np.isneginf(j))
    assert np.isneginf(t[1:4]).all()
    np.testing.assert_allclose(t[[0, 4]], j[[0, 4]], **TOL[dtype])


def _events(rng, C=2, M=4, T=9):
    init = np.array([[90.0, 4.0, 6.0, 0.0]] * M)
    ev = np.zeros((C, M, T, 3))
    state = np.broadcast_to(init, (C, M, 4)).copy()
    for t in range(T):
        y = rng.binomial(state[..., :3].astype(int), [0.05, 0.3, 0.2])
        ev[:, :, t] = y
        state += y @ jseir.STOICHIOMETRY.astype(float)
    return init, ev


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compute_state_and_log_prob_match_jax(dtype):
    rng = np.random.default_rng(5)
    init, ev = _events(rng)
    st_j, st_t = _both(jseir.compute_state, tseir.compute_state, dtype,
                       init, ev)
    np.testing.assert_array_equal(st_t, st_j)
    rates = rng.uniform(0.01, 0.5, ev.shape)
    lp_j, lp_t = _both(jseir.chain_binomial_log_prob,
                       tseir.chain_binomial_log_prob, dtype, ev, rates, init)
    np.testing.assert_allclose(lp_t, lp_j, **TOL[dtype])
    bad = ev.copy()
    bad[0, 1, 3, 1] = 1e4  # more E->I events than E: not a valid process
    lp_j, lp_t = _both(jseir.chain_binomial_log_prob,
                       tseir.chain_binomial_log_prob, dtype, bad, rates, init)
    assert np.isneginf(lp_t[0]) and np.isneginf(lp_j[0])
    np.testing.assert_allclose(lp_t[1], lp_j[1], **TOL[dtype])


# ---------------------------------------------------------------------------
# in-kernel numerics (float32, as the kernel runs them), on the cases of
# tests/test_fused_sweep.py (counts to 2e6, rates 1e-6..6)
# ---------------------------------------------------------------------------


def _f32(fn_j, fn_t, *arrays):
    return _both(fn_j, fn_t, np.float32, *arrays)


def test_inkernel_pmf_forms_match_jax():
    n, k, r = _counts(np.random.default_rng(1))
    for fj, ft, args in (
        (jfs.lgamma_diff, tfs.lgamma_diff, (n, k)),
        (jfs.lgamma1p, tfs.lgamma1p, (k,)),
        (jfs.log_pm, tfs.log_pm, (r,)),
        (jfs.binom_lp_rate, tfs.binom_lp_rate, (n, k, r)),
        (jfs.binom_lp_nu, tfs.binom_lp_nu, (n, k)),
    ):
        j, t = _f32(fj, ft, *args)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=2e-5,
                                   err_msg=fj.__name__)
    # rate_diff is a difference of terms up to ~1e5 at n ~ 2e6: an ulp of
    # the terms, not of the result, is the scale of float32 agreement
    j, t = _f32(jfs.rate_diff, tfs.rate_diff, n, k, r, r * 1.01)
    terms = np.abs(k * np.log(-np.expm1(-r))) + (n - k) * r * 0.01
    assert np.all(np.abs(t - j) <= 1e-5 * np.abs(j) + 1e-6 * terms + 2e-5)
    # and the kernel forms stay within the JAX package's own bound of the
    # exact float64 pmf
    ref = np.asarray(jbin.binomial_log_pmf_from_rate(n, k, r))
    _, t = _f32(jfs.binom_lp_rate, tfs.binom_lp_rate, n, k, r)
    assert np.all(np.abs(t - ref) <= 2e-5 * np.maximum(1.0, np.abs(ref)))


def test_inkernel_invalid_cells_are_neg_inf():
    n, y, r = [5.0, 3.0, -1.0], [6.0, -1.0, 0.0], [0.1, 0.1, 0.1]
    _, t = _f32(jfs.binom_lp_rate, tfs.binom_lp_rate, n, y, r)
    assert np.isneginf(t).all()
    _, t = _f32(jfs.binom_lp_nu, tfs.binom_lp_nu, n, y)
    assert np.isneginf(t).all()


def test_inkernel_samplers_match_jax():
    rng = np.random.default_rng(3)
    n = 2000
    u1, u2 = rng.uniform(size=n), rng.uniform(size=n)
    left = rng.integers(0, 85, n)
    right = rng.integers(0, 85, n)
    decay = rng.choice([0.5, 0.8, 0.9, 1.0], n)
    cap = rng.integers(0, 26, n).astype(np.float64)

    d_j, lm_j = jfs._two_sided_geometric(
        jnp.float32(u1), jnp.float32(u2), jnp.int32(left), jnp.int32(right),
        jnp.float32(decay))
    d_t, lm_t = tfs._two_sided_geometric(
        *[torch.tensor(a, dtype=torch.float32) for a in (u1, u2)],
        torch.tensor(left), torch.tensor(right),
        torch.tensor(decay, dtype=torch.float32))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(lm_t.numpy(), np.asarray(lm_j), rtol=1e-5,
                               atol=1e-6)

    x_j, lx_j = jfs._truncated_geometric(jnp.float32(u1), jnp.float32(cap),
                                         jnp.float32(decay))
    x_t, lx_t = tfs._truncated_geometric(
        *[torch.tensor(a, dtype=torch.float32) for a in (u1, cap, decay)])
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_allclose(lx_t.numpy(), np.asarray(lx_j), rtol=1e-5,
                               atol=1e-6)

    for fj, ft, args in (
        (jfs._log_mass_geometric, tfs._log_mass_geometric, (cap, decay)),
        (jfs._gumbel, tfs._gumbel, (u1,)),
    ):
        j, t = _f32(fj, ft, *args)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
