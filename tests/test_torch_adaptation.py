"""Port parity for warmup adaptation: dual averaging, Welford, the
regularized mass, pooled adaptation, and one slow warmup window replayed
with the JAX package's random draws (fused sweep, M=10, T=16, C=2).
Tolerances: rtol 1e-12 in float64, 1e-6 in float32; the replayed window's
events, proposals and accept flags identical, its u and adaptation state
rtol 1e-9 (atol 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import dual_averaging as jda
from covid19uk_tpu.inference import gibbs as jg
from covid19uk_tpu.inference import warmup as jw
from covid19uk_tpu.inference import welford as jwf
from covid19uk_tpu.inference.driver import pool_adaptation as j_pool
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.inference import dual_averaging as tda
from covid19uk_tpu_torch.inference import gibbs as tg
from covid19uk_tpu_torch.inference import warmup as tw
from covid19uk_tpu_torch.inference import welford as twf
from covid19uk_tpu_torch.inference.driver import pool_adaptation as t_pool
from tests.test_torch_step import L, M, T, _cfg, _jax_noise

C, P = 3, 7
TOL = {"float64": 1e-12, "float32": 1e-6}


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _jax_batched(fn, *args):
    """``fn`` vmapped over the chain axis (the JAX driver's use)."""
    return jax.vmap(fn)(*args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dual_averaging_matches_jax(dtype):
    rng = np.random.default_rng(0)
    init = rng.uniform(0.01, 0.5, C).astype(dtype)
    probs = rng.uniform(0.0, 1.0, (12, C)).astype(dtype)
    jst = _jax_batched(lambda s: jda.init(s, getattr(jnp, dtype)),
                       jnp.asarray(init))
    tst = tda.init(torch.as_tensor(init))
    for p in probs:
        jst = _jax_batched(jda.update, jst, jnp.asarray(p))
        tst = tda.update(tst, torch.as_tensor(p))
        for a, b in zip(tst, jst):
            assert a.dtype == getattr(torch, dtype)
            _close(a, b, TOL[dtype])
    _close(tda.step_size(tst), jda.step_size(jst), TOL[dtype])
    _close(tda.averaged_step_size(tst), jda.averaged_step_size(jst),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_welford_and_pooling_match_jax(dtype):
    rng = np.random.default_rng(1)
    draws = rng.normal(0.3, 2.0, (9, C, P)).astype(dtype)  # draw-major
    tol = TOL[dtype]
    jdt = getattr(jnp, dtype)

    # update, one draw at a time, then variance and the regularized mass
    jst = _jax_batched(lambda _: jwf.init((P,), jdt), jnp.arange(C))
    tst = twf.init((C, P), getattr(torch, dtype), "cpu")
    for x in draws:
        jst = _jax_batched(jwf.update, jst, jnp.asarray(x))
        tst = twf.update(tst, torch.as_tensor(x))
    for a, b in zip(tst, jst):
        _close(a, b, tol)
    _close(twf.variance(tst), _jax_batched(jwf.variance, jst), tol)
    _close(twf.variance(tst, ddof=1.0),
           _jax_batched(lambda s: jwf.variance(s, 1.0), jst), tol)
    _close(tw.regularized_variance(tst),
           _jax_batched(jw.regularized_variance, jst), tol)

    # from_draws: chain-major in JAX, draw-major in the port
    jfd = _jax_batched(jwf.from_draws, jnp.asarray(np.swapaxes(draws, 0, 1)))
    tfd = twf.from_draws(torch.as_tensor(draws))
    for a, b in zip(tfd, jfd):
        _close(a, b, tol)

    # from_stats with per-chain counts
    n = np.array([3.0, 4.0, 5.0], dtype)
    mean, var = draws[0], np.abs(draws[1])
    jfs = _jax_batched(jwf.from_stats, jnp.asarray(n), jnp.asarray(mean),
                       jnp.asarray(var))
    tfs = twf.from_stats(torch.as_tensor(n), torch.as_tensor(mean),
                         torch.as_tensor(var))
    for a, b in zip(tfs, jfs):
        _close(a, b, tol)

    # pooled adaptation of the window's accumulators
    steps = rng.uniform(0.01, 0.3, C).astype(dtype)
    js, jp = j_pool(jnp.asarray(steps), jfd)
    ts, tp = t_pool(torch.as_tensor(steps), tfd)
    _close(ts, js, tol)
    for a, b in zip(tp, jp):
        assert tuple(a.shape) == tuple(np.shape(b))
        _close(a, b, tol)


def test_slow_window_replays_jax():
    """One slow window of 3 draws through the port's window runner against
    JAX's ``make_window_runner``, each chain's draws replayed from JAX's
    keys as ``tests/test_torch_step.py`` replays one transition."""
    n = 3
    jm = jsyn.build_synthetic_model(M, T, jnp.float64)
    st = jsyn.initial_chain_state(jm)
    u0 = np.stack([np.asarray(st.u), np.asarray(st.u) + 0.03])
    ev0 = np.stack([np.asarray(st.events)] * 2)
    Pm = u0.shape[1]
    rng = np.random.default_rng(2)
    wf_mean = u0 + rng.normal(0.0, 0.01, u0.shape)
    wf_var = rng.uniform(5e-5, 2e-4, u0.shape)
    steps = np.array([0.05, 0.08])

    jstep = jg.make_mcmc_step(jm, L, jg.EventKernelConfig(**_cfg()))
    jrun = jax.jit(jw.make_window_runner(jstep, n, adapt_mass=True))
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    jout = []
    for c in range(2):
        da = jda.init(steps[c], jnp.float64)
        wf = jwf.from_stats(5.0, jnp.asarray(wf_mean[c]),
                            jnp.asarray(wf_var[c]))
        jout.append(jrun(keys[c], jg.ChainState(jnp.asarray(u0[c]),
                                                jnp.asarray(ev0[c])),
                         da, wf, jw.regularized_variance(wf)))
    # each draw's noise: the JAX runner splits each chain's key n ways
    draw_keys = [jax.random.split(k, n) for k in keys]
    noise = []
    for i in range(n):
        per_chain = [_jax_noise(draw_keys[c][i], Pm) for c in range(2)]
        noise.append(tg.StepNoise(*[
            convert.tensor(np.stack([np.asarray(pc[j]) for pc in per_chain]),
                           "cpu") for j in range(4)]))

    tm = convert.model(jm, "cpu")
    tstep = tg.make_mcmc_step(tm, L, tg.EventKernelConfig(**_cfg()))
    trun = tw.make_window_runner(tstep, n, adapt_mass=True)
    twf_ = twf.from_stats(5.0, torch.as_tensor(wf_mean),
                          torch.as_tensor(wf_var))
    state, da, wf, inv_mass, draws, traces = trun(
        tg.ChainState(torch.as_tensor(u0), torch.as_tensor(ev0)),
        tda.init(torch.as_tensor(steps)), twf_, tw.regularized_variance(twf_),
        noise=noise)

    assert tuple(draws.u.shape) == (n, 2, Pm)
    assert tuple(draws.events.shape) == (n, 2, M, T, 3)
    assert tuple(traces.hmc.step_size.shape) == (n, 2)
    rtol, atol = 1e-9, 1e-12
    accepted = []
    for c, (js, jda_, jwf_, jim, jdraws, jtr) in enumerate(jout):
        np.testing.assert_array_equal(draws.events[:, c].numpy(),
                                      np.asarray(jdraws.events))
        np.testing.assert_array_equal(state.events[c].numpy(),
                                      np.asarray(js.events))
        _close(draws.u[:, c], jdraws.u, rtol, atol)
        _close(state.u[c], js.u, rtol, atol)
        for a, b in zip(da, jda_):
            _close(a[c], b, rtol, atol)
        for a, b in zip(wf, jwf_):
            _close(a[c], b, rtol, atol)
        _close(inv_mass[c], jim, rtol, atol)
        _close(traces.hmc.step_size[:, c], jtr.hmc.step_size, rtol, atol)
        np.testing.assert_array_equal(traces.hmc.is_accepted[:, c].numpy(),
                                      np.asarray(jtr.hmc.is_accepted))
        accepted.append(np.asarray(jtr.hmc.is_accepted))
        for f in ("move_se", "move_ei", "occult_se", "occult_ei"):
            a, b = getattr(traces, f), getattr(jtr, f)
            np.testing.assert_array_equal(a.is_accepted[:, c].numpy(),
                                          np.asarray(b.is_accepted))
            for g in ("m", "t", "delta_t", "x_star"):
                np.testing.assert_array_equal(
                    getattr(a, g)[:, c].numpy(), np.asarray(getattr(b, g)))
    # the window exercised both outcomes of HMC
    accepted = np.concatenate(accepted)
    assert accepted.any() and not accepted.all()
