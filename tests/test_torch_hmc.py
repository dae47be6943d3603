"""Port parity for HMC: with the JAX package's momentum and accept uniform
(drawn from the key as inference/hmc.py draws them), the port's batched
hmc_step reaches the same endpoint and makes the same decision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import hmc as jhmc
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.inference import hmc as thmc


def _jax_noise(key, P):
    """The momentum and accept draws of jax hmc_step (hmc.py:52-88)."""
    key_mom, key_acc = jax.random.split(key)
    return (np.asarray(jax.random.normal(key_mom, (P,), jnp.float64)),
            np.asarray(jax.random.uniform(key_acc, (), jnp.float64)))


def _compare(logdens_j, logdens_t, u0, keys, step, L, inv_mass):
    outs = [jhmc.hmc_step(k, jnp.asarray(u), logdens_j, step, L,
                          jnp.asarray(inv_mass))
            for k, u in zip(keys, u0)]
    noise = [_jax_noise(k, u0.shape[1]) for k in keys]
    q, info = thmc.hmc_step(
        torch.tensor(u0), logdens_t, step, L, torch.tensor(inv_mass),
        z=torch.tensor(np.stack([z for z, _ in noise])),
        u_accept=torch.tensor(np.array([a for _, a in noise])),
    )
    for c, (qj, ij) in enumerate(outs):
        np.testing.assert_allclose(q[c].numpy(), np.asarray(qj), rtol=1e-9,
                                   atol=1e-12)
        assert bool(info.is_accepted[c]) == bool(ij.is_accepted)
        np.testing.assert_allclose(float(info.log_accept_ratio[c]),
                                   float(ij.log_accept_ratio), rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(float(info.target_log_prob[c]),
                                   float(ij.target_log_prob), rtol=1e-9)
    return info


def test_hmc_gaussian_target_matches_jax():
    rng = np.random.default_rng(0)
    P = 5
    prec = rng.uniform(0.5, 4.0, P)
    u0 = rng.normal(size=(4, P))
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    inv_mass = 1.0 / prec
    info = _compare(
        lambda u: -0.5 * jnp.sum(prec * u * u),
        lambda u: -0.5 * torch.sum(torch.tensor(prec) * u * u, dim=-1),
        u0, keys, 0.3, 7, inv_mass,
    )
    assert bool(info.is_accepted.any())


@pytest.mark.parametrize("step", [0.005, 0.2])
def test_hmc_model_density_matches_jax(step):
    """The model's joint density at a small size; the large step makes the
    reject branch run too."""
    jm = jsyn.build_synthetic_model(6, 12, jnp.float64)
    st = jsyn.initial_chain_state(jm)
    events = np.asarray(st.events)
    rng = np.random.default_rng(3)
    u0 = np.asarray(st.u)[None] + rng.normal(0, 0.02, (3, st.u.shape[0]))
    tm = convert.model(jm, "cpu")
    ev_t = torch.tensor(events)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    info = _compare(
        jax.jit(lambda u: jm.joint_log_prob_unconstrained(u, events)),
        lambda u: tm.joint_log_prob_unconstrained(u, ev_t),
        u0, keys, step, 4, np.ones(u0.shape[1]),
    )
    if step == 0.2:
        assert not bool(info.is_accepted.all())
