"""Port parity for the convergence diagnostics: split R-hat and bulk ESS
(torch, ``torch.fft``) against the JAX functions on the same seeded draws,
float64 rtol 1e-10; the host-side gate statistics against the JAX
package's numpy version, rtol 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.parallel import diagnostics as jd
from covid19uk_tpu_torch.parallel import diagnostics as td


def _draws(shape, seed):
    """Autocorrelated draws with per-chain offsets: a random walk plus
    noise, so ESS is well below the draw count and R-hat above 1."""
    rng = np.random.default_rng(seed)
    walk = 0.1 * np.cumsum(rng.normal(size=shape), axis=1)
    return walk + rng.normal(size=shape) + rng.normal(
        0.0, 0.2, shape[:1] + (1,) * (len(shape) - 1))


@pytest.mark.parametrize("shape", [(4, 200, 3), (1, 200)])
def test_rhat_and_ess_match_jax(shape):
    x = _draws(shape, seed=len(shape))
    for tfn, jfn in ((td.effective_sample_size, jd.effective_sample_size),
                     (td.potential_scale_reduction,
                      jd.potential_scale_reduction)):
        port = tfn(torch.as_tensor(x))
        ref = np.asarray(jfn(jnp.asarray(x)))
        assert port.dtype == torch.float64
        assert tuple(port.shape) == ref.shape
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-10)
    ess = td.effective_sample_size(torch.as_tensor(x)).numpy()
    assert (ess > 0).all() and (ess < x.shape[0] * x.shape[1]).all()


@pytest.mark.parametrize("shape", [(4, 60, 6), (1, 31, 6), (2, 7, 6)])
def test_gate_statistics_match_jax(shape):
    x = _draws(shape, seed=shape[1]).astype(np.float32)
    port = td.gate_statistics(x)
    ref = jd.gate_statistics(x)
    np.testing.assert_allclose(port, ref, rtol=1e-12)
    # the gate's numpy version agrees with the torch functions
    if shape[0] > 1:
        t = torch.as_tensor(x, dtype=torch.float64)
        np.testing.assert_allclose(
            port, (float(td.potential_scale_reduction(t).max()),
                   float(td.effective_sample_size(t).min())), rtol=1e-10)
