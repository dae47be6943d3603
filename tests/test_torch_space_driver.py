"""The port's space axis over two gloo ranks on the CPU: the location axis
of the events sharded over a space group of two (``space_devices=2``, one
chain slice).  The sharded transition equals the one-process transition
on the same ``StepNoise``; ``mcmc`` with ``use_mesh`` stores what a
one-process run stores (the JAX package's ``tests/test_mesh_driver.py``
cases), dense and with the block-sparse operator on each rank's band of
block rows; both ranks end every window with the same u.  The two-rank
runs come from one spawn (``tests/torch_ranks.py``, scenario ``space``).
"""

import h5py
import numpy as np
import pytest

from covid19uk_tpu_torch.inference import driver as tdriver
from tests import torch_ranks
from tests.test_driver import make_synthetic_datafile

RUNS = {"dense": (4, {}), "sparse": (256, dict(sparse="always"))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("space")
    for M in (4, 256):
        make_synthetic_datafile(str(tmp / f"data{M}.h5"),
                                np.random.default_rng(42), M=M, T0=25)
    torch_ranks.spawn("space", tmp)
    return tmp, [dict(np.load(tmp / f"space_{r}.npz")) for r in range(2)]


def _samples(path):
    with h5py.File(path, "r") as f:
        return {k: f[f"samples/{k}"][()] for k in ("psi", "gamma0", "seir")}


def test_space_sharded_step_equals_the_one_process_step(ranks):
    """Two ranks holding 5 of the 10 locations of the same 8 chains: the
    gathered events are the one-process step's, u within float64
    rounding of the summed parts, the same HMC decisions, and each rank
    keeps its band."""
    _, outs = ranks
    model, state, tune, noise, step = torch_ranks.step_case()
    want, trace = step(state, tune, None, noise)
    half = torch_ranks.STEP_M // 2
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["events"], want.events.numpy())
        np.testing.assert_array_equal(
            out["band"], want.events.numpy()[:, r * half:(r + 1) * half])
        np.testing.assert_allclose(out["u"], want.u.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_array_equal(out["accepted"],
                                      trace.hmc.is_accepted.numpy())
    np.testing.assert_array_equal(outs[0]["u"], outs[1]["u"])
    assert not np.array_equal(want.events.numpy(), state.events.numpy())
    assert trace.hmc.is_accepted.any()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_space_sharded_driver_equals_one_process(ranks, tmp_path, name):
    """The JAX package's test_space_sharding_matches_unsharded (dense, M=4)
    and test_space_sharding_keeps_block_sparse (M=256, two block rows, one
    a rank): psi and gamma0 within rtol 1e-8 of the one-process store,
    the events equal; every window's u bitwise equal on both ranks; the
    block-sparse run's commute is K2's band product on each rank.  The
    dense two-rank run has ``debug_nans`` on, its ranks agreeing on every
    transition's check."""
    tmp, outs = ranks
    M, kw = RUNS[name]
    one = str(tmp_path / "one.h5")
    tdriver.mcmc(str(tmp / f"data{M}.h5"), one,
                 torch_ranks.space_config(M, **kw), device="cpu")
    got, want = _samples(tmp / f"{name}.h5"), _samples(one)
    assert got["seir"].shape == want["seir"].shape
    assert want["seir"].shape[1:3] == (4, M)
    for k in ("psi", "gamma0"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
    np.testing.assert_array_equal(got["seir"], want["seir"])
    sums = [out[f"{name}_sums"] for out in outs]
    assert len(sums[0]) == 4  # three windows and a burst
    np.testing.assert_array_equal(sums[0], sums[1])
    transitions = 6 + 4 + 4 + 5 if name == "dense" else 4 + 4 + 4 + 5
    calls = [int(out[f"{name}_band_calls"]) for out in outs]
    assert calls == ([0, 0] if name == "dense" else [transitions] * 2)
