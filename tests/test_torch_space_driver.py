"""The port's space axis over two gloo ranks on the CPU: the location axis
of the events sharded over a space group of two (``space_devices=2``, one
chain slice).  The sharded transition equals the one-process transition
on the same ``StepNoise``; ``mcmc`` with ``use_mesh`` stores what a
one-process run stores (the JAX package's ``tests/test_mesh_driver.py``
cases), dense and with the block-sparse operator on each rank's band of
block rows, and with the off-default event kernels (the gamma0-
compensated moves and the gamma refresh); both ranks end every window
with the same u.  The sharded step with the off-default kernels reads the
refresh's sums over all M locations on every rank, and its refresh,
replayed with JAX's draws, is the JAX package's.  The two-rank runs come
from one spawn (``tests/torch_ranks.py``, scenario ``space``).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import gamma_gibbs as jgg
from covid19uk_tpu_torch.inference import driver as tdriver
from covid19uk_tpu_torch.inference import gamma_gibbs as tgg
from covid19uk_tpu_torch.inference import gibbs as tgibbs
from tests import torch_ranks
from tests.test_driver import make_synthetic_datafile
from tests.test_torch_gamma_gibbs import _jax_noise

RUNS = {"dense": (4, {}), "sparse": (256, dict(sparse="always")),
        "off_default": (4, torch_ranks.OFF_DEFAULT)}


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


def _results(path):
    """``{name: (shape, dtype)}`` of every dataset under ``results/``."""
    out = {}
    with h5py.File(path, "r") as f:
        f["results"].visititems(
            lambda name, obj: out.__setitem__(name, (obj.shape, obj.dtype))
            if isinstance(obj, h5py.Dataset) else None)
    return out


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
    a rank), and dense with the off-default event kernels: psi and
    gamma0 within rtol 1e-8 of the one-process store, the events equal,
    the results (the refresh's and the compensated moves' among them) of
    the one-process store's shapes and dtypes; every window's u bitwise
    equal on both ranks; the block-sparse run's commute is K2's band
    product on each rank.  The dense two-rank runs have ``debug_nans``
    on, their ranks agreeing on every transition's check."""
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
    results = _results(tmp / f"{name}.h5")
    assert results == _results(one)
    if name == "off_default":
        with h5py.File(tmp / f"{name}.h5", "r") as f:
            assert 0.0 < f["results/gamma/is_accepted"][()].mean() <= 1.0
        assert "move/E->I_compensated/proposed_delta" in results
    sums = [out[f"{name}_sums"] for out in outs]
    assert len(sums[0]) == 4  # three windows and a burst
    np.testing.assert_array_equal(sums[0], sums[1])
    transitions = 4 + 4 + 4 + 5
    calls = [int(out[f"{name}_band_calls"]) for out in outs]
    assert calls == ([transitions] * 2 if name == "sparse" else [0, 0])


def test_space_sharded_refresh_reads_whole_sums_and_matches_jax(ranks):
    """The sharded step with the off-default kernels (compensated move and
    pair move, gamma refresh) on the same StepNoise and generator seed as
    one process: both ranks end it with the same u and events, bitwise,
    and the gathered events are the one-process step's; each rank's
    refresh reads K_t and N_t summed over all M locations (the one-process
    step's, not its band's) and ends with its u[:, 3:5].  Fed those
    inputs with JAX's draws replayed, the refresh on both ranks equals the
    JAX package's gamma_gibbs_step within 1e-10 (float64)."""
    _, outs = ranks
    model, state, tune, noise, _ = torch_ranks.step_case()
    calls = []
    original = torch_ranks.record_refresh(calls)
    try:
        want, _ = tgibbs.make_mcmc_step(
            model, 3, torch_ranks.off_default_step_config())(
            state, tune, torch.Generator().manual_seed(
                torch_ranks.OFF_DEFAULT_SEED),
            noise._replace(tbl=None, ttbl=None))
    finally:
        tgibbs.gamma_gibbs_step = original
    (g1, k1, n1, wd1, _, _), = calls
    half = torch_ranks.STEP_M // 2
    for key in ("off_u", "off_events", "off_g", "off_k", "off_n",
                "off_g_new"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key],
                                      err_msg=key)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["off_events"], want.events.numpy())
        np.testing.assert_array_equal(
            out["off_band"], want.events.numpy()[:, r * half:(r + 1) * half])
        np.testing.assert_allclose(out["off_u"], want.u.numpy(), rtol=1e-10,
                                   atol=1e-12)
        # the sums over all M locations, not over the rank's band
        np.testing.assert_array_equal(out["off_k"], k1.numpy())
        np.testing.assert_array_equal(out["off_n"], n1.numpy())
        np.testing.assert_array_equal(
            out["off_k"], out["off_events"][..., 2].sum(1))
        assert not np.array_equal(out["off_k"],
                                  out["off_band"][..., 2].sum(1))
        np.testing.assert_allclose(out["off_g"], g1.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_array_equal(out["off_wd"], wd1.numpy())
        np.testing.assert_array_equal(out["off_g_new"], out["off_u"][:, 3:5])
    assert not np.array_equal(want.events.numpy(), state.events.numpy())

    C = torch_ranks.STEP_C
    keys = jax.random.split(jax.random.PRNGKey(13), C)
    normal, chi2, uniform = jax.vmap(_jax_noise)(keys)
    jnoise = tgg.GammaNoise(*[torch.tensor(np.asarray(a))
                              for a in (normal, chi2, uniform)])
    jstep = jax.jit(jax.vmap(jgg.gamma_gibbs_step,
                             in_axes=(0, 0, 0, 0, None)))
    for out in outs:
        g_j, info_j = jstep(keys, jnp.asarray(out["off_g"]), out["off_k"],
                            out["off_n"], out["off_wd"])
        g_t, info_t = tgg.gamma_gibbs_step(
            None, *[torch.tensor(out[k]) for k in
                    ("off_g", "off_k", "off_n", "off_wd")], noise=jnoise)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_array_equal(info_t.is_accepted.numpy(),
                                      np.asarray(info_j.is_accepted))
        # the rank's own refresh: its draws replayed give its output
        mine = tgg.GammaNoise(*[torch.tensor(out[f"off_noise_{k}"])
                                for k in tgg.GammaNoise._fields])
        g_r, _ = tgg.gamma_gibbs_step(
            None, *[torch.tensor(out[k]) for k in
                    ("off_g", "off_k", "off_n", "off_wd")], noise=mine)
        np.testing.assert_array_equal(g_r.numpy(), out["off_g_new"])
