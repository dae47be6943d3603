"""The port's posterior verbs against the JAX package's on the CPU.

The next-generation matrix, R_it, the within/between pressures and the
offline diagnostics are deterministic: the same numpy inputs go through
both packages at float64 and must agree within rtol 1e-10.  The
R_t and within/between CLIs run on the tracked NI posterior samples
(``ni_run/thin_samples.pkl``, ``ni_run/inferencedata.h5``), and thinned
pickles must load in either package's ``predict``.
"""

import os
import pickle

import h5py
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from covid19uk_tpu.models import ngm as jngm
from covid19uk_tpu.models.spec import ModelData as JModelData
from covid19uk_tpu.posterior import predict as jpredict
from covid19uk_tpu.posterior import reproduction_number as jrn
from covid19uk_tpu.posterior import thin as jthin
from covid19uk_tpu.posterior import within_between as jwb
from covid19uk_tpu.utils import diagnostics as jdiag
from covid19uk_tpu.utils import ncio as jncio
from covid19uk_tpu_torch.models import ngm as tngm
from covid19uk_tpu_torch.models.spec import ModelData as TModelData
from covid19uk_tpu_torch.posterior import predict as tpredict
from covid19uk_tpu_torch.posterior import reproduction_number as trn
from covid19uk_tpu_torch.posterior import thin as tthin
from covid19uk_tpu_torch.posterior import within_between as twb
from covid19uk_tpu_torch.utils import diagnostics as tdiag
from covid19uk_tpu_torch.utils import ncio as tncio
from tests.test_driver import make_synthetic_datafile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NI_DATA = os.path.join(ROOT, "ni_run", "inferencedata.h5")
NI_SAMPLES = os.path.join(ROOT, "ni_run", "thin_samples.pkl")
PARAM_KEYS = ("psi", "sigma_space", "beta_area", "gamma0", "gamma1",
              "alpha_0", "alpha_t", "spatial_effect")


def _covariates(rng, M, T):
    C = rng.uniform(0, 100, size=(M, M))
    adjacency = np.zeros((M, M))
    for i in range(M - 1):
        adjacency[i, i + 1] = adjacency[i + 1, i] = 1.0
    return dict(
        C=C, W=rng.uniform(0.5, 1.5, T), N=rng.uniform(5e4, 5e5, size=M),
        adjacency=adjacency, weekday=(np.arange(T) % 7 < 5).astype(float),
        area=rng.uniform(1e8, 5e9, size=M),
    )


def _both_data(covariates, keep_C=False):
    return (JModelData.create(covariates, jnp.float64, sparse=False,
                              keep_C=keep_C),
            TModelData.create(covariates, torch.float64, sparse=False,
                              keep_C=keep_C, device="cpu"))


def _ni_samples(n):
    with open(NI_SAMPLES, "rb") as f:
        samples = pickle.load(f)
    init = samples.pop("initial_state")
    return {k: v[:n] for k, v in samples.items()}, init


@pytest.mark.parametrize("day", ["0", "1", "T-2", "T+3"])
def test_ngm_matches_jax(rng, day):
    """The NGM of each of 3 samples at M=6 equals JAX's at float64, as a
    block of one day and inside a block of three; t=0 reads alpha_0,
    1 <= t <= T-2 the walk one day ahead of the rate function, t >= T-1
    its end."""
    M, T, S = 6, 9, 3
    t = {"0": 0, "1": 1, "T-2": T - 2, "T+3": T + 3}[day]
    jdata, tdata = _both_data(_covariates(rng, M, T))
    p = {k: rng.normal(0, 0.3, (S,)) for k in PARAM_KEYS[:6]}
    p["psi"], p["sigma_space"] = np.abs(p["psi"]), np.abs(p["sigma_space"])
    p["alpha_0"] = p["alpha_0"] - 3.0
    p["alpha_t"] = rng.normal(0, 0.05, (S, T - 1))
    p["spatial_effect"] = rng.normal(0, 0.3, (S, M))
    state = np.stack([rng.uniform(1e4, 5e4, (S, M)),
                      rng.uniform(0, 50, (S, M)),
                      rng.uniform(0, 50, (S, M)), rng.uniform(0, 9, (S, M))],
                     -1)
    want = np.stack([
        np.asarray(jngm.next_generation_matrix_fn(
            jdata, jpredict._params_from_samples(p, i, jnp.float64))(
                t, jnp.asarray(state[i])))
        for i in range(S)])
    params = tpredict._params_from_samples(p, dtype=torch.float64)
    fn = tngm.next_generation_matrix_fn(tdata, params)
    got = fn(torch.tensor([t]), torch.as_tensor(state)[:, None])
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-10, atol=0)
    # the same day inside a block of days
    days = torch.tensor([t, 2, t])
    block = fn(days, torch.as_tensor(state)[:, None].expand(S, 3, M, 4))
    np.testing.assert_allclose(block[:, 0].numpy(), want, rtol=1e-10, atol=0)
    np.testing.assert_allclose(block[:, 2].numpy(), want, rtol=1e-10, atol=0)


def test_calc_posterior_rit_matches_jax():
    """R_it of 8 NI posterior samples over all 32 days at float64."""
    samples, init = _ni_samples(8)
    cov = jncio.load_group(NI_DATA, "constant_data").variables
    jdata, tdata = _both_data(cov)
    times = np.arange(samples["seir"].shape[-2])
    want = np.asarray(jrn.calc_posterior_rit(samples, init, times, jdata,
                                             dtype=jnp.float64))
    got = trn.calc_posterior_rit(samples, init, times, tdata,
                                 dtype=torch.float64)
    assert got.shape == (8, 32, 11)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


def test_calc_pressure_components_matches_jax(rng):
    M, T, S = 6, 10, 40
    jdata, tdata = _both_data(_covariates(rng, M, T), keep_C=True)
    psi = rng.uniform(0.1, 1.0, S)
    state = np.stack([rng.uniform(100, 200, (S, M)),
                      rng.uniform(5, 20, (S, M)), rng.uniform(5, 50, (S, M)),
                      rng.uniform(0, 10, (S, M))], -1)
    want = jwb.calc_pressure_components(jdata, jnp.asarray(psi),
                                        jnp.asarray(state))
    got = twb.calc_pressure_components(tdata, torch.as_tensor(psi),
                                       torch.as_tensor(state))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=0)


def _invalid_occult_case(rng, M=4, T=12):
    """Events and an occult tensor whose implied state goes negative."""
    init = np.stack([np.full(M, 60.0), np.full(M, 4.0), np.full(M, 3.0),
                     np.zeros(M)], -1)
    events = np.zeros((M, T, 3))
    events[:, 2:9, 0] = rng.integers(0, 3, (M, 7))
    events[:, 4:11, 1] = rng.integers(0, 2, (M, 7))
    events[:, 5:12, 2] = rng.integers(0, 2, (M, 7))
    occults = np.zeros((M, T, 3))
    occults[:, 6:, 1] = rng.integers(2, 6, (M, T - 6))
    occults[:, 7:, 2] = rng.integers(1, 5, (M, T - 7))
    return events, occults, init


def _posterior_file(path, rng, n=7, shape=(4, 10)):
    """A small posterior HDF5 with the datasets jump_summary reads."""
    M, T = shape
    with h5py.File(path, "w") as f:
        f["samples/seir"] = rng.integers(0, 6, (n, M, T, 3)).astype(float)
        for key in ("move/S->E", "move/E->I"):
            f[f"results/{key}/is_accepted"] = rng.uniform(size=n) < 0.5
            delta = rng.integers(0, 4, (n, 4, 2)).astype(float)
            delta[rng.uniform(size=n) < 0.4, 3, :] = 0.0  # null moves
            f[f"results/{key}/proposed_delta"] = delta


@pytest.mark.parametrize("helper", [
    "squared_jumping_distance", "p_null", "jump_summary", "mean_sojourn",
    "regularize_occults"])
def test_offline_diagnostics_match_jax(rng, tmp_path, helper):
    if helper == "squared_jumping_distance":
        chain = rng.integers(0, 9, (30, 5, 12)).astype(float)
        got, want = [m.squared_jumping_distance(chain) for m in (tdiag, jdiag)]
    elif helper == "p_null":
        acc = rng.uniform(size=50) < 0.6
        x_star = rng.integers(0, 3, (50, 2)) * (rng.uniform(size=(50, 1))
                                                < 0.5)
        got, want = [m.p_null(acc, x_star) for m in (tdiag, jdiag)]
        assert np.isnan(tdiag.p_null(np.zeros(5, bool), x_star[:5]))
    elif helper == "jump_summary":
        path = str(tmp_path / "posterior.h5")
        _posterior_file(path, rng)
        got, want = [m.jump_summary(path) for m in (tdiag, jdiag)]
        assert got.keys() == want.keys() == {"S->E", "E->I"}
        got = [got[k][f] for k in sorted(got) for f in sorted(got[k])]
        want = [want[k][f] for k in sorted(want) for f in sorted(want[k])]
    elif helper == "mean_sojourn":
        ins = rng.integers(0, 9, (3, 6, 20)).astype(float)
        outs = rng.integers(1, 9, (3, 6, 20)).astype(float)
        init = rng.uniform(10, 50, (3, 6))
        got, want = [m.mean_sojourn(ins, outs, init) for m in (tdiag, jdiag)]
    else:
        events, occults, init = _invalid_occult_case(rng)
        # invalid at first: the implied state goes negative
        assert (init[:, None, :] + np.cumsum(
            (events + occults) @ tdiag.seir.STOICHIOMETRY, 1)).min() < 0
        got, want = [m.regularize_occults(events, occults, init)
                     for m in (tdiag, jdiag)]
        assert got[0].min() >= 0 and not np.array_equal(got[1], occults)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=0)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-10,
                               atol=0)


def test_reproduction_number_cli_matches_jax(tmp_path):
    """60 NI samples (two chunks of CHUNKSIZE = 50) through both CLIs at
    float32; both outputs read through both packages' ncio."""
    samples, init = _ni_samples(60)
    pkl_path = str(tmp_path / "samples.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(dict(samples, initial_state=init), f)
    jout, tout = str(tmp_path / "rt_jax.h5"), str(tmp_path / "rt_torch.h5")
    jrn.reproduction_number([NI_DATA, pkl_path], jout)
    trn.main([pkl_path, "-d", NI_DATA, "-o", tout, "--device", "cpu"])
    groups = [m.load_group(p, "posterior_predictive")
              for m in (jncio, tncio) for p in (jout, tout)]
    for g in groups:
        assert g["R_it"].shape == (60, 32, 11) and g["R_t"].shape == (60, 32)
        assert g.dims == groups[0].dims
        assert g.coords.keys() == groups[0].coords.keys()
        for k in g.coords:
            np.testing.assert_array_equal(g.coords[k], groups[0].coords[k])
    for jg, tg in [(groups[0], groups[1]), (groups[2], groups[3])]:
        assert tg["R_it"].dtype == jg["R_it"].dtype == np.float32
        assert tg["R_t"].dtype == jg["R_t"].dtype == np.float64
        for k in ("R_it", "R_t"):
            np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=0)
    with h5py.File(tout, "r") as f, h5py.File(NI_DATA, "r") as d:
        assert dict(f.attrs).keys() >= {k for k in d.attrs
                                        if not k.startswith("_NC")}


def test_within_between_csv_matches_jax(tmp_path):
    """The CSV of 200 NI samples at float64 (the port on the CPU)."""
    samples, init = _ni_samples(200)
    pkl_path = str(tmp_path / "samples.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(dict(samples, initial_state=init), f)
    jcsv, tcsv = str(tmp_path / "wb_jax.csv"), str(tmp_path / "wb_torch.csv")
    jwb.within_between([NI_DATA, pkl_path], jcsv)
    twb.main(["-d", NI_DATA, "-s", pkl_path, "-o", tcsv, "--device", "cpu"])
    want, got = pd.read_csv(jcsv), pd.read_csv(tcsv)
    assert list(got.columns) == list(want.columns) == [
        "location", "within_mean", "between_mean", "p_within_gt_between"]
    assert list(got["location"]) == list(want["location"])
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(),
                               want.iloc[:, 1:].to_numpy(), rtol=1e-10,
                               atol=0)


def _write_posterior(path, rng, n, chains, M, T):
    """A posterior HDF5 in the store's layout with valid (zero) events."""
    lead = (n,) + ((chains,) if chains else ())
    with h5py.File(path, "w") as f:
        for k in PARAM_KEYS[:6]:
            f[f"samples/{k}"] = rng.uniform(0.05, 0.5, lead)
        f["samples/alpha_0"][...] = -rng.uniform(2.0, 3.0, lead)
        f["samples/alpha_t"] = rng.normal(0, 0.005, lead + (T - 1,))
        f["samples/spatial_effect"] = rng.normal(0, 0.3, lead + (M,))
        f["samples/seir"] = np.zeros(lead + (M, T, 3))
        f["initial_state"] = np.stack(
            [np.full(M, 9e4), np.full(M, 50.0), np.full(M, 80.0),
             np.zeros(M)], -1)


@pytest.mark.parametrize("chains", [0, 3])
def test_thin_posterior_matches_jax_and_pickles_cross(tmp_path, rng, chains):
    """Thinned dicts are equal (the chain axis folded into the draws), and
    each package's pickle predicts through the other's ``predict``."""
    M, T = 4, 25
    post = str(tmp_path / "posterior.h5")
    _write_posterior(post, rng, 12, chains, M, T)
    data = str(tmp_path / "data.h5")
    make_synthetic_datafile(data, rng, M=M, T0=T)
    cfg = dict(start=2, end=11, by=3)
    jpkl, tpkl = str(tmp_path / "jax.pkl"), str(tmp_path / "torch.pkl")
    want = jthin.thin_posterior(post, jpkl, cfg)
    got = tthin.thin_posterior(post, tpkl, cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert type(got[k]) is np.ndarray and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["seir"].shape == (3 * max(chains, 1), M, T, 3)
    # the port's pickle in the JAX predict, the JAX pickle in the port's
    _, ev_j = jpredict.predict(data, tpkl, str(tmp_path / "pj.h5"), -4, 3)
    _, ev_t = tpredict.predict(data, jpkl, str(tmp_path / "pt.h5"), -4, 3,
                               device="cpu")
    assert ev_t.shape == np.asarray(ev_j).shape == (3 * max(chains, 1), M,
                                                    3, 3)
    # the same predictions group: variables, dims, coords
    want, got = [jncio.load_group(str(tmp_path / f), "predictions")
                 for f in ("pj.h5", "pt.h5")]
    assert got.dims == want.dims and got.coords.keys() == want.coords.keys()
    for k in want.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
    for k in want.variables:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["initial_state"],
                                  want["initial_state"])
