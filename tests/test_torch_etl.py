"""The port's ETL against the JAX package's, and the port's pipeline end
to end, on the CPU.

The test writes its own inputs for the 11 Northern Ireland LADs (the
census mobility and population files are not in the repository):
mobility (Flow, From, To), population (lad19cd plus age columns),
gov-format cases and ONS area codes.  Both packages' ``assemble_data``
run on them and must write equal groups.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from covid19uk_tpu.data.assemble import assemble_data as jassemble
from covid19uk_tpu.utils import ncio as jncio
from covid19uk_tpu_torch.data.area_code import AreaCodeData
from covid19uk_tpu_torch.data.assemble import assemble_data as tassemble
from covid19uk_tpu_torch.data.case_data import CasesData
from covid19uk_tpu_torch.utils import ncio as tncio
from tests.test_data import NI_CODES, write_area_codes_csv, write_cases_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_inputs(tmp_path, rng, days=32):
    """Mobility, population, cases and area-code CSVs; returns the
    ``ProcessData`` config section that reads them."""
    rows = [dict(Flow=int(rng.integers(0, 500)), From=a, To=b)
            for a in NI_CODES for b in NI_CODES if rng.uniform() < 0.7]
    rows.append(dict(Flow=999, From="E06000001", To=NI_CODES[0]))  # not NI
    paths = {k: str(tmp_path / f"{k}.csv")
             for k in ("mobility", "population", "cases", "codes")}
    pd.DataFrame(rows).to_csv(paths["mobility"], index=False)
    pop = pd.DataFrame({"lad19cd": NI_CODES + ["E06000001"]})
    for age in ("0-19", "20-59", "60+"):
        pop[age] = rng.integers(5000, 60000, len(pop))
    pop.to_csv(paths["population"], index=False)
    write_cases_csv(paths["cases"], rng, days=days)
    write_area_codes_csv(paths["codes"])
    return {
        "date_range": ["2021-01-01", str(np.datetime64("2021-01-01")
                                         + np.timedelta64(days, "D"))],
        "mobility_matrix": paths["mobility"],
        "population_size": paths["population"],
        "commute_volume": None,
        "CasesData": {"input": "csv", "address": paths["cases"],
                      "pillars": None, "measure": None, "format": "gov"},
        "AreaCodeData": {"input": "csv", "address": paths["codes"],
                         "format": "ons", "regions": ["N"]},
    }


def test_assemble_data_matches_jax(tmp_path, rng):
    cfg = write_inputs(tmp_path, rng)
    jout, tout = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    jassemble(jout, json.loads(json.dumps(cfg)))
    tassemble(tout, json.loads(json.dumps(cfg)))
    for group in ("constant_data", "observations"):
        for ncio in (jncio, tncio):
            want, got = ncio.load_group(jout, group), ncio.load_group(
                tout, group)
            assert got.variables.keys() == want.variables.keys()
            assert got.dims == want.dims and got.attrs == want.attrs
            assert got.coords.keys() == want.coords.keys()
            for part in ("variables", "coords"):
                for k, v in getattr(want, part).items():
                    g = getattr(got, part)[k]
                    assert g.dtype == v.dtype and g.shape == v.shape, k
                    np.testing.assert_array_equal(g, v)
    g = tncio.load_group(tout, "constant_data")
    assert g["C"].shape == (11, 11) and list(g.coords["location"]) == NI_CODES


def _mode_json_ons(tmp_path, rng):
    payload = {"features": [
        {"attributes": {"LAD19CD": "N09000001", "LAD19NM": "Antrim"}},
        {"attributes": {"LAD19CD": "N09000002", "LAD19NM": "Armagh"}},
        {"attributes": {"LAD19CD": "E09000001", "LAD19NM": "London"}},
    ]}
    path = tmp_path / "codes.json"
    path.write_text(json.dumps(payload))
    config = {"AreaCodeData": {"input": "json", "address": str(path),
                               "format": "ons", "regions": ["N"]}}
    df = AreaCodeData.process(config)
    assert list(df["lad19cd"]) == ["N09000001", "N09000002"]
    assert config["lad19cds"] == ["N09000001", "N09000002"]


def _mode_merging_dedup(tmp_path, rng):
    payload = {"features": [
        {"attributes": {"LAD19CD": "E09000001", "LAD19NM": "City"}},
        {"attributes": {"LAD19CD": "E09000033", "LAD19NM": "Westminster"}},
        {"attributes": {"LAD19CD": "E06000001", "LAD19NM": "Hartlepool"}},
    ]}
    path = tmp_path / "codes.json"
    path.write_text(json.dumps(payload))
    config = {"AreaCodeData": {"input": "json", "address": str(path),
                               "format": "ons", "regions": ["E"]}}
    df = AreaCodeData.process(config)
    assert list(df["lad19cd"]) == ["E09000001,E09000033", "E06000001"]


def _mode_cases_fill_zero(tmp_path, rng):
    rows = [dict(areaCode="N09000001", date="2021-01-01",
                 newCasesBySpecimenDate=5),
            dict(areaCode="N09000001", date="2021-01-03",
                 newCasesBySpecimenDate=7)]
    path = tmp_path / "cases.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    config = {"date_range": ["2021-01-01", "2021-01-04"],
              "lad19cds": ["N09000001", "N09000002"],
              "CasesData": {"input": "csv", "address": str(path),
                            "pillars": None, "measure": None,
                            "format": "gov"}}
    arr = CasesData.process(config).unstack(level="time").to_numpy()
    np.testing.assert_array_equal(arr[0], [5.0, 0.0, 7.0])
    np.testing.assert_array_equal(arr[1], [0.0, 0.0, 0.0])


def _mode_unknown_raises(tmp_path, rng):
    with pytest.raises(NotImplementedError):
        AreaCodeData.get({"AreaCodeData": {"input": "carrier-pigeon"}})
    with pytest.raises(NotImplementedError):
        CasesData.get({"CasesData": {"input": "carrier-pigeon"}})


@pytest.mark.parametrize("mode", [_mode_json_ons, _mode_merging_dedup,
                                  _mode_cases_fill_zero,
                                  _mode_unknown_raises],
                         ids=lambda f: f.__name__[len("_mode_"):])
def test_area_code_and_case_modes(tmp_path, rng, mode):
    """The input modes of ``tests/test_area_code_modes.py``, on the port:
    ONS JSON with a region filter, LAD merging, gov cases reindexed with
    0-fill, an unknown mode."""
    mode(tmp_path, rng)


@pytest.mark.parametrize("verb", ["predict", "reproduction_number",
                                  "within_between"])
def test_computing_clis_need_a_card_or_device_cpu(tmp_path, verb):
    """Without ``--device cpu`` the three verbs that compute raise on a
    machine without a card; they never move to the CPU on their own."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    cli = importlib.import_module(f"covid19uk_tpu_torch.posterior.{verb}")
    argv = {"predict": ["d.h5", "s.pkl", "o.h5"],
            "reproduction_number": ["s.pkl", "-d", "d.h5", "-o", "o.h5"],
            "within_between": ["-d", "d.h5", "-s", "s.pkl", "-o", "o.csv"],
            }[verb]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_port_pipeline_end_to_end(tmp_path, rng):
    """assemble -> mcmc (tiny schedule, --device cpu) -> thin -> predict in
    and out of sample -> R_t -> within/between, each through the port's
    CLI in one process that imports no JAX; every output read back
    through the JAX package's ncio (and pandas for the CSV)."""
    cfg = write_inputs(tmp_path, rng, days=25)
    mcmc = dict(dmax=4, nmax=8, m=2, occult_nmax=4, num_event_time_updates=2,
                num_bursts=2, num_burst_samples=5, thin=1, dtype="float64",
                seed=1, num_chains=2,
                warmup=dict(first_window=4, slow_window=4,
                            num_slow_windows=1, last_window=4))
    config = tmp_path / "config.yaml"
    config.write_text(json.dumps({
        "ProcessData": cfg, "Mcmc": mcmc,
        "ThinPosterior": dict(start=12, end=None, by=2)}))
    p = {k: str(tmp_path / v) for k, v in dict(
        data="data.h5", post="post.h5", pkl="samples.pkl", ins="ins.h5",
        oos="oos.h5", rt="rt.h5", wb="wb.csv").items()}
    code = f"""
import sys
from covid19uk_tpu_torch.data import assemble
from covid19uk_tpu_torch.inference import inference
from covid19uk_tpu_torch.posterior import (
    predict, reproduction_number, thin, within_between)
cfg = {str(config)!r}
p = {p!r}
assemble.main([cfg, p["data"]])
inference.main(["-c", cfg, "-o", p["post"], "--device", "cpu", p["data"]])
thin.main([p["post"], "-c", cfg, "-o", p["pkl"]])
predict.main(["-i", "18", "-n", "7", "--device", "cpu", p["data"], p["pkl"],
              p["ins"]])
predict.main(["-i", "-1", "-n", "14", "-o", "--device", "cpu", p["data"],
              p["pkl"], p["oos"]])
reproduction_number.main([p["pkl"], "-d", p["data"], "-o", p["rt"],
                          "--device", "cpu"])
within_between.main(["-d", p["data"], "-s", p["pkl"], "-o", p["wb"],
                     "--device", "cpu"])
print("JAX", [m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "covid19uk_tpu."))])
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "JAX []"

    # 12 warmup and 10 sampled draws stored, thinned 12::2, 2 chains
    S, M, T = len(range(12, 22, 2)) * 2, 11, 25
    data = jncio.load_group(p["data"], "constant_data")
    assert data["C"].shape == (M, M)
    for path, days, first in [(p["ins"], 7, 18), (p["oos"], 14, T - 1)]:
        g = jncio.load_group(path, "predictions")
        assert g["events"].shape == (S, M, days, 3)
        assert g["initial_state"].shape == (S, M, 4)
        assert g.dims["events"] == ("iteration", "location", "time", "event")
        ev = g["events"]
        assert (ev >= 0).all() and (ev == np.round(ev)).all()
        assert g.coords["time"][0] == np.datetime64("2021-01-01") + first
        assert len(g.coords["time"]) == days
    g = jncio.load_group(p["rt"], "posterior_predictive")
    assert g["R_it"].shape == (S, T, M) and g["R_t"].shape == (S, T)
    assert np.isfinite(g["R_it"]).all() and (g["R_it"] >= 0).all()
    wb = pd.read_csv(p["wb"])
    assert list(wb["location"]) == NI_CODES
    np.testing.assert_allclose(wb["within_mean"] + wb["between_mean"], 1.0,
                               rtol=1e-10)
