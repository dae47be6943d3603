"""Port parity for the MCMC driver and its IO: the sample and results
layouts, the initialization, the config, netCDF-profile input, the
posterior store read back by the JAX package, a full ``mcmc`` run on the
NI data against the layout of the JAX-written ``ni_run/posterior.h5``,
resume, the convergence gate, the CLI, and imports without h5py and
PyYAML."""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from covid19uk_tpu import config as jconfig
from covid19uk_tpu.inference import driver as jdriver
from covid19uk_tpu.inference import gibbs as jg
from covid19uk_tpu.inference import hmc as jhmc
from covid19uk_tpu.inference.event_kernels import EventMoveInfo as JInfo
from covid19uk_tpu.posterior.thin import thin_posterior
from covid19uk_tpu.utils import ncio as jncio
from covid19uk_tpu.utils.store import Posterior as JPosterior
from covid19uk_tpu_torch import config as tconfig
from covid19uk_tpu_torch.inference import driver as tdriver
from covid19uk_tpu_torch.inference import gibbs as tg
from covid19uk_tpu_torch.inference import hmc as thmc
from covid19uk_tpu_torch.inference.event_kernels import EventMoveInfo as TInfo
from covid19uk_tpu_torch.utils import checkpoint as tckpt
from covid19uk_tpu_torch.utils import ncio as tncio
from tests.test_driver import make_synthetic_datafile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NI_DATA = os.path.join(ROOT, "ni_run", "inferencedata.h5")
NI_POSTERIOR = os.path.join(ROOT, "ni_run", "posterior.h5")
UK_DATA = os.path.join(ROOT, "data", "uk_example", "inferencedata.h5")
TINY_WARMUP = dict(first_window=6, slow_window=4, num_slow_windows=1,
                   last_window=4)
WARM = 6 + 4 + 4


def _cfg(**kw):
    """The JAX driver tests' small configuration."""
    base = dict(
        dmax=4, nmax=8, m=2, occult_nmax=4, num_event_time_updates=2,
        num_bursts=2, num_burst_samples=5, thin=1, dtype="float64", seed=1,
        warmup=TINY_WARMUP,
    )
    base.update(kw)
    return base


def _datasets(f):
    out = {}
    f.visititems(lambda name, obj: out.__setitem__(name, obj)
                 if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_tree(a, b):
    assert type(a) is type(b) and (not isinstance(a, dict)
                                   or a.keys() == b.keys())
    if isinstance(a, dict):
        for k in a:
            _assert_same_tree(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _trace_pair(rng, n, C, mmax, pair_mmax):
    """The same random arrays as a JAX StepTrace and a port StepTrace."""

    def info(jcls, tcls, shape):
        acc = rng.uniform(size=(n, C)) < 0.4
        vals = [rng.normal(size=(n, C))] + [
            rng.integers(0, 9, (n, C) + shape).astype(np.float64)
            for _ in range(4)]
        return jcls(acc, *vals), tcls(acc, *vals)

    hmc = [rng.uniform(size=(n, C)) < 0.6] + [rng.normal(size=(n, C))
                                              for _ in range(3)]
    pairs = [(jhmc.HMCInfo(*hmc), thmc.HMCInfo(*hmc))]
    for shape in [(mmax,), (mmax,), (), (), (mmax,), (pair_mmax,)]:
        pairs.append(info(JInfo, TInfo, shape))
    gamma = [rng.uniform(size=(n, C)) < 0.5, rng.normal(size=(n, C))]
    pairs.append((jg.GammaGibbsInfo(*gamma), tg.GammaGibbsInfo(*gamma)))
    return jg.StepTrace(*[p[0] for p in pairs]), tg.StepTrace(
        *[p[1] for p in pairs])


@pytest.mark.parametrize("C", [1, 3])
def test_sample_and_result_layouts_match_jax(C):
    rng = np.random.default_rng(C)
    T, M = 9, 4
    u = rng.normal(size=(5, C, 6 + T - 1 + M))
    ev = rng.integers(0, 5, (5, C, M, T, 3)).astype(np.float64)
    _assert_same_tree(tdriver.draws_to_dict(u, ev, T, M),
                      {k: np.asarray(v) for k, v in
                       jdriver.draws_to_dict(u, ev, T, M).items()})
    jtr, ttr = _trace_pair(rng, 5, C, mmax=2, pair_mmax=1)
    _assert_same_tree(tdriver.trace_to_results(ttr, C == 1),
                      jdriver.trace_to_results(jtr, C == 1))


def test_initialize_from_cases_is_bitwise_jax():
    obs = tncio.load_group(NI_DATA, "observations")
    const = tncio.load_group(NI_DATA, "constant_data")
    cases = np.asarray(obs["cases"], np.float64)
    for seed, rates in ((1, (0.25, 0.5)), (7, (0.4, 0.28))):
        got = tdriver.initialize_from_cases(cases, const["N"], seed, rates)
        want = jdriver.initialize_from_cases(cases, const["N"], seed, rates)
        for a, b in zip(got, want):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)


def test_config_matches_jax():
    good = dict(num_chains=4, thin=2, num_burst_samples=10, rhat_stop=1.05,
                warmup=TINY_WARMUP, impute_rates=[0.3, 0.28],
                fused_sweep="always", sparse="never")
    assert (tconfig.McmcConfig.from_dict(good).to_dict()
            == jconfig.McmcConfig.from_dict(good).to_dict())
    assert (tconfig.McmcConfig().to_dict()
            == jconfig.McmcConfig().to_dict())
    for bad in (dict(dmax=0), dict(thin=1.5), dict(move_decay=1.5),
                dict(num_pair_updates=-1), dict(unknown_key=1),
                dict(sparse="maybe"), dict(fused_sweep="yes"),
                dict(rhat_stop=0.9), dict(ess_stop=0),
                dict(impute_rates=(1.0,)), dict(dtype="float16"),
                dict(move_accept_target=1.0), dict(occult_guide_floor=0.0),
                dict(warmup=dict(bogus=1))):
        with pytest.raises(ValueError):
            jconfig.McmcConfig.from_dict(bad)
        with pytest.raises(ValueError):
            tconfig.McmcConfig.from_dict(bad)
    with pytest.warns(UserWarning, match="num_adaptation_iterations"):
        tconfig.McmcConfig.from_dict(dict(num_adaptation_iterations=10))


def test_unported_options_and_missing_card_raise(tmp_path, monkeypatch):
    """Without a card the driver raises rather than move to the CPU.
    (Every option of the config now runs on one process; the space axis
    over several ranks raises: tests/test_torch_mesh_driver.py.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.mcmc(NI_DATA, str(tmp_path / "p.h5"), _cfg())
    assert not os.path.exists(tmp_path / "p.h5")


@pytest.mark.parametrize("group", ["constant_data", "observations"])
def test_load_group_matches_jax(group):
    got = tncio.load_group(UK_DATA, group)
    want = jncio.load_group(UK_DATA, group)
    assert got.variables.keys() == want.variables.keys()
    for k in want.variables:
        np.testing.assert_array_equal(got.variables[k], want.variables[k])
        assert got.variables[k].dtype == want.variables[k].dtype
    assert got.dims == want.dims
    assert got.coords.keys() == want.coords.keys()
    for k in want.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
    assert got.attrs.keys() == want.attrs.keys()


@pytest.fixture(scope="module")
def ni_posterior(tmp_path_factory):
    """The port's ``mcmc`` on the NI data: 8 chains, float32, the tiny
    schedule, 2 bursts of 4 draws stored every 2nd."""
    out = str(tmp_path_factory.mktemp("ni") / "posterior.h5")
    tdriver.mcmc(NI_DATA, out, dict(
        num_chains=8, dtype="float32", seed=3, num_bursts=2,
        num_burst_samples=4, thin=2, warmup=TINY_WARMUP), device="cpu")
    return out


def test_ni_mcmc_layout_matches_jax_posterior(ni_posterior):
    with h5py.File(ni_posterior, "r") as f, h5py.File(NI_POSTERIOR) as g:
        got, want = _datasets(f), _datasets(g)
        assert got.keys() == want.keys()
        for name, ds in want.items():
            if name.startswith(("samples/", "results/")):
                assert got[name].dtype == ds.dtype, name
                assert got[name].shape[1:] == ds.shape[1:], name
                assert got[name].shape[0] == WARM + 4, name
            else:
                # initial_state and time: the JAX driver now writes them
                # as float64 and 10-byte date strings; the stored file
                # predates that, so only their shapes and kinds compare
                assert got[name].shape == ds.shape, name
                assert got[name].dtype.kind == ds.dtype.kind, name
        assert f["results/hmc/is_accepted"][:].mean() > 0.05
        assert (f["samples/psi"][:] > 0).all()
        ev = f["samples/seir"][:]
        assert (ev >= 0).all() and (ev == np.round(ev)).all()
        assert f["time"][0] == g["time"][0]
        # sampling rows use a fixed step size per chain
        ss = f["results/hmc/step_size"][WARM:]
        np.testing.assert_array_equal(ss, np.broadcast_to(ss[0], ss.shape))


def test_ni_posterior_reads_through_jax(ni_posterior, tmp_path):
    post = JPosterior.open(ni_posterior)
    try:
        assert post["samples/seir"].shape == (WARM + 4, 8, 11, 32, 3)
    finally:
        post.close()
    d = thin_posterior(ni_posterior, str(tmp_path / "thin.pkl"),
                       dict(start=WARM, end=WARM + 4, by=1))
    assert d["seir"].shape == (4 * 8, 11, 32, 3)
    assert d["psi"].shape == (4 * 8,)
    assert d["initial_state"].shape == (11, 4)


def test_ni_mcmc_with_the_off_default_kernels(tmp_path):
    """``mcmc`` on the NI data with the gamma0-compensated moves (pair
    moves in warmup) and the gamma refresh: their results have the JAX
    driver's paths, dtypes and per-draw shapes, and both accept."""
    out = str(tmp_path / "posterior.h5")
    tdriver.mcmc(NI_DATA, out, dict(
        num_chains=8, dtype="float32", seed=4, num_bursts=1,
        num_burst_samples=4, thin=1, warmup=TINY_WARMUP,
        compensate_gamma0=True, num_compensated_updates=1,
        pair_compensate_gamma0=True, gamma_gibbs=True), device="cpu")
    groups = ("results/gamma/", "results/move/E->I_compensated/")
    with h5py.File(out, "r") as f, h5py.File(NI_POSTERIOR) as g:
        got, want = _datasets(f), _datasets(g)
        names = sorted(n for n in want if n.startswith(groups))
        assert sorted(n for n in got if n.startswith(groups)) == names
        assert len(names) == 5
        for name in names:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].shape == (WARM + 4,) + want[name].shape[1:], name
        assert f["results/gamma/is_accepted"][:].mean() > 0.0
        assert f["results/move/E->I_compensated/is_accepted"][:].any()
        assert np.isfinite(f["results/gamma/log_accept_ratio"][:]).any()
        for name in ("samples/gamma0", "samples/gamma1"):
            assert np.isfinite(f[name][:]).all()


class Preempted(Exception):
    pass


def test_resume_equals_uninterrupted_run(tmp_path, rng, monkeypatch):
    """3 bursts straight through against: the same run killed once the
    burst-2 checkpoint lands, then resumed; every dataset equal."""
    path = str(tmp_path / "data.h5")
    make_synthetic_datafile(path, rng, M=3, T0=25)
    straight = str(tmp_path / "straight.h5")
    tdriver.mcmc(path, straight, _cfg(num_bursts=3, num_chains=2),
                 device="cpu")

    resumed = str(tmp_path / "resumed.h5")
    cfg = _cfg(num_bursts=3, num_chains=2,
               checkpoint=str(tmp_path / "ck.npz"))
    real_save, calls = tckpt.save, []

    def dying_save(*a, **k):
        real_save(*a, **k)
        calls.append(k["extra"]["burst"])
        if len(calls) == 2:
            raise Preempted

    monkeypatch.setattr(tckpt, "save", dying_save)
    with pytest.raises(Preempted):
        tdriver.mcmc(path, resumed, cfg, device="cpu")
    monkeypatch.setattr(tckpt, "save", real_save)
    with h5py.File(resumed, "r") as f:  # burst 3 not yet written
        assert not f["samples/psi"][WARM + 10:].any()
    tdriver.mcmc(path, resumed, cfg, device="cpu")
    assert calls == [1, 2]
    with h5py.File(straight, "r") as a, h5py.File(resumed, "r") as b:
        da, db = _datasets(a), _datasets(b)
        assert da.keys() == db.keys()
        for name in da:
            assert da[name].dtype == db[name].dtype
            np.testing.assert_array_equal(da[name][()], db[name][()],
                                          err_msg=name)
        assert a["samples/psi"].shape == (WARM + 15, 2)


def test_convergence_gate_stops_early_and_truncates(tmp_path, rng):
    path = str(tmp_path / "data.h5")
    make_synthetic_datafile(path, rng, M=3, T0=25)
    out, log = str(tmp_path / "post.h5"), str(tmp_path / "log.jsonl")
    tdriver.mcmc(path, out, _cfg(num_bursts=6, num_chains=2, rhat_stop=50.0,
                                 log_file=log), device="cpu")
    with h5py.File(out, "r") as f:
        assert f["samples/psi"].shape[0] == WARM + 5
        assert f["results/hmc/is_accepted"].shape[0] == WARM + 5
        assert f["samples/seir"].shape == (WARM + 5, 2, 3, 25, 3)
    with open(log) as fh:
        events = [json.loads(line) for line in fh]
    gates = [e for e in events if e["event"] == "gate"]
    assert len(gates) == 1 and gates[0]["converged"] is True
    kinds = [e["event"] for e in events]
    assert kinds.count("window") == 3 and kinds[-1] == "diagnostics"


def test_cli_runs_from_yaml(tmp_path, rng):
    from covid19uk_tpu_torch.inference.inference import main

    path = str(tmp_path / "data.h5")
    make_synthetic_datafile(path, rng, M=3, T0=25)
    cfg_file = tmp_path / "config.yaml"
    prof = tmp_path / "profile"
    cfg_file.write_text(json.dumps({"Mcmc": _cfg(profile_dir=str(prof))}))
    out = str(tmp_path / "post.h5")
    main(["-c", str(cfg_file), "-o", out, "--device", "cpu", path])
    with h5py.File(out, "r") as f:
        assert f["samples/seir"].shape == (WARM + 10, 3, 25, 3)
        assert "initial_state" in f and "time" in f
    # profile_dir: a torch.profiler trace of the second burst
    with open(prof / "burst_1.json") as fh:
        assert json.load(fh)["traceEvents"]


def test_driver_and_chip_smoke_import_without_h5py_and_yaml():
    """h5py, PyYAML and pandas are blocked: the package with its lazy
    verbs, the driver, the CLI modules, the posterior verbs and
    chip_smoke.py import, and run_mcmc writes into chip_smoke's in-memory
    store on the CPU."""
    code = (
        "import sys, json\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import torch\n"
        "import covid19uk_tpu_torch as pkg\n"
        "import covid19uk_tpu_torch.inference.driver as d\n"
        "import covid19uk_tpu_torch.inference.inference\n"
        "import covid19uk_tpu_torch.models.ngm\n"
        "import covid19uk_tpu_torch.utils.diagnostics\n"
        "import covid19uk_tpu_torch.utils.settings\n"
        "import covid19uk_tpu_torch.utils.nans\n"
        "import covid19uk_tpu_torch.version\n"
        "import covid19uk_tpu_torch.parallel.distributed\n"
        "import covid19uk_tpu_torch.parallel.dryrun\n"
        "import covid19uk_tpu_torch.parallel.mesh\n"
        "import covid19uk_tpu_torch.parallel.sharding\n"
        "for verb in ('mcmc', 'thin_posterior', 'predict',\n"
        "             'reproduction_number', 'within_between'):\n"
        "    assert callable(getattr(pkg, verb))\n"
        "import chip_smoke\n"
        "from covid19uk_tpu_torch.utils.synthetic import "
        "build_synthetic_model, initial_chain_state\n"
        "m = build_synthetic_model(5, 12, device='cpu')\n"
        "st = initial_chain_state(m, torch.Generator().manual_seed(0))\n"
        "store = chip_smoke.MemoryPosterior()\n"
        "ecfg = chip_smoke.uk_driver_config(12)\n"
        "cfg = dict(num_bursts=1, num_burst_samples=2, num_chains=2,\n"
        "           warmup=dict(first_window=2, slow_window=1,\n"
        "                       num_slow_windows=1, last_window=2))\n"
        "d.run_mcmc(m, st, ecfg, cfg, store, num_chains=2, device='cpu')\n"
        "print(json.dumps([store['samples/seir'].shape,\n"
        "  [k for k, v in sys.modules.items() if v is not None and (\n"
        "   k in ('h5py', 'yaml', 'pandas', 'jax', 'covid19uk_tpu')\n"
        "   or k.startswith(('jax.', 'covid19uk_tpu.')))]]))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    shape, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert shape == [5 + 2, 2, 5, 12, 3] and loaded == []
