"""The port's ESS/sec entry points (bench_torch.py, bench_mixing_torch.py)
against the JAX repo's bench.py and tools/bench_mixing.py: the ESS
arithmetic, one adaptation step, the event-kernel configurations, the
real-data build (through h5py and through the plain HDF5 reader the card's
machine uses), and both entry points end to end on the CPU at a tiny
size."""

import ast
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_mixing_torch
import bench_torch
from covid19uk_tpu.inference import dual_averaging as jda
from covid19uk_tpu.inference import gibbs as jgibbs
from covid19uk_tpu.inference import welford as jwelford
from covid19uk_tpu.inference.warmup import regularized_variance as jreg
from covid19uk_tpu.models.spec import constrain_parameters as jconstrain
from covid19uk_tpu.parallel.diagnostics import effective_sample_size as jess
from covid19uk_tpu_torch.inference import dual_averaging, welford
from covid19uk_tpu_torch.utils import ncio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UK_DATA = os.path.join(ROOT, "data", "uk_example", "inferencedata.h5")
NI_DATA = os.path.join(ROOT, "ni_run", "inferencedata.h5")


def _source_lists(path, function):
    """The literal lists and the returned dict's keys in ``function`` of
    the file at ``path``: ``{name: [...]}`` and ``"return": [keys]``."""
    tree = ast.parse(open(path).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    out = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.List)
                and isinstance(node.targets[0], ast.Name)):
            out[node.targets[0].id] = ast.literal_eval(node.value)
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            out["return"] = [k.value for k in node.value.keys]
    return out


def _ar1(rng, C, N, P, rho=0.8):
    x = np.zeros((C, N, P))
    x[:, 0] = rng.normal(size=(C, P))
    for n in range(1, N):
        x[:, n] = rho * x[:, n - 1] + rng.normal(size=(C, P))
    return x + rng.normal(size=(C, 1, P))  # chain offsets


def test_ess_summary_matches_bench_arithmetic():
    """bench.py:306-323 on one AR(1) trace of the six scalars: per-scalar
    pooled ESS of the constrained draws, min, ESS/draw, value and
    vs_baseline at a fixed wall."""
    rng = np.random.default_rng(11)
    C, N, wall = 4, 200, 12.5
    us = _ar1(rng, C, N, 6)
    ess, value, ratio = bench_torch.ess_summary(us, wall)

    u_con = np.asarray(jconstrain(jnp.asarray(us)))
    want = np.array([float(np.asarray(jess(jnp.asarray(u_con[:, :, i]))))
                     for i in range(6)])
    ess_min = float(want.min())
    cpu_ess_per_sec = (ess_min / (C * N)
                       * bench.CPU_BASELINE_NAIVE_STEPS_PER_SEC)
    np.testing.assert_allclose(ess, want, rtol=1e-6)
    np.testing.assert_allclose(value, ess_min / wall, rtol=1e-6)
    np.testing.assert_allclose(ratio, ess_min / wall / cpu_ess_per_sec,
                               rtol=1e-6)
    assert (bench_torch.CPU_BASELINE_NAIVE_STEPS_PER_SEC
            == bench.CPU_BASELINE_NAIVE_STEPS_PER_SEC)
    assert bench_torch.SCALAR_NAMES == bench.SCALAR_NAMES


def test_adapt_update_matches_bench_warmup_body():
    """30 steps of bench.py:214-225 (vmapped over 4 chains) against
    adapt_update, with nan and -inf among the log accept ratios."""
    rng = np.random.default_rng(5)
    C, P, steps = 4, 7, 30
    lar = rng.normal(-0.5, 1.0, size=(steps, C))
    lar[3, 1] = np.nan
    lar[7, 0] = -np.inf
    lar[12, 2] = np.nan
    lar[20, :] = -np.inf
    lar[25, 3] = 0.4
    us = rng.normal(size=(steps, C, P))

    def body(da, wf, lar, u):
        accept = jnp.exp(jnp.minimum(lar, 0.0))
        accept = jnp.where(jnp.isfinite(accept), accept, 0.0)
        da = jda.update(da, accept)
        wf = jwelford.update(wf, u)
        return da, wf, jreg(wf)

    jbody = jax.jit(jax.vmap(body))
    jd = jax.vmap(lambda _: jda.init(0.1, jnp.float64))(jnp.arange(C))
    jw = jax.vmap(lambda _: jwelford.init((P,), jnp.float64))(jnp.arange(C))
    td = dual_averaging.init(torch.full((C,), 0.1, dtype=torch.float64))
    tw = welford.init((C, P), torch.float64, "cpu")
    for i in range(steps):
        jd, jw, jm = jbody(jd, jw, jnp.asarray(lar[i]), jnp.asarray(us[i]))
        td, tw, tm = bench_torch.adapt_update(
            td, tw, torch.as_tensor(lar[i]), torch.as_tensor(us[i]))
        for a, b in [*zip(jd, td), *zip(jw, tw), (jm, tm)]:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                       atol=1e-10)
    np.testing.assert_allclose(dual_averaging.step_size(td).numpy(),
                               np.asarray(jax.vmap(jda.step_size)(jd)),
                               rtol=1e-10)


class _Recorder:
    """Stands in for make_mcmc_step: records the config, returns None or
    raises ``stop``."""

    def __init__(self, stop=None):
        self.configs, self.stop = [], stop

    def __call__(self, model, num_leapfrog_steps, event_config, **kw):
        assert num_leapfrog_steps == 16
        self.configs.append(event_config._asdict())
        if self.stop is not None:
            raise self.stop


@pytest.mark.parametrize("env", [{}, {"BENCH_FUSED": "0"},
                                 {"BENCH_PAIR": "1"}])
def test_build_configs_match_bench(monkeypatch, env):
    """build's warm and sample configs are bench.py:100-128's, by field,
    with and without BENCH_FUSED=0 and BENCH_PAIR=1."""
    for k in ("BENCH_FUSED", "BENCH_PAIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jrec, trec = _Recorder(), _Recorder()
    monkeypatch.setattr(jgibbs, "make_mcmc_step", jrec)
    monkeypatch.setattr(bench_torch, "make_mcmc_step", trec)
    monkeypatch.setattr(bench, "M", 8)
    monkeypatch.setattr(bench, "T", 24)
    bench.build(2)
    _, _, _, state = bench_torch.build(2, M=8, T=24, device="cpu")
    assert len(jrec.configs) == 2 and trec.configs == jrec.configs
    fused = "never" if env.get("BENCH_FUSED") == "0" else "always"
    assert [c["fused_sweep"] for c in trec.configs] == [fused, fused]
    assert [c["num_pair_updates"] for c in trec.configs] == [
        1, int(env.get("BENCH_PAIR", 0))]
    assert state.u.shape == (2, 6 + 23 + 8)
    assert state.events.shape == (2, 8, 24, 3)


def test_build_real_matches_bench_without_h5py(monkeypatch):
    """build_real on the tracked UK data, read through the plain HDF5
    reader (h5py hidden, as on the card's machine), against bench.py's
    build_real: events and initial state bitwise, (M, T, P), the configs
    by field, and the jitter only on u[:, :6]."""
    jrec, trec = _Recorder(), _Recorder()
    monkeypatch.setattr(jgibbs, "make_mcmc_step", jrec)
    monkeypatch.setattr(bench_torch, "make_mcmc_step", trec)
    jmodel, _, _, jstate = bench.build_real(2, UK_DATA)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    model, _, _, state = bench_torch.build_real(2, UK_DATA, device="cpu")
    jev = np.asarray(jstate.events)
    assert state.events.dtype == torch.float32
    assert state.events.shape == jev.shape == (2, 380, 120, 3)
    np.testing.assert_array_equal(state.events.numpy(), jev)
    np.testing.assert_array_equal(model.initial_state.numpy(),
                                  np.asarray(jmodel.initial_state))
    assert state.u.shape == jstate.u.shape == (2, 6 + 119 + 380)
    assert trec.configs == jrec.configs and len(trec.configs) == 2
    assert [c["num_pair_updates"] for c in trec.configs] == [1, 0]
    for u in (state.u.numpy(), np.asarray(jstate.u)):
        assert np.all(u[:, 6:] == 0.0)
        assert np.all(u[:, :6] != 0.0) and np.all(np.abs(u[:, :6]) < 0.5)


@pytest.mark.parametrize("path", [UK_DATA, NI_DATA, "written"],
                         ids=["uk_example", "ni_run", "written"])
def test_load_group_without_h5py_matches_h5py(monkeypatch, tmp_path, path):
    """ncio.load_group through the plain HDF5 reader (h5py hidden) reads
    every group of the tracked inputs, and a file save_group wrote, as
    through h5py: variables, coords, dims and attrs, dtypes and bits."""
    if path == "written":
        path = str(tmp_path / "g.h5")
        g = ncio.Group(
            variables={"x": np.arange(12.0).reshape(3, 4),
                       "n": np.arange(3, dtype=np.int64)},
            dims={"x": ("a", "b"), "n": ("a",)},
            coords={"a": np.array(["p", "q", "r"]), "b": np.arange(4)},
            attrs={"title": "t", "k": 3},
        )
        ncio.save_group(path, "grp", g, mode="w")
        groups = ["grp"]
    elif not os.path.exists(path):
        pytest.skip(f"{path} is not in this checkout")
    else:
        groups = ["constant_data", "observations"]
    want = [ncio.load_group(path, g) for g in groups]
    monkeypatch.setitem(sys.modules, "h5py", None)
    for g, a in zip(groups, want):
        b = ncio.load_group(path, g)
        assert b.dims == a.dims
        assert b.attrs.keys() == a.attrs.keys()
        for k in a.attrs:
            np.testing.assert_array_equal(np.asarray(b.attrs[k]),
                                          np.asarray(a.attrs[k]))
        for part in ("variables", "coords"):
            x, y = getattr(a, part), getattr(b, part)
            assert list(y) == list(x)
            for k in x:
                assert y[k].dtype == x[k].dtype and y[k].shape == x[k].shape
                np.testing.assert_array_equal(y[k], x[k])


def test_load_group_without_h5py_refuses_chunked_data(monkeypatch,
                                                      tmp_path):
    """The plain HDF5 reader raises on a layout it does not read (a
    chunked, compressed dataset) rather than return wrong data."""
    import h5py

    path = str(tmp_path / "chunked.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("grp/x", data=np.arange(100.0), chunks=(10,),
                         compression="gzip")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ValueError, match="class 2"):
        ncio.load_group(path, "grp")


def _load_tool():
    path = os.path.join(ROOT, "tools", "bench_mixing.py")
    spec = importlib.util.spec_from_file_location("jax_bench_mixing", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags", [
    [],
    ["--gamma-gibbs", "--pair-comp", "--no-comp"],
    ["--occult-range", "full", "--move-guided", "always"],
])
def test_mixing_config_matches_tool(monkeypatch, flags):
    """mixing_config equals the EventKernelConfig that
    tools/bench_mixing.py's run passes to make_mcmc_step, by field."""
    tool = _load_tool()
    rec = _Recorder(stop=_Stop())
    monkeypatch.setattr(jgibbs, "make_mcmc_step", rec)
    monkeypatch.setattr(sys, "argv", ["bench_mixing.py", *flags])
    with pytest.raises(_Stop):
        tool.main()
    args = bench_mixing_torch.parser().parse_args(flags)
    cfg = bench_mixing_torch.mixing_config(args, 32)  # NI scale: T = 32
    assert cfg._asdict() == rec.configs[0]


def test_run_benchmark_end_to_end_on_cpu():
    """run_benchmark at M=8, T=24, C=4, 20 warm draws and 2 x 40 timed:
    bench.py's keys, finite positive value, consistent counts."""
    stats = {}
    result = bench_torch.run_benchmark(
        *bench_torch.build(4, M=8, T=24, device="cpu"), metric="cpu_tiny",
        warm_draws=20, n_draws=40, n_seeds=2, stats=stats)
    keys = _source_lists(os.path.join(ROOT, "bench.py"),
                         "run_benchmark")["return"]
    assert list(result) == keys
    assert result["metric"] == "cpu_tiny"
    assert result["unit"] == "min-ESS/sec"
    assert math.isfinite(result["value"]) and result["value"] > 0
    assert math.isfinite(result["sd"]) and result["sd"] >= 0
    assert result["seeds"] == 2 and result["chains"] == 4
    assert len(result["runs"]) == 2 and all(v > 0 for v in result["runs"])
    assert abs(np.mean(result["runs"]) - result["value"]) <= 0.01
    ess = result["ess_diag_not_mixing"]
    assert list(ess) == bench.SCALAR_NAMES
    assert all(math.isfinite(v) and v > 0 for v in ess.values())
    assert stats["transitions"] == 20 + 3 * 40
    assert len(stats["walls"]) == 2
    assert 0.0 < stats["hmc_accept"] <= 1.0


def test_bench_mixing_ni_on_cpu(capsys):
    """bench_mixing_torch at NI scale, 2 chains, 10 warm, 20 draws, with
    the compensated pair move and the gamma refresh: the tool's lines,
    its 6 ESS names and 8 acceptance names, all finite."""
    assert bench_mixing_torch.main(
        ["--chains", "2", "--warm", "10", "--draws", "20", "--device", "cpu",
         "--gamma-gibbs", "--pair-comp"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[0] for line in lines] == [
        "config:", "ESS:", "acc:", "chains=2"]
    names = _source_lists(os.path.join(ROOT, "tools", "bench_mixing.py"),
                          "run")
    ess = ast.literal_eval(lines[1][len("ESS: "):])
    acc = ast.literal_eval(lines[2][len("acc: "):])
    assert list(ess) == names["names"] == bench_mixing_torch.NAMES
    assert list(acc) == names["acc_names"] == bench_mixing_torch.ACC_NAMES
    assert all(math.isfinite(v) and v > 0 for v in ess.values())
    assert all(0.0 <= v <= 1.0 for v in acc.values())
    assert acc["gamma"] > 0.0 and acc["hmc"] > 0.0


@pytest.mark.parametrize("entry", [bench_torch, bench_mixing_torch])
def test_entry_points_refuse_without_a_card(monkeypatch, capsys, entry):
    """Without a card and without --device cpu, each entry point exits
    non-zero with a message, before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert entry.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
