"""The CUDA kernels' own sources, run on the CPU against their plain
versions.

``covid19uk_tpu_torch/ops/csrc/*.cu`` are compiled with the host C++
compiler against ``tests/cuda_emulation/cuda_runtime.h``, which runs each
CUDA thread as a std::thread with real barriers and warp shuffles.  That
checks a kernel's indexing, reductions, barrier placement and numerics
without a card (a barrier under divergent control flow hangs here too,
and the child process's timeout reports it).  It says nothing of nvcc,
speed or the card's own math library: tests/test_torch_cuda.py and
chip_smoke.py hold the real kernels on the card.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from covid19uk_tpu_torch.inference.likelihood import make_context
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import Parameters
from covid19uk_tpu_torch.ops import _build
from covid19uk_tpu_torch.ops import fused_sweep as fs
from covid19uk_tpu_torch.utils import synthetic

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CSRC = os.path.join(ROOT, "covid19uk_tpu_torch", "ops", "csrc")
CASES = {
    # name: (M, T, C, U, guided, seed)
    "small": (12, 30, 3, 5, False, 5),
    "small_guided": (12, 30, 3, 5, True, 6),
    # more locations than threads: the strided loops wrap
    "wide": (400, 24, 1, 2, True, 2),
    "full_width_chain": (380, 120, 1, 3, True, 0),
}


def _emulated_source(text):
    text = re.sub(r"extern __shared__ float (\w+)\[\];",
                  r"static float \1[1 << 16];", text)
    text, n = re.subn(
        r"(\w+)<<<([^,]+), ([^,]+), .*?>>>\((\w+)\);",
        r"(void)stream; emu_launch(\1, \2, \3, \4);", text)
    assert n == 1, "kernel launch not found"
    return text


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``name -> path`` of ``csrc/<name>.cu`` built for the emulation."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    d = tmp_path_factory.mktemp("cuda_emulated")
    built = {}

    def get(name):
        if name not in built:
            src = d / f"{name}_emulated.cpp"
            with open(os.path.join(CSRC, f"{name}.cu")) as f:
                src.write_text(_emulated_source(f.read()))
            so = d / f"lib{name}_emulated.so"
            out = subprocess.run(
                [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                 "-I", os.path.join(TESTS, "cuda_emulation"), "-o", str(so),
                 str(src)],
                capture_output=True, text=True, timeout=300,
            )
            assert out.returncode == 0, out.stderr
            built[name] = str(so)
        return built[name]

    return get


def _inputs(M, T, C, cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    model = synthetic.build_synthetic_model(M, T, torch.float32,
                                            device="cpu")
    p = synthetic.initial_parameters(model)
    params = Parameters(*[a.expand((C,) + a.shape) for a in p])
    events = model.sample_seir(gen, params)
    state = seir.compute_state(model.initial_state, events)
    commute = model.commute_pressure(state[..., 2])
    ctx = make_context(model, params)
    logp = model.log_prob(params, events)
    decays = torch.tensor([0.8, 0.85, 0.9, 0.9, 0.9]).expand(C, 5)
    tbl, ttbl = fs.draw_tables(gen, C, M, T, cfg, "cpu")
    return (tbl, ttbl, events, state, commute, logp, ctx.exp_eta, ctx.psi_w,
            ctx.rate_ir_t, ctx.N, ctx.Cstar, decays)


def _child(so_path, case):
    """Runs in a child process: emulated kernel vs plain version."""
    M, T, C, U, guided, seed = CASES[case]
    cfg = fs.SweepConfig(mmax=2, nmax=25, dmax=min(84, T // 2),
                         occult_nmax=15, t_range=(T - T // 5, T),
                         num_updates=U, occult_guided=guided)
    inputs = _inputs(M, T, C, cfg, seed)
    lib = _build.bind_fused_sweep(ctypes.CDLL(so_path))
    args, _ins, outs = fs._kernel_args(*inputs, cfg)
    assert lib.fused_sweep_launch(*args, None) == 0
    got = fs._public_layout(outs, *inputs[2:6])
    rec = []
    want = fs.fused_sweep_reference(*inputs, cfg, record=rec)
    accepted = sum(int((r["log_u"] < r["log_alpha"]).sum()) for r in rec)
    cols = [0] + list(range(2, fs.trace_width(cfg.mmax)))
    result = dict(
        events=bool(torch.equal(got[0], want[0])),
        state=bool(torch.equal(got[1], want[1])),
        trace=bool(torch.equal(got[4][..., cols], want[4][..., cols])),
        commute=float(((got[2] - want[2]).abs()
                       / (want[2].abs() + 1e-6)).max()),
        logp=float(((got[3] - want[3]).abs() / want[3].abs()).max()),
        accepted=accepted,
    )
    print(json.dumps(result))


def _run_child(fn, so_path, case):
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import test_torch_cuda_emulated as t; t.%s(%r, %r)"
            % (ROOT, TESTS, fn, so_path, case))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_plain_version(emulated, case):
    r = _run_child("_child", emulated("fused_sweep"), case)
    assert r["events"] and r["state"] and r["trace"], r
    assert r["commute"] <= 1e-5 and r["logp"] <= 1e-5, r
    assert r["accepted"] > 0, "nothing accepted: the apply paths never ran"


BSR_CASES = {
    # name: (M, T, S, seed); M not a multiple of 128, T over one tile
    "one_row_strip": (100, 24, 1, 0),
    "batched": (300, 40, 3, 1),
    "two_t_tiles": (260, 130, 2, 2),
}


def _bsr_child(so_path, case):
    """Runs in a child process: emulated K2 vs its plain version."""
    from covid19uk_tpu_torch.ops import block_sparse as bs

    M, T, S, seed = BSR_CASES[case]
    model = synthetic.build_synthetic_model(M, T, torch.float32,
                                            sparse=True, device="cpu")
    op = model.data.Cstar_bsr
    R = op.values.shape[0]
    gen = torch.Generator().manual_seed(seed)
    xp = torch.zeros((S, R * bs.BLOCK, -(-T // 128) * 128))
    xp[:, :M, :T] = torch.randn((S, M, T), generator=gen)
    lib = _build.bind_block_sparse(ctypes.CDLL(so_path))
    y = torch.empty_like(xp)
    err = lib.bsr_matmul_launch(op.values.data_ptr(), op.col_idx.data_ptr(),
                                xp.data_ptr(), y.data_ptr(), R,
                                op.values.shape[1], S, xp.shape[2], None)
    assert err == 0
    want = bs.bsr_matmul_reference(op.values, op.col_idx, xp)
    gathered = xp.reshape(S, R, bs.BLOCK, -1)[:, op.col_idx.long()]
    scale = torch.einsum("rkij,srkjt->srit", op.values.abs(),
                         gathered.abs()).reshape(want.shape)
    print(json.dumps(dict(
        rel_err=float(((y - want).abs() / (scale + 1e-30)).max()),
        nonzero=int((want != 0).sum()),
        padded_zero=bool((y[:, M:] == 0).all()),
    )))


@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_emulated_block_sparse_matches_plain_version(emulated, case):
    """K2's source on CPU threads against bsr_matmul_reference, within
    1e-5 of |A| @ |x| (float32 sums in another order)."""
    r = _run_child("_bsr_child", emulated("block_sparse"), case)
    assert r["rel_err"] <= 1e-5, r
    assert r["nonzero"] > 0 and r["padded_zero"], r
