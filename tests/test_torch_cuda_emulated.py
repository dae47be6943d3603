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
    # name: (M, T, C, U, guided, seed, options)
    "small": (12, 30, 3, 5, False, 5, {}),
    "small_guided": (12, 30, 3, 5, True, 6, {}),
    # more locations than threads: the strided loops wrap
    "wide": (600, 24, 1, 2, True, 2, {}),
    "full_width_chain": (380, 120, 1, 3, True, 0, {}),
    # one slot, and the most slots the kernel takes (a warp each)
    "mmax1": (20, 30, 2, 2, False, 7, dict(mmax=1)),
    "mmax8": (40, 30, 3, 3, True, 8, dict(mmax=8)),
    # tables set so that move S->E's slots start on day 0 and day T-1, and
    # move E->I's windows overlap and the move is accepted (its delta
    # reaches logp)
    "edge_days_overlap": (40, 30, 2, 1, False, 9, dict(edges=True)),
    # events on half the plane cells (the rate-only term takes its
    # logarithms only there) and long accepted E->I windows
    "dense_events": (40, 30, 1, 1, False, 11, dict(dense=True)),
    # inputs as plane-major views (the wrapper's own output layout), and
    # T % 4 != 0 (the kernel's scalar copy-in)
    "plane_major_odd_t": (13, 31, 2, 2, True, 4, dict(plane_major=True)),
}


def _emulated_source(text):
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];",
                  r"alignas(16) static float \1[1 << 16];", text)
    text, n = re.subn(
        r"(\w+(?:<\w+>)?)<<<([^,]+), ([^,]+), .*?>>>\((\w+)\);",
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


def _inputs(M, T, C, cfg, seed, last_day_event=False, dense_events=False):
    """The sweep's inputs for a synthetic model; with last_day_event, one
    more S->E event on day T-1 at location 0 (the simulated epidemic has
    none that late; an event on the last day changes no state); with
    dense_events, one more S->E event on every even day and one more E->I
    event on every odd day at every location (E only gains; S stays far
    from 0)."""
    gen = torch.Generator().manual_seed(seed)
    model = synthetic.build_synthetic_model(M, T, torch.float32,
                                            device="cpu")
    p = synthetic.initial_parameters(model)
    params = Parameters(*[a.expand((C,) + a.shape) for a in p])
    events = model.sample_seir(gen, params)
    if last_day_event:
        events[:, 0, T - 1, 0] += 1.0
    if dense_events:
        events[:, :, 0::2, 0] += 1.0
        events[:, :, 1::2, 1] += 1.0
    state = seir.compute_state(model.initial_state, events)
    commute = model.commute_pressure(state[..., 2])
    ctx = make_context(model, params)
    logp = model.log_prob(params, events)
    decays = torch.tensor([0.8, 0.85, 0.9, 0.9, 0.9]).expand(C, 5)
    tbl, ttbl = fs.draw_tables(gen, C, M, T, cfg, "cpu")
    return (tbl, ttbl, events, state, commute, logp, ctx.exp_eta, ctx.psi_w,
            ctx.rate_ir_t, ctx.N, ctx.Cstar, decays)


_TOP = 1.0 - 1e-7  # the largest uniform the gumbel keeps


def _force(tables, cfg, M, c, k, i, loc, day, u_side, u_j, u_x=None):
    """Sets chain c's uniforms of move k in tables = (tbl, ttbl) so that
    slot i takes location loc (the (i+1)-th largest location gumbel) and
    starts on day, with side, jump and, given u_x, count uniforms."""
    tbl, ttbl = tables
    o = fs.Offsets(M, cfg.mmax).move[k]
    tbl[c, :, o["loc"] + loc] = 1.0 - (i + 1) * 1e-7
    ttbl[c, :, day, k * cfg.mmax + i] = _TOP
    tbl[c, :, o["side"] + i] = u_side
    tbl[c, :, o["j"] + i] = u_j
    if u_x is not None:
        tbl[c, :, o["x"] + i] = u_x


def _accept_ei(tables, cfg, M):
    """Move E->I's accept uniform to 0: accepted unless its log alpha is
    below log(1e-38)."""
    tables[0][:, :, fs.Offsets(M, cfg.mmax).move[1]["acc"]] = 0.0


def _edge_tables(inputs, cfg):
    """Move S->E: slot 0 takes the location with the most events on day 0
    and starts there, slot 1 the one with the most on day T-1, both
    jumping their longest.  Move E->I: slot 0 moves one event from the
    busiest day a of the busiest location four days later, slot 1 one
    event from a busy day b in [a+2, a+7] of another location four days
    earlier, so their windows overlap; the move is accepted."""
    tables = (inputs[0].clone(), inputs[1].clone())
    events = inputs[2]
    M, T = events.shape[1], events.shape[2]

    def jump4(side_len):  # u_j that jumps 4 days at the test's decay 0.85
        return (1.0 - 0.85 ** 3.5) / (1.0 - 0.85 ** min(cfg.dmax, side_len))

    for c in range(events.shape[0]):
        se = events[c, :, :, 0]
        first = int(se[:, 0].argmax())
        last = se[:, T - 1].clone()
        last[first] = -1.0
        _force(tables, cfg, M, c, 0, 0, first, 0, 0.0, _TOP)
        _force(tables, cfg, M, c, 0, 1, int(last.argmax()), T - 1, _TOP, _TOP)
        ei = events[c, :, :, 1]
        loc0 = int(ei.sum(1).argmax())
        a = int(ei[loc0, :T - 8].argmax())
        near = ei[:, a + 2:a + 8].clone()
        near[loc0] = -1.0
        loc1, off = divmod(int(near.argmax()), near.shape[1])
        _force(tables, cfg, M, c, 1, 0, loc0, a, 0.0, jump4(T - 1 - a), 0.0)
        _force(tables, cfg, M, c, 1, 1, loc1, a + 2 + off, _TOP,
               jump4(a + 2 + off), 0.0)
    _accept_ei(tables, cfg, M)
    return tables + tuple(inputs[2:])


def _dense_tables(inputs, cfg):
    """For dense_events inputs: move E->I's slots move one event each from
    the odd days 3 and T//2 - 2 of locations M-1 and M-2 as late as they
    can, so the windows hold most days of every location, half the cells
    with S->E events (queued warps fill unevenly); the move is accepted.
    The slots' own rows, whose terms are the largest, are the last cells
    a warp takes."""
    tables = (inputs[0].clone(), inputs[1].clone())
    M, T = inputs[2].shape[1], inputs[2].shape[2]
    for c in range(inputs[2].shape[0]):
        for i, day in enumerate((3, T // 2 - 2)):
            _force(tables, cfg, M, c, 1, i, M - 1 - i, day, 0.0, _TOP, 0.0)
    _accept_ei(tables, cfg, M)
    return tables + tuple(inputs[2:])


def _child(so_path, case):
    """Runs in a child process: emulated kernel vs plain version."""
    M, T, C, U, guided, seed, opt = CASES[case]
    cfg = fs.SweepConfig(mmax=opt.get("mmax", 2), nmax=25,
                         dmax=min(84, T // 2), occult_nmax=15,
                         t_range=(T - T // 5, T), num_updates=U,
                         occult_guided=guided)
    inputs = _inputs(M, T, C, cfg, seed, last_day_event=opt.get("edges"),
                     dense_events=opt.get("dense"))
    if opt.get("edges"):
        inputs = _edge_tables(inputs, cfg)
    if opt.get("dense"):
        inputs = _dense_tables(inputs, cfg)
    if opt.get("plane_major"):
        ev, st = (t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                  for t in inputs[2:4])
        inputs = inputs[:2] + (ev, st) + inputs[4:]
    before = [t.clone() for t in inputs]
    lib = _build.bind_fused_sweep(ctypes.CDLL(so_path))
    args, _ins, outs = fs._kernel_args(*inputs, cfg)
    assert lib.fused_sweep_launch(*args, None) == 0
    got = fs._public_layout(outs, *inputs[2:6])
    rec = []
    want = fs.fused_sweep_reference(*inputs, cfg, record=rec)
    accepted = sum(int((r["log_u"] < r["log_alpha"]).sum()) for r in rec)
    mm = cfg.mmax
    cols = [0] + list(range(2, fs.trace_width(mm)))
    # the moves' slots 0 and 1 of the last multiscan: start days; windows
    # of move E->I
    t_src = want[4][:, :2, 2 + mm:2 + 2 * mm]
    d = want[4][:, :2, 2 + 2 * mm:2 + 3 * mm]
    lo = torch.minimum(t_src, t_src + d) + 1
    hi = torch.maximum(t_src, t_src + d)
    overlap = ((lo[:, 1, 0] <= hi[:, 1, 1]) & (lo[:, 1, 1] <= hi[:, 1, 0])
               if mm > 1 else torch.zeros(C, dtype=torch.bool))
    result = dict(
        events=bool(torch.equal(got[0], want[0])),
        state=bool(torch.equal(got[1], want[1])),
        trace=bool(torch.equal(got[4][..., cols], want[4][..., cols])),
        commute=float(((got[2] - want[2]).abs()
                       / (want[2].abs() + 1e-6)).max()),
        logp=float(((got[3] - want[3]).abs() / want[3].abs()).max()),
        accepted=accepted,
        inputs_unchanged=all(torch.equal(a, b)
                             for a, b in zip(before, inputs)),
        day0=bool((t_src[:, 0, 0] == 0).any()),
        last_day=bool((t_src[:, 0, min(1, mm - 1)] == T - 1).any()),
        overlap_accepted=bool((overlap & (want[4][:, 1, 0] > 0.5)).any()),
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
    assert r["inputs_unchanged"], "the kernel wrote the caller's tensors"
    if CASES[case][-1].get("edges"):
        assert r["day0"] and r["last_day"] and r["overlap_accepted"], r
    if CASES[case][-1].get("dense"):
        assert r["overlap_accepted"], r


BSR_CASES = {
    # name: (M, T, S, seed, options); M not a multiple of 128.  Options:
    # sms (the SM count the day tile is chosen for, default 4), zero_row
    # (block row whose values are zeroed), identity (no permutation),
    # misaligned (x 4 bytes off 16-byte alignment)
    "one_row_strip": (100, 24, 1, 0, {}),
    "batched": (300, 40, 3, 1, {}),
    # three 48-day tiles, the last holding 34 days
    "two_t_tiles": (260, 130, 2, 2, dict(sms=1)),
    # rows of 2, 3 and 2 slots, visited longest first; 64-day tiles
    "slot_counts": (300, 128, 1, 3, dict(sms=1)),
    # a block row of zero blocks gives zero rows (slots 0)
    "zero_row": (330, 20, 1, 4, dict(zero_row=1)),
    # T % 4 != 0: 4-byte copies of x
    "odd_t": (300, 85, 1, 5, {}),
    # fewer days than one 8-day tile
    "short_t": (300, 5, 2, 6, {}),
    # no permutation, and x off 16-byte alignment with T % 4 == 0
    "identity_misaligned": (300, 32, 2, 7, dict(identity=True,
                                                misaligned=True)),
    # a launch on block rows 1-2 of the three (a space-sharded rank's
    # band), against the CPU band; the day tile chosen for all three rows
    "band": (300, 40, 2, 8, dict(band=(1, 3))),
}


def _bsr_child(so_path, case):
    """Runs in a child process: emulated K2 vs the CPU BlockSparse.matmul
    (the plain route) on x [S, M, T]."""
    from covid19uk_tpu_torch.ops import block_sparse as bs

    M, T, S, seed, opt = BSR_CASES[case]
    model = synthetic.build_synthetic_model(M, T, torch.float32,
                                            sparse=True, device="cpu")
    op = model.data.Cstar_bsr
    if "zero_row" in opt:
        values = op.values.clone()
        values[opt["zero_row"]] = 0.0
        op = bs.BlockSparse(values, op.col_idx, op.n, op.perm, op.inv_perm)
    if opt.get("identity"):
        op = bs.BlockSparse(op.values, op.col_idx, op.n)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((S, M, T), generator=gen)
    if opt.get("misaligned"):
        buf = torch.empty(S * M * T + 4)
        x = buf[1:1 + S * M * T].view(S, M, T).copy_(x)
    x0 = x.clone()
    lib = _build.bind_block_sparse(ctypes.CDLL(so_path))
    band = bs.RowBand(op, *opt["band"]) if "band" in opt else None
    args, y = bs._kernel_args(op.values, op.col_idx, x, op.perm32, op.slots,
                              op.order if band is None else band.order,
                              sms=opt.get("sms", 4))
    err = lib.bsr_matmul_launch(*args, None)
    assert err == 0
    want = op.matmul(x) if band is None else band.matmul(x)
    scale = bs._plain(op.values.abs(), op.col_idx, op.perm, op.inv_perm,
                      x.abs())
    rows = None
    if "zero_row" in opt:
        r = opt["zero_row"] * bs.BLOCK
        rows = op.perm[r:min(r + bs.BLOCK, M)]
    print(json.dumps(dict(
        rel_err=float(((y - want).abs() / (scale + 1e-30)).max()),
        nonzero=int((want != 0).sum()),
        x_unchanged=bool(torch.equal(x, x0)),
        slots=op.slots.tolist(),
        order=op.order.tolist(),
        tile_days=args[-1],
        whole_tile_days=bs.tile_days(op.col_idx.shape[0], S, T,
                                     opt.get("sms", 4)),
        band_rows=args[8],
        zeros_outside=None if band is None else bool(
            (y[:, want.abs().sum((0, 2)) == 0] == 0).all()),
        vec=T % 4 == 0 and x.data_ptr() % 16 == 0,
        zero_rows=None if rows is None else bool((y[:, rows] == 0).all()),
    )))


@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_emulated_block_sparse_matches_plain_version(emulated, case):
    """K2's source on CPU threads against the CPU BlockSparse.matmul,
    within 1e-5 of |A| @ |x| (float32 sums in another order, 3xTF32
    products); the caller's x is left as it was."""
    r = _run_child("_bsr_child", emulated("block_sparse"), case)
    assert r["rel_err"] <= 1e-5, r
    assert r["nonzero"] > 0 and r["x_unchanged"], r
    opt = BSR_CASES[case][-1]
    if case == "slot_counts":
        assert len(set(r["slots"])) > 1 and r["tile_days"] == 64, r
        assert r["order"][0] == r["slots"].index(max(r["slots"])), r
    if "zero_row" in opt:
        assert r["slots"][opt["zero_row"]] == 0 and r["zero_rows"], r
    if case in ("odd_t", "identity_misaligned"):
        assert not r["vec"], r
    if "band" in opt:
        assert r["band_rows"] == 2 and r["zeros_outside"], r
        assert r["tile_days"] == r["whole_tile_days"], r
