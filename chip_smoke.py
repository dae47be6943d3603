#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (covid19uk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # on a machine with a card
    python3 chip_smoke.py --rehearse  # tiny CPU run of phases 3 and 5, exits 3

Phases, one short line each:
  0. watchdog (a hang ends in a traceback and a non-zero exit) and card;
  1. builds both CUDA kernels with nvcc, one process each, started
     together (ptxas lines printed), and counts K2's SASS instructions by
     opcode (HMMA: tensor cores) where the toolkit has cuobjdump;
  2. K1, the fused event sweep, against its plain PyTorch version at full
     UK width (M=380, T=120, 64 chains, U=5): events and state identical,
     commute within rtol 1e-5 (atol 1e-6), logp within 1e-5 relative;
     times both, and K1's part split: the wrapper's layout work alone,
     the kernel alone at U=0 (copy-in), U=1 and U=5, and from these its
     fixed and per-multiscan parts;
  3. the sampling transition: synthetic full-UK model (float32), 64
     overdispersed chains, 2 untimed + 10 timed transitions of
     make_mcmc_step (fused sweep, no pair moves), invariants checked and
     K1's launches counted;
  4. K2, the block-sparse product, through the main path's call
     (Cstar_bsr.matmul on an unpadded x) against its plain version at the
     MSOA shapes (x [7000, 120] and the windowed batch [4, 7000, 85]):
     error within 1e-5 of |A| @ |x| elementwise, one launch a call,
     bitwise-equal y over two calls, x unchanged; CUDA events time the
     kernel alone (warm, and with a cold L2), the whole call (warm and
     cold), the plain version and the dense torch.matmul; both bounds
     printed (CUDA cores, tensor cores);
  5. the MSOA slice: synthetic M=7000, T=120 model (radius 0.05, float32)
     with the block-sparse commute and the banded CAR prior, one chain,
     2 untimed + 5 timed transitions of the unfused sweep with threaded
     commute and pair moves; invariants, one K2 launch per transition, and
     the threaded commute against a fresh product checked.
Then the kernels' JSON line and, last, the result line.  Any failure
exits non-zero, as does a run without a CUDA device.
"""

import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import time

M, T, C = 380, 120, 64  # full-UK scale (bench.py), 64 chains
TINY = dict(M=12, T=20, C=2)  # --rehearse
N_UNTIMED, N_TIMED = 2, 10
# MSOA scale (tools/bench_msoa.py): one chain, gravity radius 0.05
MSOA_M, MSOA_T, MSOA_RADIUS = 7000, 120, 0.05
MSOA_TIMED = 5
WINDOWED_BATCH = (4, 85)  # the windowed evaluator's [L, M, dmax + 1] shape
K2_REPS, K2_COLD_REPS = 50, 21
FLUSH_BYTES = 256 * 2**20  # written between cold launches: > the 50 MB L2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores
# Counted float32 operations per day-cell of a column delta (four binomial
# log-pmfs with their Stirling terms) and per cell of the rate-only plane
# delta (two rates, two log(1 - exp(-r)), the difference).
COL_OPS, PLANE_OPS = 200, 60
APPS = ("move S->E", "move E->I", "occult S->E", "occult E->I")


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """ptxas's registers, shared memory and spills of each kernel in an
    nvcc log, each under its template arguments (K2's ``<NN>``: 16 NN days
    a block) where it has any."""
    parts, name = [], ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            args = re.findall(r"ILi(\d+)E", entry.group(1))
            name = f"<{','.join(args)}> " if args else ""
        elif "Used" in line or "spill" in line:
            parts.append(name + line.split(":", 1)[-1].strip())
    return " | ".join(parts)


def sass_counts(path, ops=("HMMA", "LDGSTS", "LDS", "BAR.SYNC")):
    """Instructions of a built library by opcode (``cuobjdump -sass``):
    ``{op: count, "all": count}``, or None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    opcodes = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                         sass)
    counts = {op: sum(o.startswith(op) for o in opcodes) for op in ops}
    counts["all"] = len(opcodes)
    return counts


def build_chains(torch, device, M, T, C, seed=0):
    """bench.py's start: synthetic model, chains with independently
    simulated events and jittered scalar parameters."""
    from covid19uk_tpu_torch.inference.gibbs import ChainState
    from covid19uk_tpu_torch.models.spec import (
        Parameters, pack_parameters, unconstrain_parameters)
    from covid19uk_tpu_torch.utils.synthetic import (
        build_synthetic_model, initial_parameters)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = build_synthetic_model(M, T, torch.float32, device=device)
    params = initial_parameters(model)
    batched = Parameters(*[p.expand((C,) + p.shape) for p in params])
    events = model.sample_seir(gen, batched)
    u = unconstrain_parameters(pack_parameters(params)).expand(C, -1)
    jitter = 0.05 * torch.randn((C, 6), generator=gen, device=device)
    u = torch.cat([u[:, :6] + jitter, u[:, 6:]], dim=1)
    return model, ChainState(u=u, events=events), gen


def event_config(T):
    from covid19uk_tpu_torch.inference.gibbs import EventKernelConfig

    return EventKernelConfig(
        dmax=84, mmax=2, nmax=25, occult_nmax=15, num_event_time_updates=5,
        t_range=(max(0, T - 21), T), num_pair_updates=0,
        fused_sweep="always",
    )


def sweep_inputs(torch, model, state, gen):
    """The fused sweep's inputs as make_mcmc_step forms them."""
    from covid19uk_tpu_torch.inference.gibbs import (
        resolve_event_config, sweep_config)
    from covid19uk_tpu_torch.inference.likelihood import make_context
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.models.spec import (
        constrain_log_det_jacobian, constrain_parameters, unpack_parameters)
    from covid19uk_tpu_torch.ops import fused_sweep as fs

    Mm, Tt = model.data.num_locations, model.num_steps
    Cc = state.u.shape[0]
    scfg = sweep_config(resolve_event_config(event_config(Tt), Mm))
    full_state = seir.compute_state(model.initial_state, state.events)
    commute = model.commute_pressure(full_state[..., 2])
    params = unpack_parameters(constrain_parameters(state.u), Tt, Mm)
    logp = (model.log_prior(params)
            + model.reduced_loglik_fn(state.events, full_state,
                                      commute)(params)
            + constrain_log_det_jacobian(state.u))
    ctx = make_context(model, params)
    decays = torch.full((Cc, 5), 0.9, device=state.u.device)
    tbl, ttbl = fs.draw_tables(gen, Cc, Mm, Tt, scfg, state.u.device)
    args = (tbl, ttbl, state.events, full_state, commute, logp, ctx.exp_eta,
            ctx.psi_w, ctx.rate_ir_t, ctx.N, ctx.Cstar, decays)
    return args, scfg


def outputs_agree(torch, plain, kern):
    """(ok, per-chain bad mask, max abs error, logp relative error)."""
    ev_p, st_p, cm_p, lp_p, tr_p = plain
    ev_k, st_k, cm_k, lp_k, tr_k = kern
    bad = (ev_p != ev_k).flatten(1).any(1) | (st_p != st_k).flatten(1).any(1)
    cm_tol = 1e-5 * cm_p.abs() + 1e-6
    bad |= ((cm_p - cm_k).abs() > cm_tol).flatten(1).any(1)
    lp_rel = (lp_p - lp_k).abs() / lp_p.abs().clamp(min=1.0)
    bad |= lp_rel > 1e-5
    cols = [0] + list(range(2, tr_p.shape[2]))
    bad |= (tr_p[:, :, cols] != tr_k[:, :, cols]).flatten(1).any(1)
    err = max(float((a - b).abs().max()) for a, b in zip(plain, kern))
    return not bool(bad.any()), bad, err, float(lp_rel.max())


def first_difference(torch, fs, args, scfg):
    """Replays the sweep one multiscan at a time and reports the first
    application where a chain's kernel and plain results part, with the
    plain version's margin log(alpha) - log(u) there."""
    tbl, ttbl, ev, st, cm, lp, *ctx = args
    for u in range(scfg.num_updates):
        one = scfg._replace(num_updates=1)
        rec = []
        sub = (tbl[:, u:u + 1], ttbl[:, u:u + 1], ev, st, cm, lp, *ctx)
        plain = fs.fused_sweep_reference(*sub, one, record=rec)
        kern = fs.fused_sweep(*sub, one)
        ok, bad, _, _ = outputs_agree(torch, plain, kern)
        if not ok:
            c = int(bad.nonzero()[0, 0])
            rows = (plain[4][c] != kern[4][c]).any(1).nonzero()
            a = int(rows[0, 0]) if len(rows) else 3
            margin = float(rec[a]["log_alpha"][c] - rec[a]["log_u"][c])
            return (f"chain {c}: first differing application is multiscan "
                    f"{u}, {APPS[a]}; plain log_alpha - log_u = {margin!r}")
        ev, st, cm, lp = plain[:4]
    return "no single multiscan differs"


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def k1_split(torch, fs, args, scfg):
    """Phase 2's part split of K1, CUDA events over 20 repetitions each:
    the wrapper's layout work alone (``fs._kernel_args``: casts, layout
    copies, output allocation), and the kernel alone at U=0 (copy-in and
    guide only), U=1 and the phase's U on arguments prepared once.  The
    per-multiscan part is (t_U - t_1) / (U - 1), the fixed part t_1 less
    one multiscan."""
    from covid19uk_tpu_torch.ops import _build

    lib = _build.fused_sweep_library().lib
    stream = torch.cuda.current_stream().cuda_stream
    U = scfg.num_updates
    layout_ms = cuda_ms(torch, lambda: fs._kernel_args(*args, scfg), 20)
    kernel_ms = {}
    for u in (0, 1, U):
        sub = (args[0][:, :u].contiguous(), args[1][:, :u].contiguous(),
               *args[2:])
        kargs, _ins, _outs = fs._kernel_args(
            *sub, scfg._replace(num_updates=u))

        def launch():
            if lib.fused_sweep_launch(*kargs, stream) != 0:
                raise RuntimeError("fused_sweep launch failed")

        kernel_ms[u] = cuda_ms(torch, launch, 20)
    per = (kernel_ms[U] - kernel_ms[1]) / (U - 1)
    return dict(layout_ms=layout_ms, u0_ms=kernel_ms[0], u1_ms=kernel_ms[1],
                uU_ms=kernel_ms[U],
                per_multiscan_ms=per, fixed_ms=kernel_ms[1] - per)


def phase_kernel(torch, model, state, gen):
    """Phase 2: the kernel against its plain version, both on the card."""
    from covid19uk_tpu_torch.ops import fused_sweep as fs

    t0 = time.perf_counter()
    args, scfg = sweep_inputs(torch, model, state, gen)
    rec = []
    plain = fs.fused_sweep_reference(*args, scfg, record=rec)
    kern = fs.fused_sweep(*args, scfg)
    torch.cuda.synchronize()
    ok, bad, err, lp_rel = outputs_agree(torch, plain, kern)
    if not ok:
        say(f"phase 2 FAILED: {int(bad.sum())} of {bad.numel()} chains "
            f"differ; {first_difference(torch, fs, args, scfg)}")
        raise SystemExit(1)
    ms = cuda_ms(torch, lambda: fs.fused_sweep(*args, scfg), 20)
    plain_ms = cuda_ms(torch, lambda: fs.fused_sweep_reference(*args, scfg),
                       3)
    # bound: each input read once, each output written once; operations
    # counted from this run's windows (record)
    n_bytes = 4 * (sum(a.numel() for a in args) + sum(o.numel()
                                                      for o in kern))
    cells = sum(int(r["rows"].sum()) for r in rec) * model.data.num_locations
    cols = scfg.num_updates * (2 * scfg.mmax + 2) * model.num_steps
    ops = cells * PLANE_OPS + cols * state.u.shape[0] * COL_OPS
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    say(f"phase 2 kernel vs plain: {state.u.shape[0]} chains identical "
        f"(events, state, trace), max abs err {err!r}, logp rel err "
        f"{lp_rel!r}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"({time.perf_counter() - t0:.1f} s)")
    split = k1_split(torch, fs, args, scfg)
    say(f"phase 2 K1 part split: wrapper layout work "
        f"{split['layout_ms']:.4f} ms")
    say(f"phase 2 K1 part split: kernel alone at U=0 (copy-in only) "
        f"{split['u0_ms']:.4f} ms")
    say(f"phase 2 K1 part split: kernel alone at U=1 "
        f"{split['u1_ms']:.4f} ms")
    say(f"phase 2 K1 part split: kernel alone at U={scfg.num_updates} "
        f"{split['uU_ms']:.4f} ms")
    say(f"phase 2 K1 part split: fixed part {split['fixed_ms']:.4f} ms, "
        f"per multiscan {split['per_multiscan_ms']:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, err=err,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def grad_ms(torch, model, state):
    """One value-and-gradient of the HMC density for all chains (a
    transition runs 17 of them), CUDA events over 10 repetitions."""
    from covid19uk_tpu_torch.inference.hmc import value_and_grad
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.models.spec import (
        constrain_log_det_jacobian, constrain_parameters, unpack_parameters)

    Mm, Tt = model.data.num_locations, model.num_steps
    full_state = seir.compute_state(model.initial_state, state.events)
    commute = model.commute_pressure(full_state[..., 2])
    loglik = model.reduced_loglik_fn(state.events, full_state, commute)

    def logdensity(u):
        p = unpack_parameters(constrain_parameters(u), Tt, Mm)
        return model.log_prior(p) + loglik(p) + constrain_log_det_jacobian(u)

    return cuda_ms(torch, lambda: value_and_grad(logdensity, state.u), 10)


def reset_launches():
    from covid19uk_tpu_torch.ops import block_sparse as bs
    from covid19uk_tpu_torch.ops import fused_sweep as fs

    fs.fused_sweep.launches = 0
    bs.bsr_matmul.launches = 0


def read_launches():
    from covid19uk_tpu_torch.ops import block_sparse as bs
    from covid19uk_tpu_torch.ops import fused_sweep as fs

    return {"fused_sweep": fs.fused_sweep.launches,
            "bsr_matmul": bs.bsr_matmul.launches}


def run_transitions(torch, model, state, gen, step, tune, timed):
    """2 untimed and ``timed`` timed transitions; the kernels' launch
    counts are set to 0 just before the timed ones and read just after.
    Checks the invariants: finite logp, non-negative integer events,
    non-negative state.  Returns (state, traces, ms/transition,
    launches, peak MiB)."""
    from covid19uk_tpu_torch.models import seir

    dev = state.u.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for _ in range(N_UNTIMED):
        state, _ = step(state, tune, gen)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    traces = []
    reset_launches()
    t1 = time.perf_counter()
    for _ in range(timed):
        state, tr = step(state, tune, gen)
        traces.append(tr)
    sync()
    wall = time.perf_counter() - t1
    launches = read_launches()
    lp = torch.stack([tr.pair.target_log_prob for tr in traces])
    ev = state.events
    st = seir.compute_state(model.initial_state, ev)
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError("non-finite logp")
    if not (bool((ev >= 0).all()) and bool((ev == torch.round(ev)).all())):
        raise AssertionError("events are not non-negative integers")
    if not bool((st >= -1e-3).all()):
        raise AssertionError("negative state")
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if dev.type == "cuda" else float("nan"))
    return state, traces, wall / timed * 1e3, launches, peak


def acceptance(torch, traces, fields):
    return {f: round(float(torch.stack([getattr(tr, f).is_accepted.float()
                                        for tr in traces]).mean()), 4)
            for f in fields}


def phase_slice(torch, model, state, gen, timed, card=""):
    """Phase 3: the sampling transition; returns (ms/transition, launches
    of K1)."""
    from covid19uk_tpu_torch.inference.gibbs import HMCTunables, make_mcmc_step

    dev = state.u.device
    t0 = time.perf_counter()
    step = make_mcmc_step(model, 16, event_config(model.num_steps))
    tune = HMCTunables(
        step_size=torch.tensor(0.005, device=dev),
        inv_mass_diag=torch.ones(state.u.shape[1], device=dev),
    )
    state, traces, ms, launches, peak = run_transitions(
        torch, model, state, gen, step, tune, timed)
    if dev.type == "cuda" and launches["fused_sweep"] != timed:
        raise AssertionError(f"fused_sweep launched "
                             f"{launches['fused_sweep']} times in {timed} "
                             f"transitions")
    acc = acceptance(torch, traces, ("hmc", "move_se", "move_ei",
                                     "occult_se", "occult_ei"))
    lp = traces[-1].pair.target_log_prob
    say(f"phase 3 slice on {card or 'the CPU'}: {timed} timed transitions, "
        f"{ms:.2f} ms/transition, launches {json.dumps(launches)}, "
        f"acceptance {json.dumps(acc)}, logp mean {float(lp.mean())!r}, "
        f"peak {peak:.0f} MiB ({time.perf_counter() - t0:.1f} s)")
    return ms, launches["fused_sweep"]


def msoa_config(T):
    """tools/bench_msoa.py's event configuration (unfused sweep; threaded
    commute and guided occults resolve on at M >= 1024)."""
    from covid19uk_tpu_torch.inference.gibbs import EventKernelConfig

    return EventKernelConfig(
        dmax=84, mmax=2, nmax=25, occult_nmax=15, num_event_time_updates=5,
        t_range=(T - 21, T), num_pair_updates=1,
    )


def build_msoa(torch, device, M, T, seed=0):
    """The MSOA model (block-sparse commute, banded CAR prior) and one
    chain with forward-simulated events."""
    from covid19uk_tpu_torch.inference.gibbs import ChainState
    from covid19uk_tpu_torch.utils.synthetic import (
        build_synthetic_model, initial_chain_state)

    model = build_synthetic_model(M, T, torch.float32, sparse="auto",
                                  radius_frac=MSOA_RADIUS, keep_C=False,
                                  device=device)
    d = model.data
    if d.Cstar_bsr is None or d.car_band is None:
        raise AssertionError("the MSOA model built no block-sparse commute "
                             "or no banded CAR prior")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    st = initial_chain_state(model, gen)
    return model, ChainState(u=st.u[None], events=st.events[None]), gen


def cold_ms(torch, fn, reps, flush):
    """Median device time of one call of ``fn`` with a cold L2: ``flush``
    (larger than the 50 MB L2) is written before each call, and CUDA
    events bracket the call alone."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in pairs:
        flush.add_(1.0)
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(stop) for start, stop in pairs)
    return times[len(times) // 2]


def phase_k2(torch, model, gen):
    """Phase 4: K2 against its plain version at the MSOA shapes, through
    the main path's call ``Cstar_bsr.matmul`` on an unpadded x: error
    within 1e-5 of |A| @ |x|, one launch a call, bitwise-equal y over two
    calls, x unchanged.  Times by CUDA events (a) the kernel alone, warm
    (K2_REPS back to back), (b) the kernel alone with a cold L2 (median
    of K2_COLD_REPS), (c) the whole call, warm and cold, the plain
    version, and at [M, T] the dense torch.matmul of the same function."""
    from covid19uk_tpu_torch.ops import _build
    from covid19uk_tpu_torch.ops import block_sparse as bs

    t0 = time.perf_counter()
    op = model.data.Cstar_bsr
    values, col_idx = op.values, op.col_idx
    R, K, B, _ = values.shape
    Mm, Tt = model.data.num_locations, model.num_steps
    shapes = [(1, Mm, Tt), (WINDOWED_BATCH[0], Mm, WINDOWED_BATCH[1])]
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    out = {}
    for S, n, t in shapes:
        x = torch.randn((S, n, t), generator=gen, device="cuda")
        x0 = x.clone()
        before = bs.bsr_matmul.launches
        y = op.matmul(x)
        y2 = op.matmul(x)
        torch.cuda.synchronize()
        calls = (bs.bsr_matmul.launches - before) / 2
        plain = bs._plain(values, col_idx, op.perm, op.inv_perm, x)
        scale = bs._plain(values.abs(), col_idx, op.perm, op.inv_perm,
                          x.abs())
        diff = (y - plain).abs()
        err, rel = float(diff.max()), float((diff / (scale + 1e-30)).max())
        same, kept = bool(torch.equal(y, y2)), bool(torch.equal(x, x0))
        if not (rel <= 1e-5 and calls == 1 and same and kept):
            say(f"phase 4 FAILED at x [{S}, {n}, {t}]: error {rel!r} of "
                f"|A|@|x| (max abs {err!r}), {calls} launches a call, "
                f"two calls bitwise equal {same}, x unchanged {kept}")
            raise SystemExit(1)
        # the kernel alone: the main path's arguments, no autograd wrapper
        def alone():
            bs._launch(values, col_idx, x, op.perm32, op.slots, op.order)

        out[(S, t)] = dict(
            err=err, rel=rel,
            ms=cuda_ms(torch, alone, K2_REPS),
            cold_ms=cold_ms(torch, alone, K2_COLD_REPS, flush),
            call_ms=cuda_ms(torch, lambda: op.matmul(x), K2_REPS),
            call_cold_ms=cold_ms(torch, lambda: op.matmul(x), K2_COLD_REPS,
                                 flush),
            plain_ms=cuda_ms(torch, lambda: bs._plain(
                values, col_idx, op.perm, op.inv_perm, x), K2_REPS),
            x=x)
    del flush
    # the library yardstick: the dense product of the same function
    cstar = model.data.Cstar
    x = out[(1, Tt)]["x"][0]
    library_ms = cuda_ms(torch, lambda: torch.matmul(cstar, x), K2_REPS)
    # bounds of the main path's call: the populated blocks' operations and
    # bytes (padded slots and days need no work), x read and y written
    # once, col_idx read once; on the CUDA cores one float32 FMA a term,
    # on the tensor cores three TF32 products a term (3xTF32)
    held = (values != 0).flatten(2)
    populated = int(held.any(2).sum())
    nonzero = float(held.sum()) / (populated * B * B)
    ops = 2.0 * populated * B * B * Tt
    n_bytes = 4 * (populated * B * B + 2 * Mm * Tt + R * K)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    f32_ms = ops / F32_OPS_PER_S * 1e3
    tf32_ms = 3 * ops / TF32_OPS_PER_S * 1e3
    # the kernel's route: the tensor cores
    bound_ms = max(bytes_ms, tf32_ms)
    bound_by = "bytes" if bytes_ms >= tf32_ms else "operations"
    main = out[(1, Tt)]
    lib = _build.block_sparse_library().lib
    tile = bs.tile_days(R, 1, Tt, torch.cuda.get_device_properties(
        0).multi_processor_count)
    say(f"phase 4 K2 at x [{Mm}, {Tt}]: {tile}-day blocks, "
        f"{lib.bsr_matmul_shared_bytes(K, tile)} bytes of dynamic shared "
        f"memory a block; {100 * nonzero:.2f}% of the populated blocks' "
        f"entries are nonzero")
    say(f"phase 4 K2 (R={R}, K={K}, {populated} populated blocks of {R * K})"
        f" bounds at x [{Mm}, {Tt}]: CUDA cores {max(f32_ms, bytes_ms):.4f}"
        f" ms (operations {f32_ms:.4f}), tensor cores 3xTF32 "
        f"{max(tf32_ms, bytes_ms):.4f} ms (bytes {bytes_ms:.4f}, operations"
        f" {tf32_ms:.4f}); this kernel's route: {bound_ms:.4f} ms, "
        f"{bound_by}; dense torch.matmul {library_ms:.4f} ms")
    for (S, t), r in out.items():
        say(f"phase 4 K2 at x [{S}, {Mm}, {t}]: error {r['rel']!r} of "
            f"|A|@|x| (max abs {r['err']!r}), one launch a call, two calls "
            f"bitwise equal, x unchanged; kernel alone {r['ms']:.4f} ms "
            f"warm, {r['cold_ms']:.4f} ms cold L2; whole matmul call "
            f"{r['call_ms']:.4f} ms warm, {r['call_cold_ms']:.4f} ms cold "
            f"L2; plain {r['plain_ms']:.4f} ms")
    say(f"phase 4 done ({time.perf_counter() - t0:.1f} s)")
    return dict(err=max(r["err"] for r in out.values()), ms=main["ms"],
                plain_ms=main["plain_ms"], library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_threaded_sweep(torch, model, state, tune, gen):
    """One more unfused sweep on the final state: the threaded commute
    against a fresh block-sparse product (within 1e-4 of |Cstar| @ |I/N|:
    the rank-1 updates drift), the threaded state against the events'
    cumsum, the threaded logp against a full recomputation; returns the
    sweep's wall time in ms."""
    from covid19uk_tpu_torch.inference.gibbs import (
        event_sweep, resolve_event_config)
    from covid19uk_tpu_torch.inference.likelihood import make_context
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.models.spec import (
        constrain_parameters, unpack_parameters)
    from covid19uk_tpu_torch.ops.block_sparse import BlockSparse

    Mm, Tt = model.data.num_locations, model.num_steps
    cfg = resolve_event_config(msoa_config(Tt), Mm)
    params = unpack_parameters(constrain_parameters(state.u), Tt, Mm)
    st = seir.compute_state(model.initial_state, state.events)
    cm = model.commute_pressure(st[..., 2])
    lp = model.joint_log_prob_unconstrained(state.u, state.events)
    ctx = make_context(model, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = event_sweep(model, cfg, ctx, state.events, st, cm, lp, tune, gen)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    op = model.data.Cstar_bsr
    x = res.state[..., 2] / model.data.N[:, None]
    fresh = op.matmul(x)
    scale = BlockSparse(op.values.abs(), op.col_idx, op.n, op.perm,
                        op.inv_perm).matmul(x.abs())
    drift = float(((res.commute - fresh).abs() / (scale + 1e-30)).max())
    st_err = float((res.state - seir.compute_state(
        model.initial_state, res.events)).abs().max())
    full = model.joint_log_prob_unconstrained(state.u, res.events)
    lp_rel = float(((res.logp - full).abs() / full.abs()).max())
    say(f"threaded sweep check: commute drift {drift!r} of |Cstar|@|I/N|, "
        f"state max abs err {st_err!r}, logp rel err {lp_rel!r} "
        f"(threaded {float(res.logp[0])!r}, full {float(full[0])!r})")
    if not (drift <= 1e-4 and st_err <= 1e-3 and lp_rel <= 1e-3):
        raise AssertionError("the threaded sweep drifted from its state")
    return sweep_ms


def phase_msoa(torch, model, state, gen, timed, card=""):
    """Phase 5: the MSOA transition; returns (ms/transition, K2
    launches, breakdown line)."""
    from covid19uk_tpu_torch.inference.gibbs import HMCTunables, make_mcmc_step

    dev = state.u.device
    t0 = time.perf_counter()
    step = make_mcmc_step(model, 16, msoa_config(model.num_steps))
    tune = HMCTunables(
        step_size=torch.tensor(0.01, device=dev),
        inv_mass_diag=torch.ones(state.u.shape[1], device=dev),
    )
    state, traces, ms, launches, peak = run_transitions(
        torch, model, state, gen, step, tune, timed)
    if dev.type == "cuda" and launches["bsr_matmul"] != timed:
        raise AssertionError(f"bsr_matmul launched "
                             f"{launches['bsr_matmul']} times in {timed} "
                             f"transitions")
    acc = acceptance(torch, traces, ("hmc", "move_se", "move_ei",
                                     "occult_se", "occult_ei", "pair"))
    lp = traces[-1].pair.target_log_prob
    say(f"phase 5 MSOA slice on {card or 'the CPU'} (M="
        f"{model.data.num_locations}, T={model.num_steps}, 1 chain, "
        f"P={state.u.shape[1]}): {timed} timed transitions, {ms:.2f} "
        f"ms/transition, launches {json.dumps(launches)}, acceptance "
        f"{json.dumps(acc)}, logp {float(lp[0])!r}, peak {peak:.0f} MiB "
        f"({time.perf_counter() - t0:.1f} s)")
    breakdown = ""
    if dev.type == "cuda":
        sweep_ms = check_threaded_sweep(torch, model, state, tune, gen)
        breakdown = (f"MSOA breakdown: HMC density value+grad "
                     f"{grad_ms(torch, model, state):.3f} ms (x17 per "
                     f"transition), unfused sweep {sweep_ms:.1f} ms (host "
                     f"clock, one sweep)")
    return ms, launches["bsr_matmul"], breakdown


def rehearse_msoa(torch):
    """The MSOA path on the CPU at a tiny size (operators forced)."""
    from covid19uk_tpu_torch.inference.gibbs import ChainState
    from covid19uk_tpu_torch.utils.synthetic import (
        build_synthetic_model, initial_chain_state)

    model = build_synthetic_model(150, 30, torch.float32, sparse=True,
                                  radius_frac=MSOA_RADIUS, keep_C=False,
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    st = initial_chain_state(model, gen)
    state = ChainState(u=st.u[None], events=st.events[None])
    phase_msoa(torch, model, state, gen, timed=2)


def main(argv):
    rehearse = "--rehearse" in argv
    faulthandler.dump_traceback_later(360, exit=True)
    t0 = time.perf_counter()
    import torch

    if not rehearse and not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from covid19uk_tpu_torch.ops import _build

    if rehearse:
        say("phase 0 rehearsal on the CPU at a tiny size (phases 1, 2 and 4"
            " skipped, no result line)")
        model, state, gen = build_chains(torch, "cpu", **TINY)
        phase_slice(torch, model, state, gen, timed=2)
        rehearse_msoa(torch)
        return 3

    card = card_line()
    say(f"phase 0 card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda} ({time.perf_counter() - t0:.1f} s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t1 = time.perf_counter()
    built = _build.build_all()
    for name, b in built.items():
        say(f"phase 1 nvcc {name} {b.seconds:.1f} s: {ptxas_summary(b.log)}")
    say(f"phase 1 both builds {time.perf_counter() - t1:.1f} s wall")
    sass = sass_counts(built["block_sparse"].lib._name)
    say(f"phase 1 block_sparse SASS (cuobjdump -sass, all template "
        f"instances): {json.dumps(sass) if sass else 'no cuobjdump'}")

    model, state, gen = build_chains(torch, "cuda", M, T, C)
    torch.cuda.synchronize()
    say(f"model and {C} chains on the card ({time.perf_counter() - t0:.1f} s)")
    k1 = phase_kernel(torch, model, state, gen)
    ms, k1_launches = phase_slice(torch, model, state, gen, N_TIMED, card)
    say(f"breakdown: HMC density value+grad {grad_ms(torch, model, state):.3f}"
        f" ms (x17 per transition), fused sweep {k1['ms']:.3f} ms")
    del model, state

    t1 = time.perf_counter()
    msoa, mstate, mgen = build_msoa(torch, "cuda", MSOA_M, MSOA_T)
    torch.cuda.synchronize()
    op = msoa.data.Cstar_bsr
    say(f"MSOA model on the card: block density {op.block_density:.3f}, "
        f"values {tuple(op.values.shape)}, banded CAR "
        f"{tuple(msoa.data.car_band.diag.shape)} "
        f"({time.perf_counter() - t1:.1f} s)")
    k2 = phase_k2(torch, msoa, mgen)
    msoa_ms, k2_launches, breakdown = phase_msoa(torch, msoa, mstate, mgen,
                                                 MSOA_TIMED, card)
    say(f"{breakdown}, K2 {k2['ms']:.4f} ms")

    kernels = [
        dict(name="fused_sweep", route="cuda",
             source="covid19uk_tpu_torch/ops/csrc/fused_sweep.cu",
             replaces="covid19uk_tpu/ops/pallas/fused_sweep.py:751",
             launches=k1_launches, max_abs_err=k1["err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="bsr_matmul", route="cuda",
             source="covid19uk_tpu_torch/ops/csrc/block_sparse.cu",
             replaces="covid19uk_tpu/ops/pallas/block_sparse.py:118",
             launches=k2_launches, max_abs_err=k2["err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=k2["library_ms"]),
    ]
    say(f"{ms:.3f} ms per transition at M={M}, C={C}; {msoa_ms:.3f} ms per "
        f"transition at M={MSOA_M}, one chain; on {card}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
