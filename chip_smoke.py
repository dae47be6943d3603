#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (covid19uk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # on a machine with a card
    python3 chip_smoke.py --rehearse  # tiny CPU run of phases 3, 5-13; exits 3

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
     the threaded commute against a fresh product checked;
  6. the MCMC driver at UK width (run_mcmc: warmup windows 20, 5, 10 and
     10, then 2 bursts of 10 draws, thin 5, autotune and pooled adaptation
     on, the mcmc CLI's event kernels with the fused sweep) on phase 3's
     64 chains, into an in-memory posterior (the card's machine has no
     h5py): one K1 launch per transition (65), final-window HMC
     acceptance in (0, 1], pooled step sizes equal, finite positive step
     sizes and mass, stored samples [4, 64, ...] of non-negative integer
     events; each window's and burst's draws/sec and ms/transition, the
     bursts' host copy, the diagnostics event;
  7. the driver at MSOA width (phase 5's model and chain, windows 10, 4
     and 6, one burst of 5 draws): one K2 launch per transition (25),
     final-window HMC acceptance above 0; the same lines;
  8. the posterior verbs on the card, on phase 6's in-memory posterior (4
     stored draws of 64 chains, M=380, T=120): thin (chains folded into
     256 samples), predict in sample from day T-7 for 7 days and out of
     sample from the last day for 14 days (alpha_t redrawn, the weekday
     covariate extended), R_it over all days in chunks of 50 samples and
     R_t, within/between at the final day.  Checks: predicted events are
     non-negative integers of the expected shapes, no draw exceeds its
     source compartment and the implied state stays non-negative; R_it is
     finite and non-negative, R_t is its N-weighted sum, and R_it at four
     (sample, day) pairs is within 1e-4 relative of a float64 CPU
     recomputation through the same NGM function; within + between = 1
     within 1e-5, and within and between agree with float64 on the CPU
     within 1e-5 of |within| + |between|, on the posterior's final state
     and on a population-count state; and one simulated day at population counts (S up to
     1.2 million, rates up to 3) passes the prediction's checks with its
     total within 6 standard deviations of its mean.  Prints each verb's
     time (host clock after a synchronize) and samples/sec, and R_it's
     peak device memory.
  9. the off-default event kernels (the compensated E->I move, the
     compensated pair move, the gamma refresh), which the fused sweep
     refuses: (a) run_mcmc at UK width on 64 chains with the unfused
     sweep, windows 10, 4, 6 and a burst of 10 (pair moves in warmup):
     no K1 launch, phase 6's checks, the gamma and compensated results
     stored in the JAX driver's layout, gamma-refresh acceptance in (0,
     1], compensated acceptance above 0, finite logp and gamma; prints
     each window's ms/transition, the acceptances, and over every
     accepted compensated move that moved events how many shifted gamma0
     by exactly 0 (float32) against float64 from the same states, and the
     median |shift|; (b) at MSOA width (phase 5's model and chain), 2
     untimed + 3 timed transitions: one K2 launch each, phase 5's
     invariants and threaded-commute check; (c) float64 on the card,
     M=380, 8 chains, 2 transitions with two compensated moves and the
     compensated pair move a multiscan: the threaded logp against the
     joint density (rtol 1e-8, atol 1e-6), and one gamma refresh with
     injected draws against float64 on the CPU (1e-5 relative, same
     decisions; float32's error printed).
 10. the chain-parallel driver over two ranks on the one card (gloo, a
     file store, both ranks on cuda:0; the kernels built by phase 1):
     (a) the dry run, one sharded transition a rank, checksums equal
     across ranks; (b) the sharded UK transition of the 64 chains, 32 a
     rank, fused sweep, on a StepNoise replay, against the one-process
     transition on the same noise in batches of 32 chains: events
     identical, u within rtol 1e-5 (the first differing chain printed);
     (c) run_mcmc with use_mesh on
     phase 6's plan and chains: one K1 launch per transition on each rank,
     the ranks start every window from the same pooled step size, every
     window and burst from the same decays and the slow window from the
     same pooled mass, rank 0's in-memory store holds all 64 chains;
     each rank's ms/transition beside phase 6's; (d) 3 UK transitions
     plain, through the MCMC driver's debug_nans check and wholly inside the
     per-op NaN mode: equal draws, each one's ms/transition.  A failed
     rank fails the run; no rank runs on the CPU.
 11. the space axis over two ranks on the one card (gloo, both on
     cuda:0, one space group: the locations split in two bands, the chains
     not split): (a) the UK transition of the 64 chains, M=380, fused
     sweep, on a StepNoise replay against the one-process transition:
     events identical, u within rtol 1e-5 with an atol of float32's own
     error in the one-process transition (against the same transition in
     float64; the largest difference printed), one K1 launch a rank (K1
     runs on the gathered events on both ranks), the band's commute
     against the whole product's rows;
     (b) run_mcmc with use_mesh and space_devices=2 on phase 6's plan and
     chains: one K1 launch per transition on each rank, rank 0's store
     (4, 64, 380, 120, 3), final-window HMC acceptance in (0, 1], each
     rank's ms/transition beside phase 6's; (c) the MSOA transition at
     M=7168 (56 block rows), one chain, 2 untimed + 3 timed: one K2 launch
     a transition on each rank over its 28 block rows, the band launch
     within 1e-5 of its plain version (of |A|@|x|), the bands summed over
     the ranks bitwise the whole launch, each rank's ms/transition beside
     one process's, K2 timed alone on a band and on all block rows in one
     process; and
     2 transitions at M=7000, whose 55 block rows do not split: the whole
     operator on both ranks (whole launches, no band product).
 12. the off-default event kernels over the space axis, run by phase
     11's two ranks (same spawn, same space group): (a) the UK
     transition of the 64 chains with phase 9's options (unfused sweep,
     compensated move and pair move, gamma refresh) on 11a's inputs and
     HMC draws, the sweep's generator seeded alike on both ranks: both
     ranks' u and gathered events bitwise equal, no K1 launch; against
     one process on the same draws, the chains whose events are equal
     (counted and printed, not held) have u[:, 3:5] within rtol 1e-5
     with 11a's float32 atol, and one process's transition run twice is
     bitwise alike; the transition's ms a rank beside one process's, and
     the unfused sweep alone on both ranks at once beside one process
     alone (host clock, the second of two runs); (b) run_mcmc with
     use_mesh, space_devices=2 and the options on phase 9a's plan and
     chains, the warmup stored too: every window's and burst's u bitwise
     equal on both ranks, rank 0's store (30, 64, 380, 120, 3), the
     refresh's, compensated and pair acceptances in (0, 1], no K1
     launch; each rank's ms/transition beside phase 9a's and its seconds
     in the driver's gathers; (c) the MSOA transition at M=7168 with phase 9b's
     options, one chain, 2 untimed + 3 timed: one K2 launch a transition
     on each rank over its 28 block rows, both ranks bitwise equal,
     ms/transition beside phase 9b's.
 13. the ESS/sec entry points: (a) bench_torch.py's run_benchmark on its
     synthetic full-UK build (M=380, T=120, 64 overdispersed chains,
     fused sweep) with 50 warm draws (per-chain adaptation), an untimed
     and 2 timed segments of 100: bench.py's JSON keys, finite positive
     min-ESS/sec and per-scalar ESS, HMC acceptance of the last segment
     in (0, 1], one K1 launch per transition (250 + 100), no K2 launch;
     (b) the same on build_real, the tracked UK data read without h5py,
     8 chains, 50 warm, an untimed and 1 timed segment of 100; (c)
     bench_mixing_torch.py at NI scale (M=11, T=32, 16 chains) with the
     compensated moves and the gamma refresh, 10 warm and 2 x 30 draws:
     six finite positive ESS, acceptances in [0, 1] (refresh and HMC
     above 0), no kernel launch (the unfused sweep).  Each prints its
     result line, ms/transition and launches.
Then the kernels' JSON line (launches: K1 phase 6's, phase 10c's,
phase 11a-b's on every rank and phase 13a-b's, K2 phases 7, 9b, 11c and
12c's on both ranks; phase 8 launches neither kernel, phases 9a, 12a-b
and 13c must not launch K1) and, last, the result line.  Any failure exits non-zero, as
does a run without a CUDA device.
"""

import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

M, T, C = 380, 120, 64  # full-UK scale (bench.py), 64 chains
TINY = dict(M=12, T=20, C=2)  # --rehearse
N_UNTIMED, N_TIMED = 2, 10
# MSOA scale (tools/bench_msoa.py): one chain, gravity radius 0.05
MSOA_M, MSOA_T, MSOA_RADIUS = 7000, 120, 0.05
MSOA_TIMED = 5
WINDOWED_BATCH = (4, 85)  # the windowed evaluator's [L, M, dmax + 1] shape
# the driver phases: warmup windows, bursts x draws, thin
UK_DRIVER = (dict(first_window=20, slow_window=5, num_slow_windows=2,
                  last_window=10), 2, 10, 5)
MSOA_DRIVER = (dict(first_window=10, slow_window=4, num_slow_windows=1,
                    last_window=6), 1, 5, 1)
# phase 9a: windows 10, 4, 6 and one burst of 10 draws, all stored
OFF_DEFAULT_DRIVER = (dict(first_window=10, slow_window=4, num_slow_windows=1,
                           last_window=6), 1, 10, 1)
OFF_DEFAULT_TIMED = 3  # phase 9b's timed MSOA transitions
F64_CHAINS = 8  # phase 9c
# phase 8: days predicted in sample (from day T-7) and out of sample (from
# the last day); the synthetic covariates' day 0 is a Monday
PREDICT_IN, PREDICT_OUT = 7, 14
ORIGIN_DATE = "2020-10-05"
RIT_CHECKS = 4  # (sample, day) pairs recomputed in float64 on the CPU
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


def build_chains(torch, device, M, T, C, seed=0, dtype=None):
    """bench.py's start: synthetic model (float32 unless ``dtype``),
    chains with independently simulated events and jittered scalar
    parameters."""
    from covid19uk_tpu_torch.inference.gibbs import ChainState
    from covid19uk_tpu_torch.models.spec import (
        Parameters, pack_parameters, unconstrain_parameters)
    from covid19uk_tpu_torch.utils.synthetic import (
        build_synthetic_model, initial_parameters)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = dtype or torch.float32
    model = build_synthetic_model(M, T, dtype, device=device)
    params = initial_parameters(model)
    batched = Parameters(*[p.expand((C,) + p.shape) for p in params])
    events = model.sample_seir(gen, batched)
    u = unconstrain_parameters(pack_parameters(params)).expand(C, -1)
    jitter = 0.05 * torch.randn((C, 6), generator=gen, device=device,
                                dtype=dtype)
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


def build_msoa(torch, device, M, T, seed=0, sparse="auto"):
    """The MSOA model (block-sparse commute, banded CAR prior) and one
    chain with forward-simulated events (``sparse=True`` forces the
    operators below M = 1024, for a rehearsal)."""
    from covid19uk_tpu_torch.inference.gibbs import ChainState
    from covid19uk_tpu_torch.utils.synthetic import (
        build_synthetic_model, initial_chain_state)

    model = build_synthetic_model(M, T, torch.float32, sparse=sparse,
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


def check_threaded_sweep(torch, model, state, tune, gen, ecfg=None):
    """One more unfused sweep (of ``ecfg``, default phase 5's) on the
    final state: the threaded commute against a fresh block-sparse product
    (within 1e-4 of |Cstar| @ |I/N|: the rank-1 updates drift), the
    threaded state against the events' cumsum, the threaded logp against
    a full recomputation at the sweep's gamma0; returns the sweep's wall
    time in ms."""
    from covid19uk_tpu_torch.inference.gibbs import (
        event_sweep, resolve_event_config)
    from covid19uk_tpu_torch.inference.likelihood import make_context
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.models.spec import (
        constrain_parameters, unpack_parameters)
    from covid19uk_tpu_torch.ops.block_sparse import BlockSparse

    Mm, Tt = model.data.num_locations, model.num_steps
    cfg = resolve_event_config(ecfg or msoa_config(Tt), Mm)
    params = unpack_parameters(constrain_parameters(state.u), Tt, Mm)
    st = seir.compute_state(model.initial_state, state.events)
    cm = model.commute_pressure(st[..., 2])
    lp = model.joint_log_prob_unconstrained(state.u, state.events)
    ctx = make_context(model, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = event_sweep(model, cfg, ctx, state.events, st, cm, lp, tune, gen,
                      gamma0=state.u[:, 3])
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
    u = state.u.clone()
    u[:, 3] = res.gamma0
    full = model.joint_log_prob_unconstrained(u, res.events)
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
    """The MSOA path and its driver on the CPU at a tiny size (operators
    forced); returns phase 9b's ms/transition."""
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
    phase_driver(torch, 7, model, state, msoa_config(model.num_steps),
                 MSOA_DRIVER, "bsr_matmul")
    return phase_9b(torch, model, state, gen, timed=2)[1]


class MemoryPosterior:
    """The posterior store's interface (``write_samples``,
    ``write_results``, ``truncate``, ``__getitem__``, ``create_dataset``)
    over numpy arrays in memory, for ``run_mcmc`` where h5py is absent."""

    def __init__(self):
        self.data = {}

    def _write(self, group, d, offset):
        for k, v in d.items():
            name = f"{group}/{k}"
            if isinstance(v, dict):
                self._write(name, v, offset)
                continue
            v = np.asarray(v)
            end = offset + v.shape[0]
            have = self.data.get(name, np.zeros((0,) + v.shape[1:], v.dtype))
            if have.shape[0] < end:
                grow = np.zeros((end - have.shape[0],) + v.shape[1:], v.dtype)
                have = np.concatenate([have, grow])
            have[offset:end] = v
            self.data[name] = have

    def write_samples(self, sample_dict, first_dim_offset):
        self._write("samples", sample_dict, first_dim_offset)

    def write_results(self, results_dict, first_dim_offset):
        self._write("results", results_dict, first_dim_offset)

    def truncate(self, num_draws):
        for k in self.data:
            if k.startswith(("samples/", "results/")):
                self.data[k] = self.data[k][:num_draws]

    def __getitem__(self, key):
        return self.data[key]

    def create_dataset(self, name, data):
        self.data[name] = np.asarray(data)


def uk_driver_config(T):
    """The mcmc CLI's event kernels for the UK driver phase, fused sweep
    on (bench.py's setting); occults in the last 21 days (all days at a
    rehearsal's T < 21)."""
    from covid19uk_tpu_torch.config import McmcConfig
    from covid19uk_tpu_torch.inference.driver import event_kernel_config

    cfg = event_kernel_config(McmcConfig(fused_sweep="always"), T)
    return cfg._replace(t_range=(max(0, T - 21), T))


def phase_driver(torch, phase, model, state, ecfg, plan, kernel, card="",
                 expected=None):
    """Phases 6 and 7: ``run_mcmc`` into a :class:`MemoryPosterior` with
    ``plan = (warmup windows, bursts, draws a burst, thin)``, store_warmup
    off; the kernel's launch count set to 0 just before and read just
    after.  Checks one launch of ``kernel`` per transition (on the card;
    ``expected`` launches in all when given),
    final-window HMC acceptance in (0, 1], the pooled step sizes equal,
    every adapted step size and mass finite and positive, the stored
    samples' shapes and non-negative integer events.  Returns (launches,
    transitions, the store, the bursts' ms per transition with and without
    their host copy)."""
    from covid19uk_tpu_torch.inference.driver import run_mcmc
    from covid19uk_tpu_torch.inference.warmup import WarmupSchedule

    warmup, bursts, draws, thin = plan
    C = state.u.shape[0]
    dev = state.u.device
    transitions = WarmupSchedule(**warmup).total + bursts * draws
    store = MemoryPosterior()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log_file = os.path.join(tmp, "run_log.jsonl")
        cfg = dict(num_chains=C, num_bursts=bursts, num_burst_samples=draws,
                   thin=thin, store_warmup=False, warmup=warmup,
                   autotune_acceptance=True, pooled_adaptation=True,
                   log_file=log_file)
        reset_launches()
        run_mcmc(model, state, ecfg, cfg, store, num_chains=C, seed=0,
                 device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()[kernel]
        with open(log_file) as f:
            events = [json.loads(line) for line in f]
    wall = time.perf_counter() - t0
    windows = [e for e in events if e["event"] == "window"]
    for e in windows + [e for e in events if e["event"] == "burst"]:
        name = e.get("name", "burst")
        copy = (f", host copy {e['copy_ms']!r} ms" if "copy_ms" in e
                else "")
        say(f"phase {phase} {name} {e['draws']} draws: "
            f"{e['draws'] * C / e['wall_s']!r} draws/sec, "
            f"{e['wall_s'] / e['draws'] * 1e3!r} ms/transition, HMC "
            f"acceptance {e['hmc_accept']}{copy}")
    final = windows[-1]
    say(f"phase {phase} final step size {final['adapted_step_size_min']!r} "
        f"to {final['adapted_step_size_max']!r} over {C} chains, mass "
        f"{final['inv_mass_min']!r} to {final['inv_mass_max']!r}")
    stored = bursts * draws // thin
    diag = [e for e in events if e["event"] == "diagnostics"][0]
    say(f"phase {phase} diagnostics over the {stored} stored draws of {C} "
        f"chains ({bursts * draws} sampled, thin {thin}; not a benchmark "
        f"figure): {json.dumps(diag)}")
    M, T = model.data.num_locations, model.num_steps
    chains = () if C == 1 else (C,)
    ev = store["samples/seir"]
    problems = []
    expected = transitions if expected is None else expected
    if dev.type == "cuda" and launches != expected:
        problems.append(f"{kernel} launched {launches} times in "
                        f"{transitions} transitions, not {expected}")
    if not 0.0 < final["hmc_accept"] <= 1.0:
        problems.append(f"final-window HMC acceptance {final['hmc_accept']}")
    for e in windows:
        lo, hi = e["adapted_step_size_min"], e["adapted_step_size_max"]
        if not (np.isfinite([lo, hi]).all() and lo > 0):
            problems.append(f"step size {lo!r}..{hi!r} after a window")
        if e is not final and C > 1 and lo != hi:
            problems.append(f"pooled step sizes differ: {lo!r}..{hi!r}")
        if not (np.isfinite(e["inv_mass_max"]) and e["inv_mass_min"] > 0):
            problems.append(f"mass {e['inv_mass_min']!r}.."
                            f"{e['inv_mass_max']!r}")
    if ev.shape != (stored,) + chains + (M, T, 3) or store[
            "samples/psi"].shape != (stored,) + chains:
        problems.append(f"stored samples {ev.shape}")
    if not ((ev >= 0).all() and (ev == np.round(ev)).all()):
        problems.append("stored events are not non-negative integers")
    if problems:
        raise AssertionError(f"phase {phase}: " + "; ".join(problems))
    say(f"phase {phase} driver on {card or 'the CPU'} (M={M}, T={T}, {C} "
        f"chains): {transitions} transitions, {kernel} launches "
        f"{launches}, stored {ev.shape} ({wall:.1f} s)")
    bursts = [e for e in events if e["event"] == "burst"]
    n = sum(e["draws"] for e in bursts)
    wall_ms = sum(e["wall_s"] for e in bursts) * 1e3
    copy_ms = sum(e.get("copy_ms", 0.0) for e in bursts)
    return launches, transitions, store, (wall_ms / n, (wall_ms - copy_ms) / n)


def timed(torch, dev, fn):
    """(fn's result, its host-clock seconds ending in a synchronize)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def check_prediction(new_init, events, shape):
    """Problems of a prediction: events not of ``shape``, or what
    :func:`seir.simulation_problems` finds."""
    from covid19uk_tpu_torch.models import seir

    problems = seir.simulation_problems(new_init, events)
    if tuple(events.shape) != shape:
        problems.append(f"events {tuple(events.shape)}, expected {shape}")
    return problems


def phase_posterior(torch, dev, store, covariates, init_state, card=""):
    """Phase 8: the posterior verbs on phase 6's in-memory posterior
    through the cores their CLIs call (the card's machine has no h5py
    for the files): thin, predict in and out of sample, R_it and R_t,
    within/between; checks as the module docstring says.  The kernels'
    launch counts are set to 0 just before and read just after (this
    path launches neither).  Returns the phase's wall seconds."""
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.models.ngm import next_generation_matrix_fn
    from covid19uk_tpu_torch.models.spec import ModelData
    from covid19uk_tpu_torch.posterior import reproduction_number as rn
    from covid19uk_tpu_torch.posterior.predict import (
        _params_from_samples, predicted_incidence, prediction_data)
    from covid19uk_tpu_torch.posterior.thin import thin_samples
    from covid19uk_tpu_torch.posterior.within_between import (
        calc_pressure_components)

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    reset_launches()
    problems, lines = [], []

    def report(name, seconds, n):
        lines.append(f"phase 8 {name}: {seconds:.4f} s, {n / seconds!r} "
                     f"samples/sec")

    posterior = {k[len("samples/"):]: v for k, v in store.data.items()
                 if k.startswith("samples/")}
    samples, secs = timed(torch, dev, lambda: thin_samples(
        posterior, init_state, dict(start=0, end=None, by=1)))
    S, M, T = samples["seir"].shape[:3]
    report(f"thin to {S} samples", secs, S)

    # the predict CLI's data: the weekday covariate over the window
    for name, start, days in [("in sample", T - PREDICT_IN, PREDICT_IN),
                              ("out of sample", T - 1, PREDICT_OUT)]:
        data, _ = prediction_data(covariates, ORIGIN_DATE, start + days, dev)
        (new_init, events), secs = timed(torch, dev, lambda: (
            predicted_incidence(samples, init_state, data, start, days,
                                out_of_sample=name == "out of sample",
                                seed=0)))
        report(f"predict {name} from day {start} for {days} days", secs, S)
        problems += [f"predict {name}: {p}" for p in check_prediction(
            new_init, events, (S, M, days, 3))]
        lines.append(f"phase 8 predict {name}: {float(events.sum())!r} "
                     f"events in all, largest S "
                     f"{float(new_init[..., 0].max())!r}")

    # the simulation's binomial draws at population counts (the largest
    # LAD's S, 1.2 million, the synthetic N's upper clip) with large
    # probabilities: the predictions above draw few events where the
    # synthetic epidemic fades by day T
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pop = torch.as_tensor(covariates["N"], dtype=torch.float32, device=dev)
    pop = (pop * (1.2e6 / pop.max())).round()
    counts = torch.stack([pop, (pop / 2).round(), (pop / 3).round(),
                          torch.zeros_like(pop)], -1).expand(S, M, 4)
    rates = 3.0 * torch.rand((S, M, 3), generator=gen, device=dev)
    big = seir.chain_binomial_sample(gen, lambda t, st: rates, counts, 0,
                                     1)
    problems += [f"binomial at population counts: {p}" for p in
                 check_prediction(counts, big, (S, M, 1, 3))]
    mean = counts[..., :3] * -torch.expm1(-rates)
    z = float((big[..., 0, :] - mean).sum() / torch.sqrt(
        (mean * torch.exp(-rates)).sum()))
    lines.append(f"phase 8 binomial at population counts: {S * M * 3} draws"
                 f" from counts up to {float(pop.max())!r}, largest draw "
                 f"{float(big.max())!r}, sum against its mean {z!r} standard"
                 f" deviations")
    if not abs(z) < 6.0:
        problems.append(f"binomial draws' sum is {z!r} standard deviations "
                        f"from its mean")

    data = ModelData.create(covariates, torch.float32, sparse=False,
                            keep_C=False, device=dev)
    if on_card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    times = np.arange(T)
    r_it, secs = timed(torch, dev, lambda: rn.posterior_rit(
        samples, init_state, times, data))
    peak = (f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
            f"({before / 2**20:.0f} MiB held before it)" if on_card
            else "not measured on the CPU")
    r_t = rn.population_weighted(r_it, covariates["N"])
    report(f"R_it [{S}, {T}, {M}] in chunks of {rn.CHUNKSIZE} and R_t", secs,
           S)
    lines.append(f"phase 8 R_it peak device memory {peak}")
    if not (np.isfinite(r_it).all() and (r_it >= 0).all()):
        problems.append("R_it is not finite and non-negative")
    N = np.asarray(covariates["N"], np.float64)
    if not np.allclose(r_t, r_it @ (N / N.sum()), rtol=1e-12, atol=0.0):
        problems.append("R_t is not the N-weighted sum of R_it")
    # four (sample, day) pairs in float64 on the CPU, same NGM function
    cpu = ModelData.create(covariates, torch.float64, sparse=False,
                           keep_C=False, device="cpu")
    rel = 0.0
    for s_, t_ in zip(np.linspace(0, S - 1, RIT_CHECKS).astype(int),
                      np.linspace(0, T - 1, RIT_CHECKS).astype(int)):
        one = {k: v[s_:s_ + 1] for k, v in samples.items()}
        state = seir.compute_state(
            torch.as_tensor(np.asarray(init_state, np.float64)),
            torch.as_tensor(np.asarray(one["seir"], np.float64)))
        params = _params_from_samples(one, dtype=torch.float64)
        want = next_generation_matrix_fn(cpu, params)(
            torch.tensor([t_]), state[:, :, t_:t_ + 1, :].transpose(1, 2)
        ).sum(-2)[0, 0].numpy()
        rel = max(rel, float(np.max(np.abs(r_it[s_, t_] - want)
                                    / np.abs(want))))
    lines.append(f"phase 8 R_it at {RIT_CHECKS} (sample, day) pairs against "
                 f"float64 on the CPU: max relative error {rel!r}")
    if not rel <= 1e-4:
        problems.append(f"R_it differs from float64 by {rel!r} relative")

    wb_data = ModelData.create(covariates, torch.float32, sparse=False,
                               device=dev)
    psi = torch.as_tensor(samples["psi"], dtype=torch.float32, device=dev)

    def pressures():
        events = torch.as_tensor(samples["seir"], dtype=torch.float32,
                                 device=dev)
        init = torch.as_tensor(init_state, dtype=torch.float32, device=dev)
        final = seir.compute_state(init, events)[..., -1, :]
        return calc_pressure_components(wb_data, psi, final), final

    ((within, between), final), secs = timed(torch, dev, pressures)
    report("within/between at the final day", secs, S)
    # a location without infectious people and without commuting pressure
    # has no pressure to split: 0 / 0, as in the JAX package
    total = within + between
    undefined = ~torch.isfinite(total)
    err = float((total[~undefined] - 1.0).abs().max())
    lines.append(f"phase 8 within + between - 1: max abs {err!r} over the "
                 f"{int((~undefined).sum())} of {total.numel()} (sample, "
                 f"location) pairs with pressure; within mean "
                 f"{float(within[~undefined].mean())!r}")
    if not err <= 1e-5:
        problems.append(f"within + between differs from 1 by {err!r}")
    if bool((final[..., 2][undefined] != 0).any()):
        problems.append("within/between undefined where I > 0")
    # the same function in float64 on the CPU, on the posterior's final
    # state (computed anew from the samples) and on the population-count
    # state of the binomial check, where every location carries pressure
    cpu = ModelData.create(covariates, torch.float64, sparse=False,
                           device="cpu")
    psi64 = torch.as_tensor(np.asarray(samples["psi"], np.float64))
    final64 = seir.compute_state(
        torch.as_tensor(np.asarray(init_state, np.float64)),
        torch.as_tensor(np.asarray(samples["seir"], np.float64)))[..., -1, :]
    for name, got, st in [
            ("the posterior's final state", (within, between), final64),
            ("population counts", calc_pressure_components(wb_data, psi,
                                                           counts),
             counts.cpu().double())]:
        want = calc_pressure_components(cpu, psi64, st)
        got = [g.cpu().double() for g in got]
        defined = torch.isfinite(want[0] + want[1])
        if not torch.equal(defined, torch.isfinite(got[0] + got[1])):
            problems.append(f"within/between on {name}: defined at other "
                            f"pairs than float64")
            continue
        scale = (want[0].abs() + want[1].abs())[defined]
        rel = max(float(((g - w)[defined].abs() / scale).max())
                  for g, w in zip(got, want))
        lines.append(f"phase 8 within/between on {name} against float64 "
                     f"on the CPU: max error {rel!r} of |within| + |between|"
                     f" over {int(defined.sum())} of {defined.numel()} "
                     f"(sample, location) pairs")
        if not rel <= 1e-5:
            problems.append(f"within/between on {name} differs from "
                            f"float64 by {rel!r}")

    launches = read_launches()
    for line in lines:
        say(line)
    if problems:
        raise AssertionError("phase 8: " + "; ".join(problems))
    wall = time.perf_counter() - t_phase
    say(f"phase 8 posterior verbs on {card or 'the CPU'} ({S} samples, M={M},"
        f" T={T}): checks passed, launches {json.dumps(launches)} ({wall:.1f}"
        f" s)")
    return wall


def off_default_config(T, **kw):
    """Phase 9's event kernels: the mcmc CLI's with the fused sweep off,
    one compensated E->I move and the compensated pair move (warmup)
    per multiscan, and the gamma refresh; ``kw`` overrides."""
    base = dict(fused_sweep="never", compensate_gamma0=True,
                num_compensated_updates=1, pair_compensate_gamma0=True,
                gamma_gibbs=True)
    base.update(kw)
    return uk_driver_config(T)._replace(**base)


def msoa_off_default_config(T):
    """Phase 9b's (and 12c's) event kernels: phase 5's with the
    compensated E->I move, the compensated pair move and the gamma
    refresh."""
    return msoa_config(T)._replace(compensate_gamma0=True,
                                   pair_compensate_gamma0=True,
                                   gamma_gibbs=True)


class CompensatedRecord:
    """Wraps the transition's two compensated kernels while it is entered:
    every call keeps its gamma0 in and out, its accept flags, whether it
    moved events, and the infectious person-time before and after in
    float64 (exact sums of integer counts), all on the device; nothing is
    read back until :meth:`summary`."""

    KERNELS = {"move": "compensated_move_step",
               "pair": "compensated_pair_move_step"}

    def __enter__(self):
        from covid19uk_tpu_torch.inference import gibbs

        self.calls = {k: [] for k in self.KERNELS}
        self.saved = {k: getattr(gibbs, n) for k, n in self.KERNELS.items()}
        for key, name in self.KERNELS.items():
            setattr(gibbs, name, self._wrap(key, self.saved[key]))
        return self

    def __exit__(self, *exc):
        from covid19uk_tpu_torch.inference import gibbs

        for key, name in self.KERNELS.items():
            setattr(gibbs, name, self.saved[key])

    def _wrap(self, key, fn):
        import torch

        def pt(state):
            return torch.sum(state[..., 2], dim=(-2, -1),
                             dtype=torch.float64)

        def wrapped(gen, events, state, logp, evaluator, gamma, *a, **kw):
            out = fn(gen, events, state, logp, evaluator, gamma, *a, **kw)
            info = out[-1]
            self.calls[key].append((gamma, out[4], info.is_accepted,
                                    info.x_star.sum(-1) > 0, pt(state),
                                    pt(out[1])))
            return out

        return wrapped

    def summary(self, torch, key):
        """Over every call of one kernel: calls, acceptance, the accepted
        moves that moved events; of these, how many shifted gamma0 by
        exactly 0, how many would in float64 from the same states (the
        person-time unchanged), how many shifted it by 0 where float64
        does not and by more where float64 shifts by 0; their median
        |shift|, the median |shift| in float64, and the median relative
        error of the nonzero shifts against float64."""
        rec = self.calls[key]
        if not rec:
            return dict(calls=0)
        g_in, g_out, acc, moved, pt_in, pt_out = [
            torch.stack([r[i] for r in rec]) for i in range(6)]
        real = acc & moved
        shift = (g_out - g_in)[real].double()
        exact = (torch.log(pt_in) - torch.log(pt_out))[real]
        rel = ((shift - exact).abs() / exact.abs())[exact != 0]

        def median(x):
            return float(x.median()) if len(x) else float("nan")

        return dict(
            calls=len(rec), acceptance=float(acc.double().mean()),
            accepted_moving=int(real.sum()),
            zero_shift=int((shift == 0).sum()),
            exact_zero=int((exact == 0).sum()),
            lost=int(((shift == 0) & (exact != 0)).sum()),
            spurious=int(((shift != 0) & (exact == 0)).sum()),
            median_abs_shift=median(shift.abs()),
            median_abs_exact_shift=median(exact.abs()),
            median_rel_err=median(rel))


def sweep_breakdown(torch, model, state, ecfg, gen):
    """Host-clock ms of one unfused sweep of all chains (ending in a
    synchronize, after one untimed) for the plain kernels, with the
    compensated move added (a burst's sweep), and with the compensated
    pair move too (a warmup window's); and of one gamma refresh."""
    from covid19uk_tpu_torch.inference.gamma_gibbs import gamma_gibbs_step
    from covid19uk_tpu_torch.inference.gibbs import (
        HMCTunables, event_sweep, resolve_event_config)
    from covid19uk_tpu_torch.inference.likelihood import make_context
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.models.spec import (
        constrain_parameters, unpack_parameters)

    Mm, Tt = model.data.num_locations, model.num_steps
    dev = state.u.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = unpack_parameters(constrain_parameters(state.u), Tt, Mm)
    st = seir.compute_state(model.initial_state, state.events)
    cm = model.commute_pressure(st[..., 2])
    lp = model.joint_log_prob_unconstrained(state.u, state.events)
    ctx = make_context(model, params)
    tune = HMCTunables(step_size=None, inv_mass_diag=None)

    def ms(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for name, kw in [("plain", dict(compensate_gamma0=False,
                                    num_pair_updates=0)),
                     ("burst", dict(num_pair_updates=0)),
                     ("warmup", {})]:
        cfg = resolve_event_config(ecfg._replace(**kw), Mm)
        out[name] = ms(lambda: event_sweep(model, cfg, ctx, state.events, st,
                                           cm, lp, tune, gen,
                                           gamma0=state.u[:, 3]))
    wd = model._gather_t(model.data.weekday, model._t_abs())
    out["refresh"] = ms(lambda: gamma_gibbs_step(
        gen, state.u[:, 3:5], state.events[..., 2].sum(1),
        st[..., 2].sum(1), wd))
    return out


def phase_9a(torch, dev, M, T, C, card=""):
    """Phase 9a: ``run_mcmc`` at full UK width with the off-default event
    kernels (unfused sweep, compensated move and pair move, gamma
    refresh), windows 10, 4, 6 and a burst of 10; K1 must not launch.
    Checks phase 6's, and the stored gamma refresh and compensated-move
    results in the JAX driver's layout, gamma-refresh acceptance in (0,
    1], compensated acceptance above 0, finite logp and gamma0/gamma1.
    Returns the burst's ms per transition with and without its host
    copy."""
    model, state, gen = build_chains(torch, dev, M, T, C)
    t0 = time.perf_counter()
    ecfg = off_default_config(T)
    with CompensatedRecord() as rec:
        _, _, store, burst_ms = phase_driver(torch, "9a", model, state, ecfg,
                                   OFF_DEFAULT_DRIVER, "fused_sweep", card,
                                   expected=0)
    draws = OFF_DEFAULT_DRIVER[1] * OFF_DEFAULT_DRIVER[2]
    chains = () if C == 1 else (C,)
    comp = "results/move/E->I_compensated/"
    want = {"results/gamma/is_accepted": ((), np.bool_),
            "results/gamma/log_accept_ratio": ((), np.float32),
            comp + "is_accepted": ((), np.bool_),
            comp + "target_log_prob": ((), np.float32),
            comp + "proposed_delta": ((4, ecfg.mmax), np.float32)}
    problems = []
    held = sorted(k for k in store.data
                  if k.startswith(("results/gamma/", comp)))
    if held != sorted(want):
        problems.append(f"stored {held}")
    for k, (tail, dtype) in want.items():
        a = store.data.get(k)
        if a is None or a.shape != (draws,) + chains + tail or \
                a.dtype != dtype:
            got = None if a is None else (a.shape, a.dtype)
            problems.append(f"{k}: {got}")
    gamma_acc = float(store["results/gamma/is_accepted"].mean())
    if not 0.0 < gamma_acc <= 1.0:
        problems.append(f"gamma-refresh acceptance {gamma_acc!r}")
    for k in ("results/hmc/target_log_prob", comp + "target_log_prob",
              "samples/gamma0", "samples/gamma1"):
        if not np.isfinite(store[k]).all():
            problems.append(f"{k} is not finite")
    stats = {k: rec.summary(torch, k) for k in rec.KERNELS}
    if not stats["move"].get("acceptance", 0.0) > 0.0:
        problems.append(f"compensated moves: {stats['move']}")
    if problems:
        raise AssertionError("phase 9a: " + "; ".join(problems))
    say(f"phase 9a gamma refresh acceptance {gamma_acc!r} over the {draws} "
        f"stored draws of {C} chains")
    split = sweep_breakdown(torch, model, state, ecfg, gen)
    hmc = (f"{grad_ms(torch, model, state):.3f} ms" if dev == "cuda"
           else "not measured on the CPU")
    say(f"phase 9a breakdown (host clock, one call on the {C} starting "
        f"chains): unfused sweep {split['plain']:.1f} ms with the plain "
        f"kernels, {split['burst']:.1f} ms with the compensated move (a "
        f"burst's), {split['warmup']:.1f} ms with the compensated pair move "
        f"too (a window's); gamma refresh {split['refresh']:.2f} ms; HMC "
        f"value+grad {hmc} (x17 per transition)")
    for k, st in stats.items():
        say(f"phase 9a compensated {k} over the run ({st['calls']} calls of "
            f"{C} chains): acceptance {st['acceptance']!r}; of the "
            f"{st['accepted_moving']} accepted moves that moved events, "
            f"{st['zero_shift']} shifted gamma0 by exactly 0 "
            f"({st['exact_zero']} in float64 from the same states; 0 where "
            f"float64 is not: {st['lost']}, not 0 where float64 is: "
            f"{st['spurious']}); median |shift| {st['median_abs_shift']!r} "
            f"(float64: "
            f"{st['median_abs_exact_shift']!r}), median relative error of "
            f"the shift {st['median_rel_err']!r}")
    say(f"phase 9a done ({time.perf_counter() - t0:.1f} s)")
    return burst_ms


def phase_9b(torch, model, state, gen, timed, card=""):
    """Phase 9b: the off-default kernels at MSOA width (phase 5's model
    and chain, threaded commute): ``timed`` transitions after 2 untimed,
    one K2 launch each, phase 5's invariants, and on the card its
    threaded-commute check.  Returns (K2's launches, ms/transition)."""
    from covid19uk_tpu_torch.inference.gibbs import HMCTunables, make_mcmc_step

    dev = state.u.device
    t0 = time.perf_counter()
    ecfg = msoa_off_default_config(model.num_steps)
    step = make_mcmc_step(model, 16, ecfg)
    tune = HMCTunables(
        step_size=torch.tensor(0.01, device=dev),
        inv_mass_diag=torch.ones(state.u.shape[1], device=dev),
    )
    state, traces, ms, launches, peak = run_transitions(
        torch, model, state, gen, step, tune, timed)
    if dev.type == "cuda" and launches["bsr_matmul"] != timed:
        raise AssertionError(f"phase 9b: bsr_matmul launched "
                             f"{launches['bsr_matmul']} times in {timed} "
                             f"transitions")
    acc = acceptance(torch, traces, ("hmc", "comp_ei", "pair", "gamma"))
    say(f"phase 9b MSOA off-default kernels on {card or 'the CPU'} (M="
        f"{model.data.num_locations}, 1 chain): {timed} timed transitions, "
        f"{ms:.2f} ms/transition, launches {json.dumps(launches)}, "
        f"acceptance {json.dumps(acc)}, peak {peak:.0f} MiB")
    if dev.type == "cuda":
        check_threaded_sweep(torch, model, state, tune, gen, ecfg)
    say(f"phase 9b done ({time.perf_counter() - t0:.1f} s)")
    return launches["bsr_matmul"], ms


def phase_9c(torch, dev, M, T, C):
    """Phase 9c: float64 on ``dev``: 2 transitions with two compensated
    moves and the compensated pair move a multiscan (gamma refresh off),
    the threaded logp against the joint density of the new state (rtol
    1e-8, atol 1e-6); then one gamma refresh of C chains with injected
    draws against float64 on the CPU (within 1e-5 relative, the same
    decisions), and the float32 refresh's error beside it."""
    from covid19uk_tpu_torch.inference.gamma_gibbs import (
        GammaNoise, gamma_gibbs_step)
    from covid19uk_tpu_torch.inference.gibbs import HMCTunables, make_mcmc_step

    t0 = time.perf_counter()
    model, state, gen = build_chains(torch, dev, M, T, C,
                                     dtype=torch.float64)
    step = make_mcmc_step(model, 16, off_default_config(
        T, num_compensated_updates=2, gamma_gibbs=False))
    tune = HMCTunables(
        step_size=torch.tensor(0.005, device=dev, dtype=torch.float64),
        inv_mass_diag=torch.ones(state.u.shape[1], device=dev,
                                 dtype=torch.float64))
    problems, worst = [], 0.0
    with CompensatedRecord() as rec:
        for _ in range(2):
            state, tr = step(state, tune, gen)
            full = model.joint_log_prob_unconstrained(state.u, state.events)
            lp = tr.comp_ei.target_log_prob
            worst = max(worst, float(((lp - full).abs()
                                      / (1e-6 + 1e-8 * full.abs())).max()))
    stats = {k: rec.summary(torch, k) for k in rec.KERNELS}
    if not worst <= 1.0:
        problems.append(f"threaded logp {worst!r} of the tolerance from the "
                        f"joint density")
    if not stats["move"]["accepted_moving"] > 0:
        problems.append("no compensated move accepted: the check is vacuous")
    say(f"phase 9c float64 transitions of {C} chains: threaded logp against "
        f"the joint density, largest error {worst!r} of the tolerance (rtol "
        f"1e-8, atol 1e-6); accepted compensated moves that moved events: "
        f"{stats['move']['accepted_moving']} of "
        f"{stats['move']['calls'] * C}, pair moves "
        f"{stats['pair']['accepted_moving']} of "
        f"{stats['pair']['calls'] * C}")

    rng = np.random.default_rng(0)
    wd = (np.arange(T) % 7 < 5).astype(float)
    K = rng.integers(200, 3000, (C, T)).astype(float)
    N = K * rng.uniform(3.0, 8.0, (C, T))
    g = np.stack([np.log(-np.log1p(-K.sum(1) / N.sum(1))), np.zeros(C)], 1)
    g += rng.normal(0.0, 0.05, (C, 2))
    draws = (rng.normal(size=(C, 2)), rng.chisquare(5.0, C),
             rng.uniform(size=C))

    def refresh(device, dtype):
        def t(a):
            return torch.tensor(a, dtype=dtype, device=device)

        g_new, info = gamma_gibbs_step(None, t(g), t(K), t(N),
                                       t(wd - wd.mean()),
                                       noise=GammaNoise(*map(t, draws)))
        return g_new.cpu().double(), info.is_accepted.cpu()

    want, want_acc = refresh("cpu", torch.float64)
    rels = []
    differ = []
    for dtype in (torch.float64, torch.float32):
        got, got_acc = refresh(dev, dtype)
        rels.append(float(((got - want).abs()
                           / want.abs().clamp(min=1e-3)).max()))
        differ.append(int((got_acc != want_acc).sum()))
    if not (rels[0] <= 1e-5 and differ[0] == 0):
        problems.append(f"float64 refresh {rels[0]!r} from the CPU's, "
                        f"{differ[0]} decisions differ")
    say(f"phase 9c gamma refresh of {C} chains (T={T}) on {dev}: float64 "
        f"within {rels[0]!r} relative of float64 on the CPU, the same "
        f"decisions; float32 within {rels[1]!r}, {differ[1]} decisions "
        f"differ; {int(want_acc.sum())} of {C} accepted")
    if problems:
        raise AssertionError("phase 9c: " + "; ".join(problems))
    say(f"phase 9c done ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phase 10: the chain-parallel driver over two ranks on one device.
# ---------------------------------------------------------------------------

RANKS = 2  # phase 10's ranks (mesh_scale.py asks for more)
NAN_TRANSITIONS = 3  # phase 10d
STEP_SIZE = 0.005  # phases 3, 9c and 10: a step size that accepts at C=64


def record_runners(driver, calls):
    """Wraps the MCMC driver's window and burst runners so that each call
    appends (kind, step sizes, inverse mass, decays) as it starts; returns
    the originals."""
    from covid19uk_tpu_torch.inference import dual_averaging

    originals = driver.make_window_runner, driver.make_fixed_runner

    def host(x):
        return np.asarray(x.detach().cpu())

    def note(kind, step_size, inv_mass, decays):
        calls.append((kind, host(step_size), host(inv_mass),
                      [float(d) for d in decays or ()]))

    def window_runner(*a, **k):
        run = originals[0](*a, **k)

        def wrapped(state, da, wf, inv_mass, gen=None, decays=None):
            note("window", dual_averaging.step_size(da), inv_mass, decays)
            return run(state, da, wf, inv_mass, gen, decays)

        return wrapped

    def fixed_runner(*a, **k):
        run = originals[1](*a, **k)

        def wrapped(state, step_size, inv_mass, gen=None, decays=None):
            note("burst", step_size, inv_mass, decays)
            return run(state, step_size, inv_mass, gen, decays)

        return wrapped

    driver.make_window_runner, driver.make_fixed_runner = (window_runner,
                                                           fixed_runner)
    return originals


def rank_worker(argv):
    """One rank of phase 10b-c: ``--rank-worker <dir> <rank> <device>``
    (sizes in ``<dir>/spec.json``).  10b: the sharded transition on the
    parent's StepNoise, every chain's result to rank 0; 10c: ``run_mcmc``
    with ``use_mesh`` on phase 6's plan, K1's launches and the wall time
    counted on each rank, what each runner starts from recorded.  Writes
    ``<dir>/rank<r>.pkl``."""
    import pickle

    tmp, rank, device = argv[0], int(argv[1]), argv[2]
    faulthandler.dump_traceback_later(300, exit=True)
    import torch

    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    if device == "cpu":
        torch.set_num_threads(1)  # tiny shapes; the ranks share the host
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from covid19uk_tpu_torch.inference import driver
    from covid19uk_tpu_torch.inference.gibbs import (
        ChainState, HMCTunables, StepNoise, make_mcmc_step)
    from covid19uk_tpu_torch.parallel import distributed
    from covid19uk_tpu_torch.parallel.mesh import chain_mesh
    from covid19uk_tpu_torch.parallel.sharding import (
        gather_chains, make_sharded_step, shard_chain_state, shard_tunables)

    ranks = spec["ranks"]
    distributed.initialize(f"file://{tmp}/store", ranks, rank)
    try:
        dev = distributed.local_device(device)
        if dev.type != device:
            raise AssertionError(f"rank {rank} on {dev}, not {device}")
        sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                else (lambda: None))
        Mm, Tt, Cc = spec["M"], spec["T"], spec["C"]
        report = {"rank": rank, "device": str(dev), "name": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")}
        mesh = chain_mesh()
        model, state, _ = build_chains(torch, dev, Mm, Tt, Cc)

        # 10b: the sharded step on the parent's inputs and noise
        with np.load(os.path.join(tmp, "step.npz")) as z:
            inp = {k: torch.as_tensor(z[k], device=dev) for k in z.files}
        full = ChainState(u=inp["u"], events=inp["events"])
        noise = StepNoise(inp["z"], inp["u_accept"], inp["tbl"], inp["ttbl"])
        tune = HMCTunables(
            step_size=torch.full((Cc, 1), STEP_SIZE, device=dev),
            inv_mass_diag=torch.ones_like(full.u))
        step = make_sharded_step(
            make_mcmc_step(model, 16, event_config(Tt)), mesh)
        reset_launches()
        new, _ = step(shard_chain_state(full, mesh),
                      shard_tunables(tune, mesh), None, noise)
        sync()
        report["step_launches"] = read_launches()["fused_sweep"]
        report["step"] = gather_chains(
            (new.u.cpu().numpy(), new.events.cpu().numpy()), mesh, dst=0)

        # 10c: the driver over the ranks, phase 6's plan and chains
        warmup, bursts, draws, thin = spec["plan"]
        log_file = os.path.join(tmp, "run_log.jsonl") if rank == 0 else None
        cfg = dict(num_chains=Cc, num_bursts=bursts, num_burst_samples=draws,
                   thin=thin, store_warmup=False, warmup=warmup,
                   autotune_acceptance=True, pooled_adaptation=True,
                   use_mesh=True, log_file=log_file)
        store = MemoryPosterior() if rank == 0 else None
        calls = []
        originals = record_runners(driver, calls)
        reset_launches()
        sync()
        t0 = time.perf_counter()
        out = driver.run_mcmc(model, state, uk_driver_config(Tt), cfg, store,
                              num_chains=Cc, seed=0, device=dev)
        sync()
        report["wall_s"] = time.perf_counter() - t0
        driver.make_window_runner, driver.make_fixed_runner = originals
        report["launches"] = read_launches()["fused_sweep"]
        report["calls"] = calls
        report["returned_store"] = out is not None
        if rank == 0:
            report["store"] = {k: v.shape for k, v in store.data.items()}
            report["events_ok"] = bool(
                (store["samples/seir"] >= 0).all()
                and (store["samples/seir"] == np.round(
                    store["samples/seir"])).all())
            with open(log_file) as f:
                report["log"] = [json.loads(line) for line in f]
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(report, f)
        say(f"phase 10 rank {rank} on {report['name']} ({dev}) done")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(tmp, device, ranks, worker="--rank-worker",
                prefix="phase 10"):
    """Runs ``ranks`` ranks of ``worker`` to their end and relays their
    lines that start with ``prefix``; raises with their output if one
    fails."""
    from covid19uk_tpu_torch.parallel.distributed import run_ranks

    outs = run_ranks(lambda r: [
        sys.executable, os.path.abspath(__file__), worker, tmp,
        str(r), device], ranks, timeout=600)
    for out in outs:
        for line in out.strip().splitlines():
            if line.startswith(prefix):
                say(line)


def phase_10(torch, dev, M, T, C, plan, phase6_ms, card="", ranks=RANKS):
    """Phase 10: ``ranks`` ranks on ``dev`` (a file store; on one card
    all on ``cuda:0`` over gloo, on as many cards as ranks one each over
    NCCL).  10a: the dry run (``parallel/distributed.py:
    spawn_dryrun``): one sharded transition a rank, checksums equal; 10b:
    the sharded transition of C chains (C/ranks a rank, fused sweep) on a
    StepNoise replay against the one-process transition on the same noise
    in batches of C/ranks chains: events identical, u within rtol 1e-5,
    one K1 launch a rank; 10c:
    ``run_mcmc`` with ``use_mesh`` on ``plan``: one K1 launch per
    transition on each rank, the ranks start every window from the same
    pooled step size and every window and burst from the same decays, the
    slow window from the same pooled mass, rank 0's store holds all C
    chains, final-window HMC acceptance in (0, 1]; prints each rank's ms
    per transition beside phase 6's.  Returns (K1 launches of 10c on all
    ranks, its transitions, its bursts' ms per transition)."""
    import pickle

    from covid19uk_tpu_torch.inference.gibbs import (
        HMCTunables, StepNoise, make_mcmc_step, resolve_event_config,
        sweep_config)
    from covid19uk_tpu_torch.inference.warmup import WarmupSchedule
    from covid19uk_tpu_torch.ops import fused_sweep as fs
    from covid19uk_tpu_torch.parallel.distributed import spawn_dryrun

    t0 = time.perf_counter()
    checksum, out = spawn_dryrun(ranks, dev.type)
    say(f"phase 10a dry run over {ranks} ranks: checksum {checksum!r} on "
        f"every rank; {out.strip().splitlines()[-1]} "
        f"({time.perf_counter() - t0:.1f} s)")

    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        model, state, gen = build_chains(torch, dev, M, T, C)
        scfg = sweep_config(resolve_event_config(event_config(T), M))
        P = state.u.shape[1]
        tbl, ttbl = fs.draw_tables(gen, C, M, T, scfg, dev)
        noise = StepNoise(torch.randn((C, P), generator=gen, device=dev),
                          torch.rand((C,), generator=gen, device=dev),
                          tbl, ttbl)
        np.savez(os.path.join(tmp, "step.npz"),
                 u=state.u.cpu().numpy(), events=state.events.cpu().numpy(),
                 z=noise.z.cpu().numpy(), u_accept=noise.u_accept.cpu()
                 .numpy(), tbl=tbl.cpu().numpy(), ttbl=ttbl.cpu().numpy())
        tune = HMCTunables(
            step_size=torch.full((C, 1), STEP_SIZE, device=dev),
            inv_mass_diag=torch.ones_like(state.u))
        step = make_mcmc_step(model, 16, event_config(T))
        whole, _ = step(state, tune, None, noise)
        whole_u = whole.u.cpu().numpy()
        # the like-for-like one-process transition: in batches of a rank's
        # C / ranks chains on one device (float32 rounds a smaller batch's
        # sums otherwise)
        batch = C // ranks

        def rows(x, b):
            return type(x)(*[None if v is None else v[b:b + batch]
                             for v in x])

        split = [step(rows(state, b), rows(tune, b), None, rows(noise, b))[0]
                 for b in range(0, C, batch)]
        want_u = torch.cat([x.u for x in split]).cpu().numpy()
        want_ev = torch.cat([x.events for x in split]).cpu().numpy()
        del model, state, whole, split
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(dict(M=M, T=T, C=C, plan=plan, ranks=ranks), f)
        t1 = time.perf_counter()
        spawn_ranks(tmp, dev.type, ranks)
        wall = time.perf_counter() - t1
        reports = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                reports.append(pickle.load(f))

    # 10b
    got_u, got_ev = reports[0]["step"]

    def compare(u, ev):
        """(chains whose events differ, u's max relative difference, the
        first u entry off by more than rtol 1e-5 as (chain, index, got,
        want) or None)."""
        diff = np.nonzero((ev != want_ev).reshape(C, -1).any(1))[0]
        rel = float(np.max(np.abs(u - want_u)
                           / np.maximum(np.abs(want_u), 1e-30)))
        bad = np.argwhere(~np.isclose(u, want_u, rtol=1e-5, atol=0.0))
        first = None if not len(bad) else (
            int(bad[0, 0]), int(bad[0, 1]), float(u[tuple(bad[0])]),
            float(want_u[tuple(bad[0])]))
        return diff, rel, first, len({int(c) for c in bad[:, 0]})

    diff, rel, first, n_bad = compare(got_u, got_ev)
    if len(diff):
        problems.append(f"10b: events of {len(diff)} chains differ, first "
                        f"chain {int(diff[0])}")
    if first is not None:
        problems.append(f"10b: u of {n_bad} chains off by more than rtol "
                        f"1e-5; first (chain, index, got, want) {first}")
    on_card = dev.type == "cuda"
    if on_card and any(r["step_launches"] != 1 for r in reports):
        problems.append(f"10b: K1 launches per rank "
                        f"{[r['step_launches'] for r in reports]}, not 1")
    say(f"phase 10b sharded transition of {C} chains ({batch} a rank, "
        f"M={M}, T={T}) against the one-process transition in batches of "
        f"{batch} on the same StepNoise: events of {C - len(diff)} of {C} "
        f"chains identical, u max relative difference {rel!r} (bitwise "
        f"equal: {bool(np.array_equal(got_u, want_u))}), K1 launches per "
        f"rank {[r['step_launches'] for r in reports]}")
    w_rel = float(np.max(np.abs(got_u - whole_u)
                         / np.maximum(np.abs(whole_u), 1e-30)))
    say(f"phase 10b against one batch of all {C} chains instead: u max "
        f"relative difference {w_rel!r} (bitwise equal: "
        f"{bool(np.array_equal(got_u, whole_u))})")

    # 10c
    warmup, bursts, draws, thin = plan
    transitions = WarmupSchedule(**warmup).total + bursts * draws
    launches = [r["launches"] for r in reports]
    if on_card and launches != [transitions] * ranks:
        problems.append(f"10c: K1 launches per rank {launches} in "
                        f"{transitions} transitions each")
    devices = [f"cuda:{r % torch.cuda.device_count()}" if on_card else "cpu"
               for r in range(ranks)]
    if [r["device"] for r in reports] != devices:  # no rank on another
        problems.append(f"10c: rank devices {[r['device'] for r in reports]}")
    a = reports[0]["calls"]  # every rank against rank 0
    for b in (r["calls"] for r in reports[1:]):
        if [c[0] for c in a] != [c[0] for c in b]:
            problems.append("10c: the ranks ran different windows and bursts")
        for i, (ca, cb) in enumerate(zip(a, b)):
            if ca[3] != cb[3]:
                problems.append(f"10c: call {i} decays {ca[3]} vs {cb[3]}")
            if ca[0] == "window" and not (np.array_equal(ca[1], cb[1])
                                          and len(set(ca[1].tolist())) == 1):
                problems.append(f"10c: window {i} pooled step sizes differ")
        if len(a) > 1 and not (np.array_equal(a[1][2], b[1][2])
                               and (a[1][2] == a[1][2][0]).all()):
            problems.append("10c: the slow window's pooled mass differs")
    stored = bursts * draws // thin
    shapes = reports[0]["store"]
    if (tuple(shapes["samples/seir"]) != (stored, C, M, T, 3)
            or tuple(shapes["samples/psi"]) != (stored, C)
            or not reports[0]["events_ok"]):
        problems.append(f"10c: rank 0's store {shapes['samples/seir']}")
    if [r["returned_store"] for r in reports] != [True] + [False] * (
            ranks - 1):
        problems.append("10c: a store on a rank other than 0")
    log = reports[0]["log"]
    final = [e for e in log if e["event"] == "window"][-1]
    if not 0.0 < final["hmc_accept"] <= 1.0:
        problems.append(f"10c: final-window HMC acceptance "
                        f"{final['hmc_accept']}")
    burst_ms = [e["wall_s"] / e["draws"] * 1e3 for e in log
                if e["event"] == "burst"]
    for e in log:
        if e["event"] in ("window", "burst"):
            say(f"phase 10c {e.get('name', 'burst')} {e['draws']} draws: "
                f"{e['draws'] * C / e['wall_s']!r} draws/sec over the ranks,"
                f" {e['wall_s'] / e['draws'] * 1e3!r} ms/transition, HMC "
                f"acceptance {e['hmc_accept']}")
    for r in reports:
        say(f"phase 10c rank {r['rank']} on {r['device']}: {r['launches']} "
            f"K1 launches in {transitions} transitions of {C // ranks} "
            f"chains, {r['wall_s'] / transitions * 1e3!r} ms/transition "
            f"over the whole run")
    say(f"phase 10c bursts {burst_ms} ms/transition over {ranks} ranks of "
        f"{C // ranks} chains against phase 6's {phase6_ms!r} on one "
        f"process of {C}; final step size {final['adapted_step_size_min']!r}"
        f" to {final['adapted_step_size_max']!r}; rank 0's store "
        f"{shapes['samples/seir']}")
    if problems:
        raise AssertionError("phase 10: " + "; ".join(problems))
    say(f"phase 10b-c on {card or 'the CPU'}: {wall:.1f} s for the ranks")
    return sum(launches), transitions, burst_ms


def phase_10d(torch, dev, M, T, C, card=""):
    """Phase 10d: ``NAN_TRANSITIONS`` transitions of phase 3's chains three
    ways from one generator seed: plain, through the MCMC driver's
    ``debug_nans`` check (``nans.checked_step``) and wholly inside the
    per-op mode (``nans.NanCheck``, what a transition with a NaN is run
    again in); the draws must be equal; prints each one's ms/transition
    (host clock ending in a synchronize)."""
    from covid19uk_tpu_torch.inference.gibbs import HMCTunables, make_mcmc_step
    from covid19uk_tpu_torch.utils import nans

    t0 = time.perf_counter()
    dev = torch.device(dev)
    model, state, _ = build_chains(torch, dev, M, T, C)
    step = make_mcmc_step(model, 16, event_config(T))
    tune = HMCTunables(step_size=torch.tensor(STEP_SIZE, device=dev),
                       inv_mass_diag=torch.ones(state.u.shape[1], device=dev))

    def run(fn):
        gen = torch.Generator(device=dev).manual_seed(1)

        def transitions():
            s = state
            for _ in range(NAN_TRANSITIONS):
                s, _ = fn(s, tune, gen)
            return s

        out, seconds = timed(torch, dev, transitions)
        return out, seconds / NAN_TRANSITIONS * 1e3

    plain, plain_ms = run(step)
    checked, checked_ms = run(nans.checked_step(step))
    with nans.NanCheck():
        per_op, per_op_ms = run(step)
    same = [bool(torch.equal(plain.u, o.u) and torch.equal(plain.events,
                                                           o.events))
            for o in (checked, per_op)]
    say(f"phase 10d debug_nans on {card or 'the CPU'} ({C} chains, M={M}): "
        f"{NAN_TRANSITIONS} transitions plain {plain_ms!r} ms/transition, "
        f"with the MCMC driver's checked_step {checked_ms!r}, "
        f"inside the per-op mode "
        f"{per_op_ms!r}; draws equal to plain: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(same):
        raise AssertionError(f"phase 10d: draws with debug_nans differ "
                             f"{same}")


# ---------------------------------------------------------------------------
# Phase 11: the space axis, the location axis sharded over ranks.
# ---------------------------------------------------------------------------

SPACE = 2  # phase 11's space axis (mesh_scale.py --space asks for more)
MSOA_SPACE_M = 7168  # 56 block rows: bands over 2 and 4 ranks
SPACE_TIMED = 3  # 11c's timed MSOA transitions
SPACE_FALLBACK = 2  # 11c's transitions at M = 7000 (55 block rows)
# 11b's plan in a rehearsal: every window and a burst, 12 transitions
REHEARSE_DRIVER = (dict(first_window=4, slow_window=2, num_slow_windows=1,
                        last_window=2), 1, 4, 2)
OFF_SPACE_SEED = 12  # 12a's sweep generators: chain slice k seeded 12 + k
# the off-default kernels' results whose acceptance 12b holds in (0, 1]
OFF_RESULTS = ("gamma", "move/E->I_compensated", "move/S->E+E->I_pair")


# phase 13: bench_torch.py's run at full UK width with fewer draws (13a),
# its real-data build (13b), bench_mixing_torch.py at NI scale (13c)
BENCH_UK = dict(warm_draws=50, n_draws=100, n_seeds=2)
BENCH_REAL_CHAINS = 8
BENCH_REAL = dict(warm_draws=50, n_draws=100, n_seeds=1)
MIXING_FLAGS = ["--scale", "ni", "--gamma-gibbs", "--pair-comp",
                "--warm", "10", "--draws", "30"]
# bench.py's result keys, in its order
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "sd", "seeds",
              "chains", "runs", "ess_diag_not_mixing"]
# --rehearse: the synthetic run tiny; the real data keep their M=380,
# T=120 on 2 chains and a few transitions
REHEARSE_BENCH = (dict(M=8, T=24, C=2),
                  dict(warm_draws=4, n_draws=6, n_seeds=2))
REHEARSE_REAL = (2, dict(warm_draws=20, n_draws=4, n_seeds=1))
REHEARSE_MIXING = ["--chains", "2", "--warm", "4", "--draws", "8"]


def digest(*tensors):
    """The sha256 of the tensors' bytes in order: equal digests are
    bitwise equal tensors."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def record_u_digests(driver, digests):
    """Wraps the MCMC driver's window and burst runners so that each call
    appends the :func:`digest` of the chains' u it ends with to
    ``digests``; returns the originals."""
    originals = driver.make_window_runner, driver.make_fixed_runner

    def wrap(make):
        def runner(*a, **k):
            run = make(*a, **k)

            def wrapped(*args):
                out = run(*args)
                digests.append(digest(out[0].u))
                return out

            return wrapped

        return runner

    driver.make_window_runner, driver.make_fixed_runner = map(wrap,
                                                              originals)
    return originals


def space_worker(argv):
    """One rank of phases 11 and 12: ``--space-worker <dir> <rank>
    <device>`` (sizes in ``<dir>/spec.json``).  11a: the space-sharded
    transition on the parent's StepNoise, K1's launches, the band's
    commute against the whole product; 12a: the same transition with the
    off-default kernels, the sweep's generator seeded alike; 11b:
    ``run_mcmc`` with ``use_mesh`` and ``space_devices`` on phase 6's
    plan; 12b: the same with the off-default kernels on phase 9a's plan,
    each window's u recorded; 11c: the MSOA transition with K2 on the
    rank's band of block rows (launches, band rows, the band launch
    against its plain version, the summed bands against the whole
    launch), 12c: the same with phase 9b's options, and 11c's replicated
    operator at M = 7000.  Writes ``<dir>/space<r>.pkl``."""
    import pickle

    tmp, rank, device = argv[0], int(argv[1]), argv[2]
    faulthandler.dump_traceback_later(600, exit=True)
    import torch

    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    if device == "cpu":
        torch.set_num_threads(1)  # tiny shapes; the ranks share the host
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from covid19uk_tpu_torch.inference import driver
    from covid19uk_tpu_torch.inference.gibbs import (
        ChainState, HMCTunables, StepNoise, make_mcmc_step)
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.ops import block_sparse as bs
    from covid19uk_tpu_torch.parallel import distributed
    from covid19uk_tpu_torch.parallel.mesh import axis, chain_space_mesh
    from covid19uk_tpu_torch.parallel.sharding import (
        SpaceBand, chain_rows, gather_chains, gather_space,
        make_sharded_step, shard_chain_state, shard_tunables)

    ranks, space = spec["ranks"], spec["space"]
    distributed.initialize(f"file://{tmp}/store", ranks, rank)
    try:
        dev = distributed.local_device(device)
        if dev.type != device:
            raise AssertionError(f"rank {rank} on {dev}, not {device}")
        on_card = dev.type == "cuda"
        sync = ((lambda: torch.cuda.synchronize(dev)) if on_card
                else (lambda: None))
        Mm, Tt, Cc = spec["M"], spec["T"], spec["C"]
        report = {"rank": rank, "device": str(dev)}
        mesh = chain_space_mesh(ranks, space)
        slices, chain_rank = axis(mesh, "chain")
        lead = axis(mesh, "space")[1] == 0
        model, state, _ = build_chains(torch, dev, Mm, Tt, Cc)

        # 11a: the sharded step on the parent's inputs and noise
        with np.load(os.path.join(tmp, "step.npz")) as z:
            inp = {k: torch.as_tensor(z[k], device=dev) for k in z.files}
        full = ChainState(u=inp["u"], events=inp["events"])
        noise = StepNoise(inp["z"], inp["u_accept"], inp["tbl"], inp["ttbl"])
        tune = HMCTunables(
            step_size=torch.full((Cc, 1), STEP_SIZE, device=dev),
            inv_mass_diag=torch.ones_like(full.u))
        band = SpaceBand(mesh, Mm)
        mine = shard_chain_state(full, mesh, shard_space=True)
        whole = inp["commute"][chain_rows(Cc, mesh)][:, band.rows]
        cm = model.commute_pressure(seir.compute_state(
            model.initial_state[band.rows], mine.events)[..., 2], band)
        got = cm[:, band.rows]
        report["commute"] = (bool(torch.equal(got, whole)), float(
            ((got - whole).abs() / (whole.abs() + 1e-30)).max()))
        step = make_sharded_step(
            make_mcmc_step(model, 16, event_config(Tt), band), mesh,
            shard_space=True)
        sync()
        reset_launches()
        t0 = time.perf_counter()
        new, _ = step(mine, shard_tunables(tune, mesh), None, noise)
        sync()
        report["step_ms"] = (time.perf_counter() - t0) * 1e3
        report["step_launches"] = read_launches()["fused_sweep"]
        events = gather_space(new.events.cpu().numpy(), mesh, 1,
                              to_lead=True)
        report["step"] = None if not lead else gather_chains(
            (new.u.cpu().numpy(), events), mesh, dst=0)

        # 12a: the transition with the off-default kernels on the same
        # inputs and HMC draws, one sweep generator a chain slice, seeded
        # alike on its ranks
        p12 = report["p12"] = {"chain_rank": chain_rank}
        ostep = make_sharded_step(
            make_mcmc_step(model, 16, off_default_config(Tt), band), mesh,
            shard_space=True)
        ogen = torch.Generator(device=dev)
        reset_launches()
        for _ in range(2):  # the same transition twice: the second timed
            ogen.manual_seed(OFF_SPACE_SEED + chain_rank)
            sync()
            t0 = time.perf_counter()
            new, tr = ostep(mine, shard_tunables(tune, mesh), ogen,
                            noise._replace(tbl=None, ttbl=None))
            sync()
        p12["a_ms"] = (time.perf_counter() - t0) * 1e3
        p12["a_k1"] = read_launches()["fused_sweep"]
        # the sweep alone (no collective) on the whole chains, the ranks
        # of the card starting together
        torch.distributed.barrier()
        p12["a_sweep"] = sweep_breakdown(torch, model, state,
                                         off_default_config(Tt), ogen)
        events = band.gather(new.events, 1)
        p12["a_digest"] = digest(new.u, events)
        p12["a_acc"] = {f: float(getattr(tr, f).is_accepted.float().mean())
                        for f in ("hmc", "comp_ei", "pair", "gamma")}
        p12["a_step"] = None if not lead else gather_chains(
            (new.u.cpu().numpy(), events.cpu().numpy()), mesh, dst=0)
        del full, noise, mine, new, cm, got, whole, inp, events, tr

        # 11b: the driver with the location axis sharded, phase 6's plan
        warmup, bursts, draws, thin = spec["plan"]
        log_file = os.path.join(tmp, "space_log.jsonl") if rank == 0 else None
        cfg = dict(num_chains=Cc, num_bursts=bursts, num_burst_samples=draws,
                   thin=thin, store_warmup=False, warmup=warmup,
                   autotune_acceptance=True, pooled_adaptation=True,
                   use_mesh=True, space_devices=space, log_file=log_file)
        store = MemoryPosterior() if rank == 0 else None
        sync()
        reset_launches()
        t0 = time.perf_counter()
        driver.run_mcmc(model, state, uk_driver_config(Tt), cfg, store,
                        num_chains=Cc, seed=0, device=dev)
        sync()
        report["wall_s"] = time.perf_counter() - t0
        report["launches"] = read_launches()["fused_sweep"]
        if rank == 0:
            report["store"] = {k: v.shape for k, v in store.data.items()}
            report["events_ok"] = bool(
                (store["samples/seir"] >= 0).all()
                and (store["samples/seir"] == np.round(
                    store["samples/seir"])).all())
            with open(log_file) as f:
                report["log"] = [json.loads(line) for line in f]
        del store

        # 12b: the driver with the off-default kernels on phase 9a's plan,
        # the warmup draws stored too (the pair moves run in warmup)
        warmup, bursts, draws, thin = spec["off_plan"]
        log_file = os.path.join(tmp, "off_log.jsonl") if rank == 0 else None
        cfg = dict(num_chains=Cc, num_bursts=bursts, num_burst_samples=draws,
                   thin=thin, store_warmup=True, warmup=warmup,
                   autotune_acceptance=True, pooled_adaptation=True,
                   use_mesh=True, space_devices=space, log_file=log_file)
        store = MemoryPosterior() if rank == 0 else None
        digests = []
        originals = record_u_digests(driver, digests)
        # the seconds the driver spends in its gathers through the host
        gathers = {"gather_space": 0.0, "gather_chains": 0.0}
        saved = {k: getattr(driver, k) for k in gathers}

        def clocked(name):
            def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return saved[name](*a, **k)
                finally:
                    gathers[name] += time.perf_counter() - t

            return wrapped

        for k in gathers:
            setattr(driver, k, clocked(k))
        sync()
        reset_launches()
        t0 = time.perf_counter()
        driver.run_mcmc(model, state, off_default_config(Tt), cfg, store,
                        num_chains=Cc, seed=0, device=dev)
        sync()
        p12["b_wall_s"] = time.perf_counter() - t0
        driver.make_window_runner, driver.make_fixed_runner = originals
        for k in gathers:
            setattr(driver, k, saved[k])
        p12["b_gathers"] = gathers
        p12["b_k1"] = read_launches()["fused_sweep"]
        p12["b_digests"] = digests
        if rank == 0:
            p12["b_store"] = {k: v.shape for k, v in store.data.items()}
            p12["b_acc"] = {k: float(store[f"results/{k}/is_accepted"]
                                     .mean()) for k in OFF_RESULTS}
            p12["b_ok"] = bool(
                all(np.isfinite(store[k]).all() for k in (
                    "samples/gamma0", "samples/gamma1",
                    "results/hmc/target_log_prob"))
                and (store["samples/seir"] >= 0).all()
                and (store["samples/seir"] == np.round(
                    store["samples/seir"])).all())
            with open(log_file) as f:
                p12["b_log"] = [json.loads(line) for line in f]
        del model, state, store

        # 11c: the MSOA transition, K2 on the rank's band of block rows;
        # then at M = 7000, whose 55 block rows do not split
        report["msoa"] = {}
        for Mx, timed_n in ((spec["msoa_M"], spec["msoa_timed"]),
                            (spec["fallback_M"], SPACE_FALLBACK)):
            msoa, one, _ = build_msoa(torch, dev, Mx, spec["msoa_T"],
                                      sparse=spec["sparse"])
            Cm = slices  # one chain a chain slice
            mstate = ChainState(*[x.expand((Cm,) + x.shape[1:]).contiguous()
                                  for x in one])
            mband = SpaceBand(mesh, Mx)
            op = msoa.data.Cstar_bsr
            rows = mband.bsr_band(op)
            mstep = make_sharded_step(make_mcmc_step(
                msoa, 16, msoa_config(spec["msoa_T"]), mband), mesh,
                shard_space=True)
            mtune = shard_tunables(HMCTunables(
                step_size=torch.full((Cm, 1), 0.01, device=dev),
                inv_mass_diag=torch.ones_like(mstate.u)), mesh)
            gen = torch.Generator(device=dev)
            gen.manual_seed(driver.rank_seed(0, chain_rank, slices))
            st = shard_chain_state(mstate, mesh, shard_space=True)
            for _ in range(N_UNTIMED if Mx == spec["msoa_M"] else 0):
                st, _ = mstep(st, mtune, gen)
            sync()
            calls = bs.bsr_band_matmul.calls
            reset_launches()
            t0 = time.perf_counter()
            for _ in range(timed_n):
                st, tr = mstep(st, mtune, gen)
            sync()
            out = {"ms": (time.perf_counter() - t0) / timed_n * 1e3,
                   "launches": read_launches()["bsr_matmul"],
                   "band_calls": bs.bsr_band_matmul.calls - calls,
                   "rows": None if rows is None else rows.rows,
                   "R": op.col_idx.shape[0], "timed": timed_n,
                   "finite": bool(torch.isfinite(
                       tr.hmc.target_log_prob).all())}
            if rows is not None:  # the band launch, outside the count
                x = (seir.compute_state(msoa.initial_state, one.events)
                     [..., 2] / msoa.data.N[:, None])
                y = rows.matmul(x)
                plain = bs._plain_band(op.values, op.col_idx, op.perm,
                                       rows.r0, rows.r1, x)
                scale = bs._plain(op.values.abs(), op.col_idx, op.perm,
                                  op.inv_perm, x.abs())
                out["band_err"] = float(((y - plain).abs()
                                         / (scale + 1e-30)).max())
                out["bitwise"] = bool(torch.equal(mband.sum(y.clone()),
                                                  op.matmul(x)))
            report["msoa"][Mx] = out
            if Mx == spec["msoa_M"]:
                # 12c: phase 9b's options on the same band, from the same
                # start
                ostep = make_sharded_step(make_mcmc_step(
                    msoa, 16, msoa_off_default_config(spec["msoa_T"]),
                    mband), mesh, shard_space=True)
                gen.manual_seed(driver.rank_seed(0, chain_rank, slices))
                st = shard_chain_state(mstate, mesh, shard_space=True)
                for _ in range(N_UNTIMED):
                    st, _ = ostep(st, mtune, gen)
                sync()
                calls = bs.bsr_band_matmul.calls
                reset_launches()
                t0 = time.perf_counter()
                for _ in range(timed_n):
                    st, tr = ostep(st, mtune, gen)
                sync()
                p12["c"] = {
                    "ms": (time.perf_counter() - t0) / timed_n * 1e3,
                    "launches": read_launches()["bsr_matmul"],
                    "band_calls": bs.bsr_band_matmul.calls - calls,
                    "rows": out["rows"], "R": out["R"], "timed": timed_n,
                    "finite": bool(torch.isfinite(
                        tr.hmc.target_log_prob).all()),
                    "digest": digest(st.u, mband.gather(st.events, 1)),
                    "acc": {f: float(getattr(tr, f).is_accepted.float()
                                     .mean())
                            for f in ("hmc", "comp_ei", "pair", "gamma")}}
            del msoa, one, mstate, st, op, rows
        with open(os.path.join(tmp, f"space{rank}.pkl"), "wb") as f:
            pickle.dump(report, f)
        say(f"phase 11 rank {rank} on {dev} done")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def one_process_msoa(torch, dev, M, T, C, n, sparse, space):
    """The MSOA transition of ``C`` chains in one process: ms per
    transition over ``n`` after 2 untimed; on the card also K2 alone
    (CUDA events) on rank 0's band of ``space`` bands of block rows and on
    all of them, at the transition's ``x [1, M, T]``, and the band's bound
    (its populated blocks, x and the band's rows of y moved once over the
    card's memory rate, or its 3xTF32 products over the tensor cores'
    rate, the larger).  Returns (ms per transition, band ms, whole ms,
    band bound ms)."""
    from covid19uk_tpu_torch.inference.gibbs import (
        ChainState, HMCTunables, make_mcmc_step)
    from covid19uk_tpu_torch.models import seir

    model, one, gen = build_msoa(torch, dev, M, T, sparse=sparse)
    band_ms = whole_ms = bound_ms = None
    op = model.data.Cstar_bsr
    if dev.type == "cuda" and op.col_idx.shape[0] % space == 0:
        x = (seir.compute_state(model.initial_state, one.events)[..., 2]
             / model.data.N[:, None])
        band = op.row_band(0, space)
        band_ms = cuda_ms(torch, lambda: band.matmul(x), K2_REPS)
        whole_ms = cuda_ms(torch, lambda: op.matmul(x), K2_REPS)
        B = op.values.shape[2]
        blocks = int((op.values[band.r0:band.r1] != 0).flatten(2).any(2)
                     .sum())
        n_bytes = 4 * (blocks * B * B + M * T + band.rows * B * T
                       + band.rows * op.col_idx.shape[1])
        ops = 3 * 2.0 * blocks * B * B * T
        bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                       ops / TF32_OPS_PER_S) * 1e3
    state = ChainState(*[x.expand((C,) + x.shape[1:]).contiguous()
                         for x in one])
    step = make_mcmc_step(model, 16, msoa_config(T))
    tune = HMCTunables(step_size=torch.full((C, 1), 0.01, device=dev),
                       inv_mass_diag=torch.ones_like(state.u))
    for _ in range(N_UNTIMED):
        state, _ = step(state, tune, gen)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, tune, gen)
    sync()
    return ((time.perf_counter() - t0) / n * 1e3, band_ms, whole_ms,
            bound_ms)


def phase_11(torch, dev, M, T, C, plan, phase6_ms, card="", ranks=RANKS,
             space=SPACE, msoa_M=MSOA_SPACE_M, fallback_M=MSOA_M,
             msoa_T=MSOA_T, msoa_timed=SPACE_TIMED, sparse="auto",
             off_plan=OFF_DEFAULT_DRIVER, phase9a_ms=None, phase9b_ms=None):
    """Phase 11: ``ranks`` ranks on ``dev`` as a (chain, space) mesh of
    ``space`` ranks a space group (on one card all on ``cuda:0`` over
    gloo, on as many cards as ranks one each over NCCL).  11a: the
    transition of C chains with their locations sharded (fused sweep) on
    a StepNoise replay against the one-process transition: events
    identical, u within rtol 1e-5 and an atol of float32's own error in
    the one-process transition (largest difference printed), one K1
    launch a rank, the band's commute against the rows of the whole
    product; 11b: ``run_mcmc`` with ``use_mesh`` and ``space_devices`` on
    ``plan``: one K1 launch per transition on each rank, rank 0's store
    of all C chains and M locations, final-window HMC acceptance in (0,
    1], each rank's ms/transition beside phase 6's; 11c: the MSOA
    transition at ``msoa_M`` (one chain a chain slice): one K2 launch a
    transition on each rank over its band of ``R / space`` block rows,
    the band launch within 1e-5 of its plain version (of ``|A| @ |x|``),
    the bands summed over the group bitwise the whole launch, each rank's
    ms/transition beside one process's; and at ``fallback_M``, whose
    block rows do not split, the whole operator on every rank.  The same
    ranks then run phase 12 (:func:`phase_12`), the off-default kernels
    over the space axis, on ``off_plan``.  Returns (K1 launches of 11a
    and 11b, K2 launches of 11c and 12c, on all ranks; 11b's bursts' ms
    per transition; 11c's ms per transition of each rank and of one
    process)."""
    import pickle

    from covid19uk_tpu_torch.inference.gibbs import (
        HMCTunables, StepNoise, make_mcmc_step, resolve_event_config,
        sweep_config)
    from covid19uk_tpu_torch.inference.warmup import WarmupSchedule
    from covid19uk_tpu_torch.models import seir
    from covid19uk_tpu_torch.ops import fused_sweep as fs

    t0 = time.perf_counter()
    problems = []
    on_card = dev.type == "cuda"
    slices = ranks // space
    with tempfile.TemporaryDirectory() as tmp:
        model, state, gen = build_chains(torch, dev, M, T, C)
        scfg = sweep_config(resolve_event_config(event_config(T), M))
        P = state.u.shape[1]
        tbl, ttbl = fs.draw_tables(gen, C, M, T, scfg, dev)
        noise = StepNoise(torch.randn((C, P), generator=gen, device=dev),
                          torch.rand((C,), generator=gen, device=dev),
                          tbl, ttbl)
        commute = model.commute_pressure(seir.compute_state(
            model.initial_state, state.events)[..., 2])
        np.savez(os.path.join(tmp, "step.npz"),
                 u=state.u.cpu().numpy(), events=state.events.cpu().numpy(),
                 z=noise.z.cpu().numpy(), u_accept=noise.u_accept.cpu()
                 .numpy(), tbl=tbl.cpu().numpy(), ttbl=ttbl.cpu().numpy(),
                 commute=commute.cpu().numpy())
        tune = HMCTunables(
            step_size=torch.full((C, 1), STEP_SIZE, device=dev),
            inv_mass_diag=torch.ones_like(state.u))
        step = make_mcmc_step(model, 16, event_config(T))
        want, _ = step(state, tune, None, noise)
        want_u, want_ev = want.u.cpu().numpy(), want.events.cpu().numpy()
        # float32's own error in this transition: the same transition of
        # the model in float64 on the same inputs and noise
        model64 = build_chains(torch, dev, M, T, 1, dtype=torch.float64)[0]
        want64, _ = make_mcmc_step(model64, 16, event_config(T))(
            type(state)(*[x.double() for x in state]),
            HMCTunables(*[x.double() for x in tune[:2]]), None,
            noise._replace(z=noise.z.double(),
                           u_accept=noise.u_accept.double()))
        f32_err = float((want.u.double() - want64.u).abs().max())
        # 12a's one-process transition with the off-default kernels, in
        # batches of a chain slice's chains, each with its slice's seed
        # (twice: the second timed, and bitwise the first), and its sweep
        # alone on the whole chains
        ostep = make_mcmc_step(model, 16, off_default_config(T))
        per = C // slices
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        runs = []
        for _ in range(2):
            sync()
            t1 = time.perf_counter()
            off = [ostep(*[type(x)(*[None if v is None else v[k:k + per]
                                     for v in x])
                           for x in (state, tune)],
                         torch.Generator(device=dev).manual_seed(
                             OFF_SPACE_SEED + k // per),
                         StepNoise(noise.z[k:k + per],
                                   noise.u_accept[k:k + per]))[0]
                   for k in range(0, C, per)]
            sync()
            runs.append((torch.cat([x.u for x in off]).cpu().numpy(),
                         torch.cat([x.events for x in off]).cpu().numpy()))
        off_one = dict(ms=(time.perf_counter() - t1) * 1e3,
                       repeat=all(np.array_equal(a, b)
                                  for a, b in zip(*runs)),
                       sweep=sweep_breakdown(torch, model, state,
                                             off_default_config(T), gen))
        off_u, off_ev = runs[1]
        del model, state, want, commute, noise, model64, want64, off, runs
        one_ms, band_ms, whole_ms, bound_ms = one_process_msoa(
            torch, dev, msoa_M, msoa_T, slices, msoa_timed, sparse, space)
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(dict(M=M, T=T, C=C, plan=plan, ranks=ranks,
                           space=space, msoa_M=msoa_M, fallback_M=fallback_M,
                           msoa_T=msoa_T, msoa_timed=msoa_timed,
                           sparse=sparse, off_plan=off_plan), f)
        t1 = time.perf_counter()
        spawn_ranks(tmp, dev.type, ranks, "--space-worker", "phase 11")
        wall = time.perf_counter() - t1
        reports = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"space{r}.pkl"), "rb") as f:
                reports.append(pickle.load(f))

    mesh = f"{slices} x {space} (chain x space)"
    # 11a
    got_u, got_ev = reports[0]["step"]
    diff = np.nonzero((got_ev != want_ev).reshape(C, -1).any(1))[0]
    rel = np.abs(got_u - want_u) / np.maximum(np.abs(want_u), 1e-30)
    worst = np.unravel_index(int(np.argmax(rel)), rel.shape)
    # rtol 1e-5, and for near-zero entries an atol of float32's own
    # error in the one-process transition (its largest distance from the
    # same transition in float64): the ranks sum the bands' parts, and
    # float32 rounds those sums otherwise
    bad = np.argwhere(~np.isclose(got_u, want_u, rtol=1e-5, atol=f32_err))
    strict = len({int(c) for c in np.argwhere(~np.isclose(
        got_u, want_u, rtol=1e-5, atol=0.0))[:, 0]})
    if len(diff):
        problems.append(f"11a: events of {len(diff)} chains differ, first "
                        f"chain {int(diff[0])}")
    if len(bad):
        problems.append(f"11a: u of {len({int(c) for c in bad[:, 0]})} "
                        f"chains off by more than rtol 1e-5 (atol "
                        f"{f32_err!r}), first "
                        f"{tuple(int(i) for i in bad[0])}")
    launches = [r["step_launches"] for r in reports]
    if on_card and launches != [1] * ranks:
        problems.append(f"11a: K1 launches per rank {launches}, not 1")
    commute = [r["commute"] for r in reports]
    if max(c[1] for c in commute) > 1e-5:
        problems.append(f"11a: the band's commute off the whole product's "
                        f"rows by {commute}")
    say(f"phase 11a sharded transition over a {mesh} mesh of {C} chains "
        f"(M={M} locations, {M // space} a rank, T={T}) against the "
        f"one-process transition on the same StepNoise: events of "
        f"{C - len(diff)} of {C} chains identical, u max relative "
        f"difference {float(rel[worst])!r} at {tuple(int(i) for i in worst)}"
        f" ({float(got_u[worst])!r} against {float(want_u[worst])!r}; "
        f"bitwise equal: {bool(np.array_equal(got_u, want_u))}; largest "
        f"absolute difference {float(np.abs(got_u - want_u).max())!r} "
        f"against float32's own error {f32_err!r} in the one-process "
        f"transition; {strict} chains off by more than rtol 1e-5 with atol"
        f" 0), K1 "
        f"launches per rank {launches}; the band's commute against the "
        f"whole product's rows (bitwise, max relative difference) "
        f"{commute}; ms per rank {[round(r['step_ms'], 3) for r in reports]}")

    # 11b
    warmup, bursts, draws, thin = plan
    transitions = WarmupSchedule(**warmup).total + bursts * draws
    k1 = [r["launches"] for r in reports]
    if on_card and k1 != [transitions] * ranks:
        problems.append(f"11b: K1 launches per rank {k1} in {transitions} "
                        f"transitions each")
    stored = bursts * draws // thin
    shapes = reports[0]["store"]
    if (tuple(shapes["samples/seir"]) != (stored, C, M, T, 3)
            or not reports[0]["events_ok"]):
        problems.append(f"11b: rank 0's store {shapes['samples/seir']}")
    log = reports[0]["log"]
    final = [e for e in log if e["event"] == "window"][-1]
    if not 0.0 < final["hmc_accept"] <= 1.0:
        problems.append(f"11b: final-window HMC acceptance "
                        f"{final['hmc_accept']}")
    burst_ms = [e["wall_s"] / e["draws"] * 1e3 for e in log
                if e["event"] == "burst"]
    for e in log:
        if e["event"] in ("window", "burst"):
            say(f"phase 11b {e.get('name', 'burst')} {e['draws']} draws: "
                f"{e['draws'] * C / e['wall_s']!r} draws/sec, "
                f"{e['wall_s'] / e['draws'] * 1e3!r} ms/transition, HMC "
                f"acceptance {e['hmc_accept']}")
    say(f"phase 11b driver over a {mesh} mesh: bursts {burst_ms} "
        f"ms/transition against phase 6's {phase6_ms!r} on one process; "
        f"each rank's whole run "
        f"{[r['wall_s'] / transitions * 1e3 for r in reports]} "
        f"ms/transition; K1 launches per rank {k1} in {transitions} "
        f"transitions; final-window HMC acceptance {final['hmc_accept']}; "
        f"rank 0's store {shapes['samples/seir']}")

    # 11c
    k2 = 0
    msoa_ms = {}
    for Mx in (msoa_M, fallback_M):
        outs = [r["msoa"][Mx] for r in reports]
        o = outs[0]
        n, R = o["timed"], o["R"]
        split = R % space == 0
        k2 += sum(x["launches"] for x in outs)
        if on_card and [x["launches"] for x in outs] != [n] * ranks:
            problems.append(f"11c M={Mx}: K2 launches per rank "
                            f"{[x['launches'] for x in outs]} in {n}")
        calls = [x["band_calls"] for x in outs]
        if calls != ([n] * ranks if split else [0] * ranks):
            problems.append(f"11c M={Mx}: band products per rank {calls}")
        if split and [x["rows"] for x in outs] != [R // space] * ranks:
            problems.append(f"11c M={Mx}: band rows "
                            f"{[x['rows'] for x in outs]}")
        if not all(x["finite"] for x in outs):
            problems.append(f"11c M={Mx}: non-finite logp")
        if split:
            errs = [x["band_err"] for x in outs]
            if max(errs) > 1e-5:
                problems.append(f"11c: band launch off its plain version "
                                f"by {errs} of |A|@|x|")
            if not all(x["bitwise"] for x in outs):
                problems.append("11c: the bands summed differ from the "
                                "whole launch")
            msoa_ms = {"ranks": [x["ms"] for x in outs], "one": one_ms,
                       "k2_band_ms": band_ms, "k2_whole_ms": whole_ms,
                       "k2_band_bound_ms": bound_ms}
            times = ""
            if on_card:
                times = (f"; K2 alone in one process (CUDA events) on rank "
                         f"0's {R // space} block rows {band_ms!r} ms "
                         f"(bound {bound_ms!r} ms), on all {R} "
                         f"{whole_ms!r} ms")
            say(f"phase 11c MSOA M={Mx} (R={R} block rows) over a {mesh} "
                f"mesh, {slices} chain(s): {n} timed transitions, "
                f"{[x['ms'] for x in outs]} ms/transition per rank against "
                f"one process's {one_ms!r}; K2 launches per rank "
                f"{[x['launches'] for x in outs]}, each over "
                f"{o['rows']} block rows; band launch against its plain "
                f"version {errs} of |A|@|x|; bands summed bitwise the "
                f"whole launch on every rank: "
                f"{[x['bitwise'] for x in outs]}{times}")
        else:
            say(f"phase 11c MSOA M={Mx} (R={R} block rows, not a multiple of"
                f" {space}): the operator stays whole on every rank; {n} "
                f"transitions, {[x['ms'] for x in outs]} ms/transition per "
                f"rank, K2 launches per rank "
                f"{[x['launches'] for x in outs]} (whole launches), band "
                f"products {calls}")
    if problems:
        raise AssertionError("phase 11: " + "; ".join(problems))
    say(f"phase 11 on {card or 'the CPU'}: {wall:.1f} s for the ranks "
        f"({time.perf_counter() - t0:.1f} s)")
    k2 += phase_12(reports, (off_u, off_ev, off_one), f32_err, M, T, C,
                   off_plan, mesh, on_card, phase9a_ms, phase9b_ms, card)
    k1_all = sum(launches) + sum(k1)
    return k1_all, k2, burst_ms, msoa_ms


def phase_12(reports, one, f32_err, M, T, C, plan, mesh, on_card,
             phase9a_ms, phase9b_ms, card=""):
    """Phase 12: the off-default event kernels (the compensated E->I
    move, the compensated pair move, the gamma refresh) over the space
    axis, from the reports of phase 11's ranks.  12a: the UK transition
    on 11a's inputs and HMC draws: every rank of a space group ends with
    the same u and gathered events (bitwise), no K1 launch; against the
    one-process transition ``one = (u, events, timing)`` (in batches of a
    chain slice, the same seeds; run twice, bitwise alike) the chains
    whose events are equal have u[:, 3:5] within rtol 1e-5 with 11a's
    float32 atol ``f32_err`` (the others counted, not held); the
    transition's ms on each rank and in one process, and the unfused
    sweep alone in one process and on every rank at once.  12b:
    ``run_mcmc`` on ``plan``: every window's and burst's u bitwise equal
    on the ranks of a group, rank 0's store of every chain and location,
    the refresh's, compensated and pair acceptances in (0, 1], finite
    gamma and logp, no K1 launch; each rank's ms/transition beside phase
    9a's and its seconds in the driver's gathers.  12c: the MSOA transition
    with phase 9b's options: one K2 band launch a transition on each rank
    over its share of the block rows, the group's ranks bitwise equal;
    ms/transition beside phase 9b's.  Returns 12c's K2 launches on all
    ranks."""
    from covid19uk_tpu_torch.inference.warmup import WarmupSchedule

    problems = []
    ranks = len(reports)
    p12 = [r["p12"] for r in reports]
    groups = {}
    for p in p12:
        groups.setdefault(p["chain_rank"], []).append(p)

    def agree(key):
        """The groups whose ranks' ``key`` differ."""
        return [c for c, g in groups.items()
                if any(p[key] != g[0][key] for p in g)]

    # 12a
    off_u, off_ev, off_one = one
    got_u, got_ev = p12[0]["a_step"]
    same = ~(got_ev != off_ev).reshape(C, -1).any(1)
    g_got, g_want = got_u[same, 3:5], off_u[same, 3:5]
    bad = np.argwhere(~np.isclose(g_got, g_want, rtol=1e-5, atol=f32_err))
    if agree("a_digest"):
        problems.append(f"12a: the ranks of chain slices {agree('a_digest')}"
                        " differ in u or events")
    if any(p["a_k1"] for p in p12):
        problems.append(f"12a: K1 launches {[p['a_k1'] for p in p12]}")
    if len(bad):
        problems.append(f"12a: gamma of {len(bad)} entries of chains with "
                        f"one process's events off by more than rtol 1e-5 "
                        f"(atol {f32_err!r})")
    if not off_one["repeat"]:
        problems.append("12a: one process's transition differs from itself")
    gap = (float(np.abs(g_got - g_want).max()) if same.any()
           else float("nan"))
    say(f"phase 12a off-default transition over a {mesh} mesh of {C} "
        f"chains (M={M}, T={T}; unfused sweep, compensated move and pair "
        f"move, gamma refresh) on 11a's inputs and HMC draws: u and "
        f"gathered events bitwise equal on the ranks of every space group:"
        f" {not agree('a_digest')}; events equal to one process's in "
        f"{int(same.sum())} of {C} chains, their u[:, 3:5] largest "
        f"absolute difference {gap!r} (atol {f32_err!r}); K1 launches per "
        f"rank {[p['a_k1'] for p in p12]}; acceptance on rank 0 "
        f"{json.dumps(p12[0]['a_acc'])}; one process's transition twice "
        f"bitwise alike: {off_one['repeat']}")
    split = {k: [round(p["a_sweep"][k], 1) for p in p12]
             for k in off_one["sweep"]}
    alone = {k: round(v, 1) for k, v in off_one["sweep"].items()}
    say(f"phase 12a time (host clock, the second of two runs): the "
        f"transition {[round(p['a_ms'], 1) for p in p12]} ms per rank "
        f"against {off_one['ms']:.1f} in one process; the unfused sweep "
        f"alone on all {C} chains, every rank at once (no collective), "
        f"with the plain kernels {split['plain']}, with the compensated "
        f"move {split['burst']}, with the compensated pair move too "
        f"{split['warmup']}, the refresh {split['refresh']} ms, against one "
        f"process alone {json.dumps(alone)}")

    # 12b
    warmup, bursts, draws, thin = plan
    transitions = WarmupSchedule(**warmup).total + bursts * draws
    stored = WarmupSchedule(**warmup).total + bursts * draws // thin
    windows = 2 + warmup["num_slow_windows"] + bursts
    if agree("b_digests") or len(p12[0]["b_digests"]) != windows:
        problems.append(f"12b: window u differ on the ranks of chain slices "
                        f"{agree('b_digests')} ({len(p12[0]['b_digests'])} "
                        f"of {windows} recorded)")
    if any(p["b_k1"] for p in p12):
        problems.append(f"12b: K1 launches {[p['b_k1'] for p in p12]}")
    shape = p12[0]["b_store"]["samples/seir"]
    if tuple(shape) != (stored, C, M, T, 3) or not p12[0]["b_ok"]:
        problems.append(f"12b: rank 0's store {shape}, finite and integer:"
                        f" {p12[0]['b_ok']}")
    acc = p12[0]["b_acc"]
    if not all(0.0 < acc[k] <= 1.0 for k in OFF_RESULTS):
        problems.append(f"12b: acceptances {acc}")
    log = p12[0]["b_log"]
    for e in log:
        if e["event"] in ("window", "burst"):
            say(f"phase 12b {e.get('name', 'burst')} {e['draws']} draws: "
                f"{e['draws'] * C / e['wall_s']!r} draws/sec, "
                f"{e['wall_s'] / e['draws'] * 1e3!r} ms/transition, HMC "
                f"acceptance {e['hmc_accept']}")
    burst_ms = [e["wall_s"] / e["draws"] * 1e3 for e in log
                if e["event"] == "burst"]
    say(f"phase 12b off-default driver over a {mesh} mesh: bursts "
        f"{burst_ms} ms/transition against phase 9a's "
        f"{'not run in this call' if phase9a_ms is None else phase9a_ms}"
        f" on one process; each rank's whole run "
        f"{[p['b_wall_s'] / transitions * 1e3 for p in p12]} "
        f"ms/transition, of which in the driver's gathers through the host "
        f"(draws to rank 0: gather_space; traces, pooling: gather_chains) "
        f"{[{k: round(v, 3) for k, v in p['b_gathers'].items()} for p in p12]}"
        f" s of {[round(p['b_wall_s'], 3) for p in p12]} s; u of the "
        f"{windows} windows and bursts bitwise "
        f"equal on the ranks of every space group: "
        f"{not agree('b_digests')}; K1 launches per rank "
        f"{[p['b_k1'] for p in p12]} in {transitions} transitions; "
        f"acceptance over the {stored} stored draws {json.dumps(acc)}; "
        f"rank 0's store {shape}")

    # 12c
    outs = [p["c"] for p in p12]
    o = outs[0]
    n, R = o["timed"], o["R"]
    space = ranks // len(groups)
    split = R % space == 0
    if on_card and [x["launches"] for x in outs] != [n] * ranks:
        problems.append(f"12c: K2 launches per rank "
                        f"{[x['launches'] for x in outs]} in {n}")
    calls = [x["band_calls"] for x in outs]
    if not split or calls != [n] * ranks or (
            [x["rows"] for x in outs] != [R // space] * ranks):
        problems.append(f"12c: band products per rank {calls}, rows "
                        f"{[x['rows'] for x in outs]} of {R}")
    if not all(x["finite"] for x in outs):
        problems.append("12c: non-finite logp")
    if [c for c, g in groups.items()
            if any(p["c"]["digest"] != g[0]["c"]["digest"] for p in g)]:
        problems.append("12c: the ranks of a space group differ")
    say(f"phase 12c MSOA off-default transition (R={R} block rows) over a "
        f"{mesh} mesh: {n} timed transitions, {[x['ms'] for x in outs]} "
        f"ms/transition per rank against phase 9b's "
        f"{'not run in this call' if phase9b_ms is None else phase9b_ms} "
        f"(M=7000, one process); K2 launches per rank "
        f"{[x['launches'] for x in outs]}, band products {calls}, each over"
        f" {o['rows']} block rows; acceptance on rank 0 "
        f"{json.dumps(o['acc'])}")
    if problems:
        raise AssertionError("phase 12: " + "; ".join(problems))
    say(f"phase 12 on {card or 'the CPU'}: every check held")
    return sum(x["launches"] for x in outs)


def check_bench(result, stats, chains, n_seeds, on_card, launches):
    """The problems of a bench_torch.run_benchmark result: bench.py's
    keys, finite positive value and per-scalar ESS, the counts, HMC
    acceptance in (0, 1], and on the card one K1 launch a transition and
    no K2 launch."""
    problems = []
    if list(result) != BENCH_KEYS:
        problems.append(f"keys {list(result)} are not bench.py's")
    ess = result["ess_diag_not_mixing"]
    if not all(np.isfinite(v) and v > 0 for v in
               [result["value"], *result["runs"], *ess.values()]):
        problems.append("value, runs or ESS not finite and positive")
    if not np.isfinite(result["sd"]):
        problems.append("sd not finite")
    if (result["chains"], result["seeds"], len(result["runs"])) != (
            chains, n_seeds, n_seeds):
        problems.append("chains, seeds or runs do not match the run")
    if not 0.0 < stats["hmc_accept"] <= 1.0:
        problems.append(f"HMC acceptance {stats['hmc_accept']}")
    if on_card and (launches["fused_sweep"] != stats["transitions"]
                    or launches["bsr_matmul"] != 0):
        problems.append(f"launches {launches} in {stats['transitions']} "
                        f"transitions")
    return problems


def phase_13(torch, dev, card="", rehearse=False):
    """Phase 13: the ESS/sec entry points.  13a: bench_torch.py's
    ``run_benchmark`` on its synthetic full-UK build (M=380, T=120, C=64,
    fused sweep) with ``BENCH_UK``'s draws; 13b: the same on
    ``build_real`` (the tracked UK data through the plain HDF5 reader,
    ``BENCH_REAL_CHAINS`` chains); 13c: bench_mixing_torch.py at NI scale
    with the compensated pair move and the gamma refresh (unfused sweep:
    no K1 or K2 launch).  Checks as :func:`check_bench`, and 13c's six
    ESS finite and positive, its acceptances in [0, 1] with the refresh's
    and HMC's above 0.  Each prints its numbers.  Returns (K1 launches and
    UK transitions of 13a-b)."""
    import bench_mixing_torch
    import bench_torch

    on_card = dev.type == "cuda"
    problems = []
    k1 = transitions = 0
    shape, draws = (dict(M=M, T=T, C=C), BENCH_UK) if not rehearse \
        else REHEARSE_BENCH
    real_chains, real_draws = (BENCH_REAL_CHAINS, BENCH_REAL) \
        if not rehearse else REHEARSE_REAL
    runs = [
        ("13a", "synthetic UK", "ess_per_sec_fulluk", shape["C"], draws,
         lambda: bench_torch.build(shape["C"], M=shape["M"], T=shape["T"],
                                   device=dev)),
        ("13b", "real UK data", "ess_per_sec_fulluk_real", real_chains,
         real_draws, lambda: bench_torch.build_real(real_chains,
                                                    device=dev)),
    ]
    for part, what, metric, chains, plan, make in runs:
        t0 = time.perf_counter()
        built = make()
        stats = {}
        reset_launches()
        result = bench_torch.run_benchmark(*built, metric=metric,
                                           stats=stats, **plan)
        launches = read_launches()
        del built
        found = check_bench(result, stats, chains, plan["n_seeds"], on_card,
                            launches)
        problems += [f"{part}: {p}" for p in found]
        k1 += launches["fused_sweep"]
        transitions += stats["transitions"]
        ms = [round(w / plan["n_draws"] * 1e3, 2) for w in stats["walls"]]
        say(f"phase {part} bench_torch {what} on {card or 'the CPU'}: "
            f"{json.dumps(result)}; {stats['transitions']} transitions "
            f"({plan['warm_draws']} warm, {1 + plan['n_seeds']} x "
            f"{plan['n_draws']}), launches {json.dumps(launches)}, HMC "
            f"acceptance {stats['hmc_accept']:.4f}, timed ms/transition "
            f"{ms} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    flags = MIXING_FLAGS + (REHEARSE_MIXING if rehearse else [])
    args = bench_mixing_torch.parser().parse_args(
        flags + ["--device", dev.type])
    reset_launches()
    ess, acc, wall = bench_mixing_torch.run(args)
    launches = read_launches()
    if not all(np.isfinite(v) and v > 0 for v in ess.values()):
        problems.append(f"13c: ESS {ess}")
    if not (all(0.0 <= v <= 1.0 for v in acc.values())
            and acc["gamma"] > 0 and acc["hmc"] > 0):
        problems.append(f"13c: acceptance {acc}")
    if any(launches.values()):
        problems.append(f"13c: launches {launches} (unfused sweep at NI)")
    say(f"phase 13c bench_mixing_torch {' '.join(flags)} on "
        f"{card or 'the CPU'}: ESS "
        f"{json.dumps({k: round(v, 1) for k, v in ess.items()})}, acc "
        f"{json.dumps({k: round(v, 3) for k, v in acc.items()})}, "
        f"{args.chains} chains x {args.draws} draws in {wall:.2f} s, "
        f"min-ESS/sec {min(ess.values()) / wall:.3f}, launches "
        f"{json.dumps(launches)} ({time.perf_counter() - t0:.1f} s)")
    if problems:
        raise AssertionError("phase 13: " + "; ".join(problems))
    say(f"phase 13 on {card or 'the CPU'}: every check held")
    return k1, transitions


def main(argv):
    if argv[:1] == ["--rank-worker"]:
        return rank_worker(argv[1:])
    if argv[:1] == ["--space-worker"]:
        return space_worker(argv[1:])
    rehearse = "--rehearse" in argv
    faulthandler.dump_traceback_later(1000, exit=True)
    t0 = time.perf_counter()
    import torch

    if not rehearse and not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from covid19uk_tpu_torch.ops import _build
    from covid19uk_tpu_torch.utils.synthetic import synthetic_covariates

    if rehearse:
        # tiny tensors gain nothing from intra-op threads, and on a busy
        # host the threads' waits slow the run several times over
        torch.set_num_threads(1)
        say("phase 0 rehearsal on the CPU at a tiny size (phases 1, 2 and 4"
            " skipped, no result line)")
        model, state, gen = build_chains(torch, "cpu", **TINY)
        phase_slice(torch, model, state, gen, timed=2)
        _, _, store, fused_ms = phase_driver(
            torch, 6, model, state, uk_driver_config(TINY["T"]), UK_DRIVER,
            "fused_sweep")
        off_msoa_ms = rehearse_msoa(torch)
        covariates, init = synthetic_covariates(TINY["M"], TINY["T"])
        phase_posterior(torch, torch.device("cpu"), store, covariates, init)
        off_ms = phase_9a(torch, "cpu", **TINY)
        phase_9c(torch, "cpu", **TINY)
        phase_10(torch, torch.device("cpu"), **TINY, plan=UK_DRIVER,
                 phase6_ms=fused_ms[0])
        phase_10d(torch, "cpu", **TINY)
        phase_11(torch, torch.device("cpu"), **TINY, plan=REHEARSE_DRIVER,
                 phase6_ms=fused_ms[0], msoa_M=256, fallback_M=384,
                 msoa_T=30, msoa_timed=2, sparse=True,
                 off_plan=REHEARSE_DRIVER, phase9a_ms=off_ms[0],
                 phase9b_ms=off_msoa_ms)
        phase_13(torch, torch.device("cpu"), rehearse=True)
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
    ms, _ = phase_slice(torch, model, state, gen, N_TIMED, card)
    say(f"breakdown: HMC density value+grad {grad_ms(torch, model, state):.3f}"
        f" ms (x17 per transition), fused sweep {k1['ms']:.3f} ms")
    k1_launches, uk_transitions, uk_store, fused_ms = phase_driver(
        torch, 6, model, state, uk_driver_config(T), UK_DRIVER,
        "fused_sweep", card)
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
    msoa_ms, _, breakdown = phase_msoa(torch, msoa, mstate, mgen,
                                       MSOA_TIMED, card)
    say(f"{breakdown}, K2 {k2['ms']:.4f} ms")
    k2_launches, msoa_transitions, _, _ = phase_driver(
        torch, 7, msoa, mstate, msoa_config(MSOA_T), MSOA_DRIVER,
        "bsr_matmul", card)
    del msoa, mstate, op

    # phase 6's model from its seed: the same covariates and initial state
    covariates, init = synthetic_covariates(M, T)
    verbs_s = phase_posterior(torch, torch.device("cuda"), uk_store,
                              covariates, init, card)
    del uk_store

    off_ms = phase_9a(torch, "cuda", M, T, C, card)
    msoa, mstate, mgen = build_msoa(torch, "cuda", MSOA_M, MSOA_T)
    k2_9b, off_msoa_ms = phase_9b(torch, msoa, mstate, mgen,
                                  OFF_DEFAULT_TIMED, card)
    k2_launches += k2_9b
    del msoa, mstate
    phase_9c(torch, "cuda", M, T, F64_CHAINS)
    mesh_launches, mesh_transitions, _ = phase_10(
        torch, torch.device("cuda"), M, T, C, UK_DRIVER, fused_ms[0], card)
    k1_launches += mesh_launches
    uk_transitions += RANKS * mesh_transitions
    phase_10d(torch, "cuda", M, T, C, card)
    k1_space, k2_space, _, _ = phase_11(
        torch, torch.device("cuda"), M, T, C, UK_DRIVER, fused_ms[0], card,
        phase9a_ms=off_ms[0], phase9b_ms=off_msoa_ms)
    k1_launches += k1_space
    uk_transitions += SPACE * (1 + mesh_transitions)
    k2_launches += k2_space
    msoa_transitions += SPACE * (2 * SPACE_TIMED + SPACE_FALLBACK)
    k1_bench, bench_transitions = phase_13(torch, torch.device("cuda"), card)
    k1_launches += k1_bench
    uk_transitions += bench_transitions

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
        f"transition at M={MSOA_M}, one chain; driver launches: K1 "
        f"{k1_launches / uk_transitions:g} per UK transition, K2 "
        f"{k2_launches / (msoa_transitions + OFF_DEFAULT_TIMED):g} per MSOA "
        f"transition; posterior verbs {verbs_s:.1f} s; off-default kernels "
        f"{off_ms[0]:.3f} ms per burst transition at M={M}, C={C} "
        f"({off_ms[1]:.3f} without the host copy) against the fused "
        f"driver's {fused_ms[0]:.3f} ({fused_ms[1]:.3f}; phase 6); on "
        f"{card}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
