#!/usr/bin/env python3
"""Profiles MCMC transitions of the PyTorch/CUDA port on one NVIDIA card.

    python3 profile_torch.py [out_dir]   # default out_dir: profile_out

For each configuration of chip_smoke.py (full UK: M=380, T=120, 64
chains, fused sweep; MSOA: M=7000, T=120, one chain, unfused sweep with
pair moves), runs 2 transitions to warm up, 3 timed by the host clock,
and 3 under torch.profiler (CPU and CUDA activity), and prints one line
each: host wall time per transition (without the profiler), device time
(the sum of the kernels' own device time), the device's busy share
(device time over that wall time), kernel launches per transition, and
the three kernels with the most device time, and the device time per
transition of each hand kernel (K1 ``fused_sweep_kernel``, K2
``bsr_matmul_kernel``).  The full tables go to
``<out_dir>/profile_<name>.txt``.  Then K1 alone at chip_smoke.py phase
2's inputs, built with its per-phase cycle counters (-DK1_PHASES): one
line with each phase's share of thread 0's clock64 cycles, the mean over
the 64 blocks, and the cycles of a launch.  Last, K2 at chip_smoke.py
phase 4's shapes beside two builds that do one part of its work alone
(-DK2_COPIES_ONLY, -DK2_PRODUCTS_ONLY): one line of their times.  Exits
non-zero without a card.
"""

import ctypes
import json
import os
import sys
import time

N_WARM, N_PROFILED = 2, 3
HAND_KERNELS = ("fused_sweep_kernel", "bsr_matmul_kernel")
# K1's phases in the order of its kPh* enum (csrc/fused_sweep.cu)
K1_PHASES = (
    "copy-in", "guide logits", "uniforms wait",
    "move S->E top-mmax", "move E->I top-mmax",
    "move S->E slot days", "move E->I slot days",
    "move E->I plane pass",
    "move S->E decision", "move E->I decision",
    "move S->E apply", "move E->I apply",
    "occult S->E pick", "occult E->I pick",
    "occult S->E column delta", "occult E->I column and plane delta",
    "occult S->E decision", "occult E->I decision",
    "occult S->E apply", "occult E->I apply",
)
K1_PHASE_BLOCKS = 1024  # kPhaseBlocks
# K2 built to do one part of its work alone (csrc/block_sparse.cu)
K2_PARTS = {"copies alone": "K2_COPIES_ONLY",
            "products alone": "K2_PRODUCTS_ONLY"}


def profile_steps(torch, step, state, tune, gen):
    """Host wall ms per transition without the profiler, then the
    profiler over as many transitions."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(N_WARM):
        state, _ = step(state, tune, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_PROFILED):
        state, _ = step(state, tune, gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / N_PROFILED * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(N_PROFILED):
            state, _ = step(state, tune, gen)
        torch.cuda.synchronize()
    return prof, wall


def summarize(torch, prof, wall, name, out_dir):
    """One JSON line: the kernels' device time (events on the CUDA
    device only: operator events carry their kernels' time too), launches
    and busy share against the unprofiled wall time."""
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events if e.device_type == cuda]
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3 / N_PROFILED
    launches = sum(e.count for e in kernels) / N_PROFILED
    top = sorted(kernels, key=dev_us, reverse=True)[:3]
    hand = {k: sum(dev_us(e) for e in kernels if k in e.key) / 1e3
            / N_PROFILED for k in HAND_KERNELS}
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    print(json.dumps(dict(
        config=name, wall_ms_per_transition=wall,
        device_ms_per_transition=dev_ms,
        busy_share=dev_ms / wall,
        kernel_launches_per_transition=launches,
        hand_kernel_ms_per_transition=hand,
        top_kernels=[dict(name=e.key[:80],
                          ms_per_transition=dev_us(e) / 1e3 / N_PROFILED,
                          calls_per_transition=e.count / N_PROFILED)
                     for e in top],
    )), flush=True)


def k1_phases(torch, cs, model, state, gen):
    """K1 built with its phase counters, at phase 2's inputs: one JSON
    line of each phase's share of a block's cycles (thread 0's clock64,
    mean over blocks) and the cycles of a launch."""
    import numpy as np
    from covid19uk_tpu_torch.ops import _build
    from covid19uk_tpu_torch.ops import fused_sweep as fs

    lib = _build.fused_sweep_phase_library()
    args, scfg = cs.sweep_inputs(torch, model, state, gen)
    kargs, _ins, _outs = fs._kernel_args(*args, scfg)
    stream = torch.cuda.current_stream().cuda_stream
    buf = (ctypes.c_ulonglong * (K1_PHASE_BLOCKS * len(K1_PHASES)))()
    for _ in range(2):  # the first launch warms up; each read zeroes
        if lib.fused_sweep_launch(*kargs, stream) != 0:
            raise RuntimeError("fused_sweep launch failed")
        torch.cuda.synchronize()
        if lib.fused_sweep_phase_cycles(buf) != 0:
            raise RuntimeError("reading K1's phase cycles failed")
    C = state.u.shape[0]
    cycles = np.frombuffer(buf, dtype=np.uint64).reshape(
        K1_PHASE_BLOCKS, len(K1_PHASES))[:C].astype(np.float64).mean(0)
    total = float(cycles.sum())
    print(json.dumps(dict(
        config="k1_phases_uk_m380_c64", cycles_per_launch=total,
        share={n: float(c) / total for n, c in zip(K1_PHASES, cycles)},
    )), flush=True)


def k2_parts(torch, cs, model, gen):
    """K2 at chip_smoke.py phase 4's shapes, beside its two one-part
    builds (the copies alone, the products alone): one JSON line of each
    one's device ms, CUDA events over K2_REPS launches."""
    from covid19uk_tpu_torch.ops import _build
    from covid19uk_tpu_torch.ops import block_sparse as bs

    libs = {"whole kernel": _build.block_sparse_library().lib}
    for part, define in K2_PARTS.items():
        libs[part] = _build.bind_block_sparse(
            _build.build("block_sparse", (define,)).lib)
    op = model.data.Cstar_bsr
    Mm, stream = model.data.num_locations, torch.cuda.current_stream()
    ms = {}
    for S, T in ((1, model.num_steps), cs.WINDOWED_BATCH):
        x = torch.randn((S, Mm, T), generator=gen, device="cuda")
        args, _y = bs._kernel_args(op.values, op.col_idx, x, op.perm32,
                                   op.slots, op.order)

        def launch(lib):
            if lib.bsr_matmul_launch(*args, stream.cuda_stream) != 0:
                raise RuntimeError("bsr_matmul launch failed")

        ms[f"[{S}, {Mm}, {T}]"] = {
            name: cs.cuda_ms(torch, lambda: launch(lib), cs.K2_REPS)
            for name, lib in libs.items()}
    print(json.dumps(dict(config="k2_parts_msoa_m7000", ms=ms)), flush=True)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: profile_torch.py needs an NVIDIA card",
              file=sys.stderr)
        return 1
    out_dir = argv[0] if argv else "profile_out"
    os.makedirs(out_dir, exist_ok=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from covid19uk_tpu_torch.inference.gibbs import HMCTunables, make_mcmc_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)

    model, state, gen = cs.build_chains(torch, "cuda", cs.M, cs.T, cs.C)
    step = make_mcmc_step(model, 16, cs.event_config(cs.T))
    tune = HMCTunables(step_size=torch.tensor(0.005, device="cuda"),
                       inv_mass_diag=torch.ones(state.u.shape[1],
                                                device="cuda"))
    summarize(torch, *profile_steps(torch, step, state, tune, gen),
              "uk_m380_c64", out_dir)
    k1_phases(torch, cs, model, state, gen)
    del model, state

    model, state, gen = cs.build_msoa(torch, "cuda", cs.MSOA_M, cs.MSOA_T)
    step = make_mcmc_step(model, 16, cs.msoa_config(cs.MSOA_T))
    tune = HMCTunables(step_size=torch.tensor(0.01, device="cuda"),
                       inv_mass_diag=torch.ones(state.u.shape[1],
                                                device="cuda"))
    summarize(torch, *profile_steps(torch, step, state, tune, gen),
              "msoa_m7000_c1", out_dir)
    k2_parts(torch, cs, model, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
