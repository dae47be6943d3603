#!/usr/bin/env python3
"""Mixing study of the PyTorch/CUDA port: min-scalar ESS/sec against the
event-kernel configuration.

The counterpart of ``tools/bench_mixing.py`` on
:mod:`covid19uk_tpu_torch`, with its flags, defaults and output.  The
ESS bottleneck is gamma0 (the I->R intercept): its conditional given the
latent infectious path is tight, so gamma0 mixes only as fast as the E->I
event times move.  The flags set the event kernels (sweeps, mmax, the
decays, the gamma0-compensated moves, the gamma Gibbs refresh, the pair
moves, the occult range, the guided proposals), so that ESS and the time
they cost can be weighed.  The sweep is unfused (the fused sweep refuses
the compensated moves), so it runs no hand kernel at NI or UK scale.

    python3 bench_mixing_torch.py [--chains 16] [--scale ni|uk] \\
        [--sweeps 5] [--mmax 2] [--move-decay 0.9] [--x-decay 0.9] \\
        [--draws 500] [--data inferencedata.h5] [--device cpu] ...

Per-chain adaptation over ``--warm`` draws (bench_torch.py's), the mass
from the last half of the warm draws, one untimed segment of ``--draws``
whose state carries over, then a timed one.  Prints per-scalar ESS (of
the unconstrained draws, as the JAX tool computes it), acceptance rates,
min-ESS/sec and draws/sec.  Without a card, and without ``--device
cpu``, it exits non-zero.
"""

import argparse
import sys
import time

import torch

import bench_torch
from covid19uk_tpu_torch.inference import dual_averaging, welford
from covid19uk_tpu_torch.inference.gibbs import (
    ChainState,
    EventKernelConfig,
    HMCTunables,
    make_mcmc_step,
)
from covid19uk_tpu_torch.inference.warmup import regularized_variance
from covid19uk_tpu_torch.parallel.diagnostics import effective_sample_size
from covid19uk_tpu_torch.utils.synthetic import (
    build_synthetic_model,
    initial_chain_state,
)

NAMES = ["psi", "sigma_space", "beta_area", "gamma0", "gamma1", "alpha_0"]
ACC_NAMES = ["hmc", "move_se", "move_ei", "occ_se", "occ_ei", "comp_ei",
             "pair", "gamma"]
_TRACE_FIELDS = ["hmc", "move_se", "move_ei", "occult_se", "occult_ei",
                 "comp_ei", "pair", "gamma"]  # StepTrace's, in ACC_NAMES order
_WORDS = {"auto": "auto", "always": True, "never": False}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--scale", choices=["ni", "uk"], default="ni")
    ap.add_argument("--sweeps", type=int, default=5)
    ap.add_argument("--mmax", type=int, default=2)
    ap.add_argument("--move-decay", type=float, default=0.9)
    ap.add_argument("--x-decay", type=float, default=0.9)
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--warm", type=int, default=300)
    ap.add_argument("--leapfrog", type=int, default=16)
    ap.add_argument("--comp-updates", type=int, default=1)
    ap.add_argument("--pair-updates", type=int, default=1)
    ap.add_argument("--pair-mmax", type=int, default=1)
    ap.add_argument("--no-comp", action="store_true",
                    help="disable the compensated (gamma0, E->I) kernel")
    ap.add_argument("--pair-comp", action="store_true",
                    help="gamma0-compensated pair moves")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pair-decay", type=float, default=1.0)
    ap.add_argument("--occult-range", choices=["ref", "full"], default="ref",
                    help="occult add/delete t_range: 'ref' = last 21 days "
                    "(reference contract), 'full' = all of [0, T)")
    ap.add_argument("--pair-updates-sampling", type=int, default=None,
                    help="pair updates in the TIMED phase (default: same "
                    "as --pair-updates)")
    ap.add_argument("--gamma-gibbs", action="store_true",
                    help="conditional (gamma0, gamma1) | events refresh "
                    "after each sweep")
    ap.add_argument("--occult-guided", choices=["auto", "always", "never"],
                    default="auto",
                    help="guided occult location proposal")
    ap.add_argument("--move-guided", choices=["auto", "always", "never"],
                    default="never",
                    help="guided MOVE/PAIR location proposal")
    ap.add_argument("--data", default=None,
                    help="inferencedata.h5 with real covariates (overrides "
                    "--scale's synthetic model)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def mixing_config(args, T):
    """The EventKernelConfig of the parsed flags ``args`` over ``T`` days
    (tools/bench_mixing.py's mapping)."""
    t_range = (0, T) if args.occult_range == "full" else (T - 21, T)
    return EventKernelConfig(
        dmax=84, mmax=args.mmax, nmax=25, occult_nmax=15,
        num_event_time_updates=args.sweeps, t_range=t_range,
        move_decay=args.move_decay, x_decay=args.x_decay,
        compensate_gamma0=not args.no_comp,
        num_compensated_updates=args.comp_updates,
        num_pair_updates=args.pair_updates, pair_mmax=args.pair_mmax,
        pair_move_decay=args.pair_decay,
        pair_compensate_gamma0=args.pair_comp,
        gamma_gibbs=args.gamma_gibbs,
        occult_guided=_WORDS[args.occult_guided],
        move_guided=_WORDS[args.move_guided],
    )


def build(args):
    """``(model, state)``: the real covariates of ``--data`` (bench_torch's
    real build), else the synthetic model at NI (M=11, T=32) or UK (M=380,
    T=120) scale with every chain at one simulated start."""
    device = args.device
    if args.data is not None:
        model, _, _, state = bench_torch.build_real(args.chains, args.data,
                                                    device=device)
        return model, state
    M, T = (11, 32) if args.scale == "ni" else (380, 120)
    model = build_synthetic_model(M, T, torch.float32, device=device)
    single = initial_chain_state(model, bench_torch.generator(device, 0))
    state = ChainState(*[x.expand((args.chains,) + x.shape).contiguous()
                         for x in single])
    return model, state


def run(args):
    """The study of the parsed flags: ``(ess, acc, wall)``, the ESS of
    each scalar (unconstrained), the mean acceptance of each kernel over
    the timed draws and chains, and the timed segment's seconds."""
    device = args.device
    model, state = build(args)
    cfg = mixing_config(args, model.num_steps)
    step = make_mcmc_step(model, args.leapfrog, cfg)
    step_sample = step
    if args.pair_updates_sampling is not None:
        step_sample = make_mcmc_step(model, args.leapfrog, cfg._replace(
            num_pair_updates=args.pair_updates_sampling))

    state, da, _, w_us = bench_torch.warm_up(
        step, state, args.warm, bench_torch.generator(device, 42 + args.seed),
        keep_u=True)
    tune = HMCTunables(dual_averaging.step_size(da)[:, None],
                       regularized_variance(welford.from_draws(w_us)))
    del w_us

    C, n = state.u.shape[0], args.draws
    us = torch.empty((C, n, len(NAMES)), dtype=state.u.dtype, device=device)
    acc_sum = torch.zeros(len(ACC_NAMES), dtype=torch.float64, device=device)

    def segment(state, seed):
        gen = bench_torch.generator(device, seed)
        acc_sum.zero_()
        t0 = time.perf_counter()
        for i in range(n):
            state, trace = step_sample(state, tune, gen)
            us[:, i] = state.u[:, :len(NAMES)]
            acc_sum.add_(torch.stack([
                getattr(trace, f).is_accepted.to(torch.float64).mean()
                for f in _TRACE_FIELDS]))
        bench_torch.synchronize(device)
        return state, time.perf_counter() - t0

    state, _ = segment(state, args.seed)  # untimed, the state carried over
    state, wall = segment(state, args.seed + 1)
    ess = {name: float(effective_sample_size(us[:, :, i].cpu()))
           for i, name in enumerate(NAMES)}
    acc = dict(zip(ACC_NAMES, (acc_sum / n).tolist()))
    return ess, acc, wall


def main(argv=None):
    args = parser().parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_mixing_torch.py: no CUDA device (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return 1
    if args.device != "cpu":
        print(f"card: {bench_torch.card_line()}", file=sys.stderr,
              flush=True)
    ess, acc, wall = run(args)
    min_ess = min(ess.values())
    argmin = min(ess, key=ess.get)
    scale_label = f"data:{args.data}" if args.data else args.scale
    print(f"config: scale={scale_label} sweeps={args.sweeps} "
          f"comp={not args.no_comp}x{args.comp_updates} "
          f"pair={args.pair_updates} "
          f"mmax={args.mmax} move_decay={args.move_decay} "
          f"x_decay={args.x_decay} leapfrog={args.leapfrog}")
    print("ESS:", {k: round(v, 1) for k, v in ess.items()})
    print("acc:", {k: round(v, 3) for k, v in acc.items()})
    print(
        f"chains={args.chains} draws={args.draws} wall={wall:.1f}s  "
        f"min-ESS/sec={min_ess / wall:.2f} (min: {argmin})  "
        f"draws/sec={args.chains * args.draws / wall:.1f}", flush=True
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
