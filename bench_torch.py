#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: min-scalar ESS/sec at
full-UK scale, multi-chain.

The counterpart of ``bench.py`` on :mod:`covid19uk_tpu_torch`, with the
same methodology and the same JSON keys:

1. runs NCHAINS full MCMC chains as a batch (16-leapfrog preconditioned
   HMC over the 505-dim parameter vector + 5 multiscans of the 4
   event/occult kernels over the [380, 120, 3] latent event tensor, fused
   into one K1 launch a transition) on the card: an untimed adaptation
   phase (per-chain dual averaging and Welford mass), one untimed
   segment, then N_SEEDS timed segments of N_DRAWS transitions;
2. computes the pooled multi-chain effective sample size of the six
   scalar parameters (Geyer initial-monotone) and reports ``min-scalar
   ESS / sampling wall seconds``;
3. compares it with bench.py's CPU baseline, the frozen naive sampler's
   chain-steps/sec, at this run's ESS per draw.

Prints one JSON line a run:
  {"metric": "ess_per_sec_fulluk", "value": mean, "unit": "min-ESS/sec",
   "vs_baseline": mean_ratio, "sd": sd, "seeds": N_SEEDS, "chains": C,
   "runs": [per-segment values], "ess_diag_not_mixing": {...}}

    python3 bench_torch.py               # synthetic full UK
    python3 bench_torch.py --with-real   # then the real-census covariates
    python3 bench_torch.py --real-only   # metric ess_per_sec_fulluk_real
    python3 bench_torch.py --device cpu  # on the CPU (the tests, tiny sizes)

Environment: BENCH_CHAINS (64), BENCH_FUSED=0 (the unfused sweep),
BENCH_PAIR (pair moves in the timed phase, 0), BENCH_REAL_WARM (2500).
Without a card, and without ``--device cpu``, it exits non-zero.
Progress goes to standard error.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from covid19uk_tpu_torch.inference import dual_averaging, welford
from covid19uk_tpu_torch.inference.driver import initialize_from_cases
from covid19uk_tpu_torch.inference.gibbs import (
    ChainState,
    EventKernelConfig,
    HMCTunables,
    make_mcmc_step,
)
from covid19uk_tpu_torch.inference.warmup import regularized_variance
from covid19uk_tpu_torch.models.spec import (
    CovidUK,
    ModelData,
    Parameters,
    constrain_parameters,
    pack_parameters,
    unconstrain_parameters,
    unpack_parameters,
)
from covid19uk_tpu_torch.ops import fused_sweep
from covid19uk_tpu_torch.parallel.diagnostics import effective_sample_size
from covid19uk_tpu_torch.utils import ncio
from covid19uk_tpu_torch.utils.synthetic import (
    build_synthetic_model,
    initial_parameters,
)

M, T = 380, 120  # full-UK problem scale
WARM_DRAWS = 400  # per-chain step-size/mass adaptation (not timed)
N_DRAWS = 1000  # timed draws per chain and segment
N_SEEDS = 3  # independent timed segments averaged for the headline
DATA_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "data", "uk_example", "inferencedata.h5")

# bench.py's constant, kept so that the two benchmarks' vs_baseline read
# alike: tools/measure_cpu_baseline.py (the frozen tools/naive_v1.py,
# one chain, M=380, T=120, float32) on the CPU of the JAX repo's
# development host; a CPU figure, not a TPU one.
CPU_BASELINE_NAIVE_STEPS_PER_SEC = 0.2452

SCALAR_NAMES = ["psi", "sigma_space", "beta_area", "gamma0", "gamma1",
                "alpha_0"]  # flat packing order (bench.py:188)


def generator(device, seed):
    """A torch.Generator on ``device`` seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def _jittered(u, device):
    """``u [C, P]`` with ``0.05 * N(0, 1)`` added to its six scalars (a
    generator seeded 7): chains that do not start clumped."""
    jitter = 0.05 * torch.randn((u.shape[0], 6), generator=generator(
        device, 7), device=device, dtype=u.dtype)
    return torch.cat([u[:, :6] + jitter, u[:, 6:]], dim=1)


def event_config(num_steps):
    """bench.py's event kernels: the occults in the last 21 days, pair
    moves in warmup, the threaded commute, the fused sweep (K1) unless
    BENCH_FUSED=0."""
    return EventKernelConfig(
        dmax=84, mmax=2, nmax=25, occult_nmax=15,
        num_event_time_updates=5, t_range=(num_steps - 21, num_steps),
        num_pair_updates=1,
        thread_commute="always",
        fused_sweep=(
            "never" if os.environ.get("BENCH_FUSED") == "0" else "always"
        ),
    )


def build(nchains, dtype_name="float32", M=M, T=T, device="cuda"):
    """The synthetic full-UK model and ``nchains`` overdispersed chains:
    ``(model, step_warm, step_sample, state)``.  Each chain's events are
    simulated independently (a generator seeded 100) from the starting
    parameters, whose six scalars are jittered.  ``step_warm`` runs one
    pair-move update a multiscan, ``step_sample`` BENCH_PAIR (0)."""
    dtype = torch.float32 if dtype_name == "float32" else torch.float64
    model = build_synthetic_model(M, T, dtype, device=device)
    u0 = unconstrain_parameters(pack_parameters(initial_parameters(model)))
    params = unpack_parameters(constrain_parameters(u0), T, M)
    batched = Parameters(*[p.expand((nchains,) + p.shape) for p in params])
    events = model.sample_seir(generator(device, 100), batched)
    state = ChainState(u=_jittered(u0.expand(nchains, -1), device),
                       events=events)
    cfg = event_config(T)
    step_warm = make_mcmc_step(model, 16, cfg)
    step_sample = make_mcmc_step(model, 16, cfg._replace(
        num_pair_updates=int(os.environ.get("BENCH_PAIR") or 0)))
    return model, step_warm, step_sample, state


def build_real(nchains, data_file=DATA_FILE, dtype_name="float32",
               device="cuda"):
    """The same chain stack over the real census covariates of
    ``data_file``: the production imputation init (seed 0, the same
    events in every chain), ``u = 0`` with the scalar jitter; warmup
    diversifies the latents.  The timed phase runs no pair moves."""
    dtype = torch.float32 if dtype_name == "float32" else torch.float64
    constant = ncio.load_group(data_file, "constant_data")
    observations = ncio.load_group(data_file, "observations")
    cases = np.asarray(observations["cases"], np.float64)
    data = ModelData.create(constant.variables, dtype, num_chains=nchains,
                            keep_C=False, device=device)
    # the model's N (in its dtype), as bench.py passes data.N
    init_state, events = initialize_from_cases(
        cases, data.N.cpu().numpy(), seed=0)
    Mr, Tr = events.shape[:2]
    model = CovidUK(data, torch.as_tensor(init_state, dtype=dtype,
                                          device=device), 0, Tr)
    u0 = torch.zeros((nchains, 6 + (Tr - 1) + Mr), dtype=dtype,
                     device=device)
    events = torch.as_tensor(events, dtype=dtype, device=device)
    state = ChainState(u=_jittered(u0, device),
                       events=events.expand((nchains,) + events.shape)
                       .contiguous())
    cfg = event_config(Tr)
    step_warm = make_mcmc_step(model, 16, cfg)
    step_sample = make_mcmc_step(model, 16, cfg._replace(num_pair_updates=0))
    return model, step_warm, step_sample, state


def adapt_update(da, wf, log_accept_ratio, u):
    """One draw's per-chain adaptation (bench.py's warmup body): dual
    averaging on ``min(1, exp(log_accept_ratio))`` (0 where that is not
    finite), Welford on ``u [C, P]``, and the regularized inverse mass.
    Returns ``(da, wf, inv_mass)``; nothing waits for the device."""
    accept = torch.exp(torch.clamp(log_accept_ratio, max=0.0))
    accept = torch.where(torch.isfinite(accept), accept,
                         torch.zeros_like(accept))
    da = dual_averaging.update(da, accept)
    wf = welford.update(wf, u)
    return da, wf, regularized_variance(wf)


def warm_up(step, state, num_draws, generator, keep_u=False):
    """``num_draws`` transitions of ``step`` with :func:`adapt_update`
    after each, from step size 0.1 and unit mass.  Returns ``(state, da,
    inv_mass, us)``: ``us`` is ``[num_draws, C, P]`` (every draw's u) with
    ``keep_u``, else None."""
    C, P = state.u.shape
    dtype, device = state.u.dtype, state.u.device
    da = dual_averaging.init(torch.full((C,), 0.1, dtype=dtype,
                                        device=device))
    wf = welford.init((C, P), dtype, device)
    inv_mass = torch.ones((C, P), dtype=dtype, device=device)
    us = []
    for _ in range(num_draws):
        # a [C, 1] step size: one per chain, broadcast over P
        tune = HMCTunables(dual_averaging.step_size(da)[:, None], inv_mass)
        state, trace = step(state, tune, generator)
        da, wf, inv_mass = adapt_update(da, wf, trace.hmc.log_accept_ratio,
                                        state.u)
        if keep_u:
            us.append(state.u)
    return state, da, inv_mass, torch.stack(us) if keep_u else None


def card_line():
    """The card's name and power limit as nvidia-smi gives them (the name
    alone where nvidia-smi is missing), for the progress lines."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ess_summary(us, wall):
    """bench.py's per-segment arithmetic on a host trace ``us [C, N, 6]``
    of the six unconstrained scalars and the segment's ``wall`` seconds:
    the pooled ESS of each constrained scalar, ``value = min ESS / wall``
    and ``vs_baseline``, value over the naive CPU sampler's ESS/sec at
    this run's ESS per draw.  Returns ``(ess [6] numpy, value,
    vs_baseline)``."""
    us = torch.as_tensor(np.asarray(us))
    C, N = us.shape[:2]
    u_con = constrain_parameters(us)
    ess = np.array([float(effective_sample_size(u_con[:, :, i]))
                    for i in range(len(SCALAR_NAMES))])
    ess_min = float(ess.min())
    cpu_ess_per_sec = ess_min / (C * N) * CPU_BASELINE_NAIVE_STEPS_PER_SEC
    value = ess_min / wall
    return ess, value, value / cpu_ess_per_sec


def run_benchmark(model, step_warm, step_sample, state, metric,
                  warm_draws=WARM_DRAWS, n_draws=N_DRAWS, n_seeds=N_SEEDS,
                  stats=None):
    """bench.py's run: adaptation, one untimed segment (its state
    discarded, as bench.py's compile run), then ``n_seeds`` timed segments
    of ``n_draws`` transitions, the state carried over, each from a
    generator seeded ``3 + s``.  A segment's wall runs from its first
    transition to a synchronize after its last; the six scalars go into
    a preallocated device trace, copied to the host after the wall.
    Returns bench.py's result dict.  ``stats``, where given, is a dict
    filled with ``walls`` (seconds a segment), ``hmc_accept`` (the last
    segment's HMC acceptance rate) and ``transitions`` (all run).  The
    steps close over ``model``, which bench.py's signature keeps."""
    C = state.u.shape[0]
    dtype, device = state.u.dtype, state.u.device
    launches = fused_sweep.fused_sweep.launches

    t0 = time.perf_counter()
    state, da, inv_mass, _ = warm_up(step_warm, state, warm_draws,
                                     generator(device, 1))
    synchronize(device)
    tune = HMCTunables(dual_averaging.step_size(da)[:, None], inv_mass)
    print(f"{metric}: {warm_draws} warm draws of {C} chains in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)

    us = torch.empty((C, n_draws, len(SCALAR_NAMES)), dtype=dtype,
                     device=device)
    accepted = torch.zeros((), dtype=dtype, device=device)

    def segment(state, seed):
        gen = generator(device, seed)
        accepted.zero_()
        t0 = time.perf_counter()
        for i in range(n_draws):
            state, trace = step_sample(state, tune, gen)
            us[:, i] = state.u[:, :len(SCALAR_NAMES)]
            accepted.add_(trace.hmc.is_accepted.to(dtype).sum())
        synchronize(device)
        return state, time.perf_counter() - t0

    segment(state, 2)  # untimed, its state discarded (bench.py)
    values, ratios, walls, ess = [], [], [], None
    for s in range(n_seeds):
        state, wall = segment(state, 3 + s)
        ess, value, ratio = ess_summary(us.cpu().numpy(), wall)
        values.append(value)
        ratios.append(ratio)
        walls.append(wall)
        print(f"{metric}: segment {s} {n_draws} draws in {wall:.2f} s "
              f"({wall / n_draws * 1e3:.2f} ms/transition), min ESS "
              f"{ess.min():.1f}, {value:.4f} ESS/s", file=sys.stderr,
              flush=True)
    transitions = warm_draws + (1 + n_seeds) * n_draws
    launches = fused_sweep.fused_sweep.launches - launches
    print(f"{metric}: {transitions} transitions, {launches} K1 launches",
          file=sys.stderr, flush=True)
    if stats is not None:
        stats.update(walls=walls,
                     hmc_accept=float(accepted) / (C * n_draws),
                     transitions=transitions)
    return {
        "metric": metric,
        "value": round(float(np.mean(values)), 2),
        "unit": "min-ESS/sec",
        "vs_baseline": round(float(np.mean(ratios)), 2),
        "sd": round(float(np.std(values)), 2),
        "seeds": n_seeds,
        "chains": C,
        "runs": [round(v, 2) for v in values],
        # Last segment, per scalar.  Throughput diagnostic only: at the
        # bench's short warmup these carry the start's transient; mixing
        # measurements need a longer warmup (bench_mixing_torch.py).
        "ess_diag_not_mixing": {
            n: round(float(e), 1) for n, e in zip(SCALAR_NAMES, ess)
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--with-real", action="store_true",
                    help="also run the real-census covariates")
    ap.add_argument("--real-only", action="store_true",
                    help="run only the real-census covariates")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_torch.py: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    if args.device != "cpu":
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    nchains = int(os.environ.get("BENCH_CHAINS", "64"))
    if not args.real_only:
        result = run_benchmark(*build(nchains, device=args.device),
                               metric="ess_per_sec_fulluk")
        print(json.dumps(result), flush=True)
    if args.with_real or args.real_only:
        # The shared imputation init starts the chains in a long
        # person-time transient; warmup is untimed, so spend enough of it
        # to measure equilibrium mixing (bench.py's default).
        real = run_benchmark(
            *build_real(nchains, device=args.device),
            metric="ess_per_sec_fulluk_real",
            warm_draws=int(os.environ.get("BENCH_REAL_WARM", "2500")),
        )
        print(json.dumps(real), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
