#!/usr/bin/env python3
"""The UK driver's draws/sec over ranks with a card each (NCCL).

    python3 mesh_scale.py                     # on a machine with 4 cards
    python3 mesh_scale.py --space             # the space axis, 4 cards
    python3 mesh_scale.py [--space] --rehearse  # gloo ranks on the CPU, tiny

Builds the kernels and runs chip_smoke.py's phase 6 (``run_mcmc`` at
M=380, T=120 on 64 chains in one process, on card 0).  Then, without
``--space``, its phase 10 over 2 and over 4 ranks: the dry run, the
sharded step against one process's in batches of a rank's chains, and
``run_mcmc`` with ``use_mesh`` on phase 6's plan and chains, rank r on
card r (NCCL when there are as many cards as ranks), with every check of
phase 10.  With ``--space``, its phase 11 over 4 ranks as the meshes 1 x 4
and 2 x 2 (chain x space): the space-sharded UK step against one
process's, ``run_mcmc`` with ``space_devices`` on phase 6's plan, and the
MSOA transition at M=7168 with K2 on each rank's band of block rows
against one process's, with every check of phase 11; the same ranks then
run phase 12, the off-default event kernels over the space axis, with
every check of phase 12.  The last line
compares the ms per transition of each configuration with one process's.
Any failure exits non-zero.
"""

import faulthandler
import json
import os
import sys
import time

import chip_smoke as cs

RANK_COUNTS = (2, 4)
SPACE_MESHES = (4, 2)  # the space axis over 4 ranks: 1 x 4 and 2 x 2


def main(argv):
    rehearse = "--rehearse" in argv
    space = "--space" in argv
    faulthandler.dump_traceback_later(1000, exit=True)
    t0 = time.perf_counter()
    import torch

    if rehearse:
        torch.set_num_threads(1)
        dev, (M, T, C), card = torch.device("cpu"), (12, 20, 4), ""
        msoa = dict(msoa_M=512, fallback_M=384, msoa_T=30, msoa_timed=2,
                    sparse=True)
    else:
        if torch.cuda.device_count() < max(RANK_COUNTS):
            print(f"mesh_scale.py needs {max(RANK_COUNTS)} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        dev, (M, T, C) = torch.device("cuda"), (cs.M, cs.T, cs.C)
        card = cs.card_line()
        msoa = {}
        from covid19uk_tpu_torch.ops import _build

        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
    model, state, _ = cs.build_chains(torch, dev, M, T, C)
    _, _, _, fused_ms = cs.phase_driver(
        torch, 6, model, state, cs.uk_driver_config(T), cs.UK_DRIVER,
        "fused_sweep", card)
    del model, state
    bursts = {1: [fused_ms[0]]}
    if space:
        ranks = max(RANK_COUNTS)
        msoa_ms = {}
        for s in SPACE_MESHES:
            name = f"{ranks // s}x{s}"
            _, _, bursts[name], msoa_ms[name] = cs.phase_11(
                torch, dev, M, T, C, cs.UK_DRIVER, fused_ms[0], card,
                ranks=ranks, space=s, **msoa)
        result = {"burst_ms_per_transition": bursts,
                  "msoa_ms_per_transition": msoa_ms}
    else:
        for ranks in RANK_COUNTS:
            bursts[ranks] = cs.phase_10(torch, dev, M, T, C, cs.UK_DRIVER,
                                        fused_ms[0], card, ranks=ranks)[2]
        result = {"burst_ms_per_transition": bursts}
    print(json.dumps(dict(result, chains=C, M=M, card=card or "cpu",
                          wall_s=time.perf_counter() - t0)), flush=True)
    return 3 if rehearse else 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
