#!/usr/bin/env python3
"""The UK driver's draws/sec over ranks with a card each (NCCL).

    python3 mesh_scale.py             # on a machine with 4 cards
    python3 mesh_scale.py --rehearse  # 2 and 4 gloo ranks on the CPU, tiny

Builds the kernels, runs chip_smoke.py's phase 6 (``run_mcmc`` at M=380,
T=120 on 64 chains in one process, on card 0) and then its phase 10 over
2 and over 4 ranks: the dry run, the sharded step against one process's
on the same noise, and ``run_mcmc`` with ``use_mesh`` on phase 6's plan
and chains, rank r on card r (NCCL when there are as many cards as
ranks), with every check of phase 10.  The last line compares the bursts'
ms per transition of all 64 chains.  Any failure exits non-zero.
"""

import faulthandler
import json
import os
import sys
import time

import chip_smoke as cs

RANK_COUNTS = (2, 4)


def main(argv):
    rehearse = "--rehearse" in argv
    faulthandler.dump_traceback_later(600, exit=True)
    t0 = time.perf_counter()
    import torch

    if rehearse:
        torch.set_num_threads(1)
        dev, (M, T, C), card = torch.device("cpu"), (12, 20, 4), ""
    else:
        if torch.cuda.device_count() < max(RANK_COUNTS):
            print(f"mesh_scale.py needs {max(RANK_COUNTS)} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        dev, (M, T, C) = torch.device("cuda"), (cs.M, cs.T, cs.C)
        card = cs.card_line()
        from covid19uk_tpu_torch.ops import _build

        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
    model, state, _ = cs.build_chains(torch, dev, M, T, C)
    _, _, _, fused_ms = cs.phase_driver(
        torch, 6, model, state, cs.uk_driver_config(T), cs.UK_DRIVER,
        "fused_sweep", card)
    del model, state
    bursts = {1: [fused_ms[0]]}
    for ranks in RANK_COUNTS:
        bursts[ranks] = cs.phase_10(torch, dev, M, T, C, cs.UK_DRIVER,
                                    fused_ms[0], card, ranks=ranks)[2]
    print(json.dumps({"burst_ms_per_transition": bursts, "chains": C,
                      "M": M, "card": card or "cpu",
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return 3 if rehearse else 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
