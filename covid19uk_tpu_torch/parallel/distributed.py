"""Multi-process initialization and the dry-run worker.

Port of ``covid19uk_tpu/parallel/distributed.py`` on ``torch.distributed``.
One process (rank) drives one device; a run over ``world`` ranks splits
its chains between them (``parallel/sharding.py``).

:func:`initialize` is the guarded entry: a no-op for a single-process run,
explicit arguments or torch's standard launcher variables otherwise.
``python -m covid19uk_tpu_torch.parallel.distributed`` is the per-rank
dry-run worker that :func:`spawn_dryrun` starts: it joins the group, runs
one sharded transition (``parallel/dryrun.py``) and prints a checksum that
must agree across ranks.
"""

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

_ROOT = Path(__file__).resolve().parents[2]


def is_distributed():
    """True once :func:`initialize` has joined a group of more than one
    rank."""
    return dist.is_available() and dist.is_initialized() and (
        dist.get_world_size() > 1)


def world():
    """The number of ranks, 1 when no group is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    """This process's rank, 0 when no group is initialized."""
    return dist.get_rank() if dist.is_initialized() else 0


def _local_rank():
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device(device):
    """``device`` for this rank: an index-free ``cuda`` becomes
    ``cuda:{LOCAL_RANK % device_count}`` when more than one rank runs
    (LOCAL_RANK defaults to the rank), every other device stays as it
    is."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None and is_distributed()
            and torch.cuda.is_available()):
        return torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return device


def _backend(world_size):
    """NCCL when every rank of this host has a card of its own, else gloo
    (NCCL refuses two ranks on one card; gloo also serves the CPU)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def initialize(init_method=None, world_size=None, rank=None, backend=None):
    """Guarded ``torch.distributed.init_process_group``.

    A single-process run (no arguments, no environment) is a no-op, so
    every entry point can call this unconditionally.  Arguments fall back
    to torch's launcher variables (those ``torchrun`` sets), not JAX's:
    ``MASTER_ADDR``/``MASTER_PORT`` (``init_method="env://"``),
    ``WORLD_SIZE``, ``RANK``; a rank's card is ``LOCAL_RANK`` modulo the
    card count (:func:`local_device`).  ``backend`` defaults to NCCL when
    every rank on the host has a card of its own and to gloo otherwise.

    Returns True if the process is (already) in a group.
    """
    if dist.is_initialized():
        return True
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and world_size is None:
        return False  # single process
    backend = backend or _backend(world_size)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _worker_main(argv=None):
    """Per-rank dry-run worker (see module docstring)."""
    from argparse import ArgumentParser

    parser = ArgumentParser(description="distributed dry-run worker")
    parser.add_argument("--init-method", required=True)
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)  # tiny shapes; ranks share the host
    initialize(args.init_method, args.world_size, args.rank)
    try:
        from covid19uk_tpu_torch.parallel.dryrun import run_sharded_step

        checksum, info = run_sharded_step(args.device)
        # the parent greps this prefix and checks the ranks agree
        print(f"DISTRIBUTED_CHECKSUM rank={args.rank} value={checksum!r} "
              f"{info}", flush=True)
    finally:
        dist.destroy_process_group()


def run_ranks(argv, world_size, timeout=300):
    """Starts ``argv(r)`` for every rank ``r`` of ``world_size`` on this
    host (the repo on ``PYTHONPATH``, gloo on the loopback interface),
    waits for all of them and returns their outputs (stdout and stderr
    together).  Raises ``RuntimeError`` with every rank's output if one
    fails; every rank is ended before it returns, on a timeout too."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host, no network
    procs = [subprocess.Popen(argv(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=str(_ROOT))
             for r in range(world_size)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(
            f"rank {r} exited {p.returncode}:\n{out}"
            for r, (p, out) in enumerate(zip(procs, outs))))
    return outs


def spawn_dryrun(world_size, device="cuda", timeout=300):
    """Runs ``world_size`` dry-run workers on this host (a file store,
    gloo or NCCL as :func:`initialize` picks) and checks that every rank
    printed the same checksum.  The counterpart of the JAX package's
    ``__graft_entry__.dryrun_multichip``.  Returns ``(checksum, output of
    rank 0)``; raises ``RuntimeError`` if a rank fails or the checksums
    differ."""
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(lambda r: [
            sys.executable, "-m", "covid19uk_tpu_torch.parallel.distributed",
            "--init-method", f"file://{tmp}/store", "--world-size",
            str(world_size), "--rank", str(r), "--device", device],
            world_size, timeout)
    values = []
    for r, out in enumerate(outs):
        found = re.findall(rf"DISTRIBUTED_CHECKSUM rank={r} value=(\S+)", out)
        if not found:
            raise RuntimeError(f"dry-run rank {r} printed no checksum:\n{out}")
        values.append(float(found[0]))
    if len(set(values)) != 1:
        raise RuntimeError(f"dry-run checksums differ across ranks: {values}")
    return values[0], outs[0]


if __name__ == "__main__":
    _worker_main()
