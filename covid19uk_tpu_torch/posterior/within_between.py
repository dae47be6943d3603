"""Within- vs between-location infection-pressure attribution (torch).

Port of ``covid19uk_tpu/posterior/within_between.py``: splits the
infection pressure at the final inference day into within-LAD and
between-LAD components per posterior sample, summarised to CSV.  pandas
is imported inside :func:`within_between` only.
"""

import pickle as pkl

import numpy as np
import torch

from covid19uk_tpu_torch.inference.driver import run_device
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import ModelData
from covid19uk_tpu_torch.utils import ncio


def make_within_rate_fns(data: ModelData, psi):
    """Within/between rate functions ``(t, state[S, M, 4]) -> [S, M]``
    for per-sample ``psi`` ``[S]`` (reference within_between.py:13-43).

    The reference evaluates them at ``t = len(W)``, which clips to the
    final commute volume (within_between.py:51-52); kept here.
    """
    psi = psi[..., None]
    C_colsum = torch.sum(data.C, dim=-2)
    C_sym = data.C + data.C.T

    def w_at(t):
        return data.W[min(max(int(t), 0), data.W.shape[0] - 1)]

    def within_fn(t, state):
        infectious = state[..., 2]
        return infectious - psi * infectious / data.N * w_at(t) * C_colsum

    def between_fn(t, state):
        # (C + C') @ (I/N) for every sample at once; C + C' is symmetric
        return psi * w_at(t) * torch.matmul(state[..., 2] / data.N, C_sym)

    return within_fn, between_fn


def calc_pressure_components(data: ModelData, psi, state):
    """Per-sample within/between fractions ``([S, M], [S, M])`` at one
    state snapshot ``[S, M, 4]`` (reference within_between.py:47-56)."""
    t_final = data.W.shape[0]
    within_fn, between_fn = make_within_rate_fns(data, psi)
    within = within_fn(t_final, state)
    between = between_fn(t_final, state)
    total = within + between
    return within / total, between / total


def within_between(input_files, output_file, device="cuda"):
    """CLI-level summary (reference within_between.py:59-92) on
    ``device`` (``"cuda"`` raises without a card).

    Precision as the JAX package's: float64 on the CPU (its CPU rig runs
    with x64, the reference's precision), float32 on the card (as JAX on
    an accelerator).
    """
    import pandas as pd

    device = run_device(device)
    covar = ncio.load_group(input_files[0], "constant_data")
    with open(input_files[1], "rb") as f:
        samples = pkl.load(f)

    dtype = torch.float64 if device.type == "cpu" else torch.float32
    data = ModelData.create(covar.variables, dtype, sparse=False,
                            device=device)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    psi = dev(samples["psi"])
    events = dev(samples["seir"])
    init_state = dev(samples["initial_state"])

    state = seir.compute_state(init_state, events)
    within, between = calc_pressure_components(data, psi, state[..., -1, :])
    within, between = within.cpu().numpy(), between.cpu().numpy()

    locations = covar.coords.get(
        "location", np.arange(within.shape[-1]).astype(str)
    )
    df = pd.DataFrame(
        dict(
            within_mean=within.mean(axis=0),
            between_mean=between.mean(axis=0),
            # Divergence from the reference (within_between.py:87), as in
            # the JAX package: the per-location posterior probability, not
            # one axis-less mean broadcast to every row (PARITY.md).
            p_within_gt_between=np.mean(within > between, axis=0),
        ),
        index=pd.Index(np.asarray(locations).astype(str), name="location"),
    )
    df.to_csv(output_file)
    return df


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser()
    parser.add_argument(
        "-d", "--datafile", type=str, help="Inferencedata file", required=True
    )
    parser.add_argument(
        "-s",
        "--samples",
        type=str,
        help="Posterior samples pickle",
        required=True,
    )
    parser.add_argument("-o", "--output", type=str, help="Output csv")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the run (default cuda; cpu for the CPU)",
    )
    args = parser.parse_args(argv)

    within_between([args.datafile, args.samples], args.output,
                   device=args.device)


if __name__ == "__main__":
    main()
