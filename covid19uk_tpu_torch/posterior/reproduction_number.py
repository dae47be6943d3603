"""Posterior reproduction numbers R_it / R_t from next-generation matrices.

Port of ``covid19uk_tpu/posterior/reproduction_number.py``.  R_it is the
sum over destinations of each sample's NGM at each day.  The samples go
in chunks of ``CHUNKSIZE`` (the reference's throttle); inside a chunk the
NGMs of a block of days are built together and reduced at once, with the
block sized so that one ``[S, D, M, M]`` temporary stays near 256 MiB
whatever M is.
"""

import pickle as pkl

import numpy as np
import torch

from covid19uk_tpu_torch.inference.driver import run_device
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.ngm import next_generation_matrix_fn
from covid19uk_tpu_torch.models.spec import ModelData
from covid19uk_tpu_torch.posterior.predict import _params_from_samples
from covid19uk_tpu_torch.utils import ncio

CHUNKSIZE = 50
# bytes of one [S, D, M, M] temporary of a block of days
_BLOCK_BYTES = 2**28


def calc_posterior_rit(samples, initial_state, times, data: ModelData,
                       dtype=torch.float32):
    """Per-sample, per-day R_it: row sums of the NGM over destinations,
    ``[S, T, M]`` on ``data``'s device (reference calc_posterior_rit,
    reproduction_number.py:13-44)."""
    device = data.N.device
    initial_state = torch.as_tensor(np.asarray(initial_state), dtype=dtype,
                                    device=device)
    events = torch.as_tensor(np.asarray(samples["seir"]), dtype=dtype,
                             device=device)
    params = _params_from_samples(samples, dtype=dtype, device=device)
    times = torch.as_tensor(np.asarray(times), device=device)

    state = seir.compute_state(initial_state, events)  # [S, M, T, 4]
    ngm_fn = next_generation_matrix_fn(data, params)
    S, M = events.shape[0], data.num_locations
    per_day = max(1, S * M * M * state.element_size())
    block = max(1, _BLOCK_BYTES // per_day)
    out = []
    for start in range(0, times.shape[0], block):
        t = times[start:start + block]
        st = state[:, :, t, :].transpose(1, 2)  # [S, D, M, 4]
        out.append(torch.sum(ngm_fn(t, st), dim=-2))  # sum destinations
    return torch.cat(out, dim=1)  # [S, T, M]


def reproduction_number(input_files, output_file, device="cuda"):
    """CLI-level R_t computation (reference reproduction_number.py:50-88)
    on ``device`` (``"cuda"`` raises without a card).

    Writes group ``posterior_predictive`` with R_it [iteration, time,
    location] and the population-weighted R_t [iteration, time].
    """
    device = run_device(device)
    covar = ncio.load_group(input_files[0], "constant_data")

    with open(input_files[1], "rb") as f:
        samples = pkl.load(f)

    initial_state = samples.pop("initial_state")
    # dense only, no raw C: the NGM reads Cstar
    data = ModelData.create(
        covar.variables, torch.float32, sparse=False, keep_C=False,
        device=device,
    )
    times = np.arange(samples["seir"].shape[-2])
    r_it = posterior_rit(samples, initial_state, times, data)
    r_t = population_weighted(r_it, covar["N"])

    out = ncio.Group(
        variables=dict(R_it=r_it, R_t=r_t),
        dims=dict(
            R_it=("iteration", "time", "location"),
            R_t=("iteration", "time"),
        ),
        coords=dict(
            time=covar.coords.get("time", times),
            location=covar.coords.get("location", np.arange(r_it.shape[-1])),
        ),
    )
    ncio.save_group(output_file, "posterior_predictive", out)
    ncio.copy_attrs(input_files[0], output_file)
    return r_it, r_t


def posterior_rit(samples, initial_state, times, data: ModelData,
                  dtype=torch.float32):
    """:func:`calc_posterior_rit` over the samples in chunks of
    ``CHUNKSIZE``; ``[S, T, M]`` numpy on the host."""
    num_samples = samples["seir"].shape[0]
    r_its = []
    for start in range(0, num_samples, CHUNKSIZE):
        end = min(start + CHUNKSIZE, num_samples)
        print(f"Chunk {start}:{end}", flush=True)
        sub = {k: v[start:end] for k, v in samples.items()}
        r_its.append(calc_posterior_rit(sub, initial_state, times, data,
                                        dtype).cpu().numpy())
    return np.concatenate(r_its, axis=0)


def population_weighted(r_it, N):
    """R_t: the sum of R_it over locations weighted by N / sum(N), in
    float64 on the host."""
    N = np.squeeze(np.asarray(N, np.float64))
    weight = N / N.sum()
    return (r_it * weight[None, None, :]).sum(-1)


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser()
    parser.add_argument(
        "samples", type=str, help="A pickle file with MCMC samples"
    )
    parser.add_argument(
        "-d", "--data", type=str, help="The inferencedata file", required=True
    )
    parser.add_argument(
        "-o", "--output", type=str, help="The output file", required=True
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the run (default cuda; cpu for the CPU)",
    )
    args = parser.parse_args(argv)

    reproduction_number([args.data, args.samples], args.output,
                        device=args.device)


if __name__ == "__main__":
    main()
