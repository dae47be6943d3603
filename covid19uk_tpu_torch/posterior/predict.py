"""Forward prediction from posterior samples (torch).

Port of ``covid19uk_tpu/posterior/predict.py``.  Every posterior sample
simulates at once, each from its own state at ``init_step``: the samples
are the batch axis of the chain-binomial simulation, so each day's
commute is one ``[S, M] @ [M, M]`` product.  Draws come from a
``torch.Generator`` on the run's device seeded by ``seed``; they are not
the JAX package's draws, so the two agree in distribution only.
"""

import pickle as pkl

import numpy as np
import torch

from covid19uk_tpu_torch.inference.driver import run_device
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import CovidUK, ModelData, Parameters
from covid19uk_tpu_torch.utils import ncio


def _params_from_samples(samples, dtype=torch.float32, device="cpu"):
    """Parameters of every sample, with a leading sample axis, as tensors
    on ``device``."""
    return Parameters(*[
        torch.as_tensor(np.asarray(samples[k]), dtype=dtype, device=device)
        for k in Parameters._fields])


def predicted_incidence(
    posterior_samples,
    init_state,
    data: ModelData,
    init_step,
    num_steps,
    out_of_sample=False,
    seed=0,
    dtype=torch.float32,
):
    """Simulates forward from each sample's state at ``init_step``, on the
    device ``data`` lives on.

    Args:
      posterior_samples: dict of arrays with keys psi, sigma_space,
        beta_area, gamma0, gamma1, alpha_0, alpha_t, spatial_effect, seir,
        with a leading sample axis.
      init_state: ``[M, 4]`` shared initial state (from the posterior).
      data: ModelData whose ``weekday`` covers the prediction window.
      init_step: absolute day to start from (non-negative; the CLI
        resolves negative indices).
      num_steps: days to simulate.
      out_of_sample: re-base alpha_0 to the random walk's value at
        ``init_step - 1`` and redraw alpha_t from its prior over the
        prediction window (:meth:`CovidUK.sample_prior_alpha_t`).  The
        rate function gathers the walk at clipped absolute time, so for
        ``init_step >= num_steps - 1`` the whole window reads the walk's
        endpoint, as in the reference.
      seed: seed of the run's ``torch.Generator``.
      dtype: the computation's dtype (float32 as the JAX package).

    Returns:
      (new_init_state ``[S, M, 4]``, events ``[S, M, num_steps, 3]``),
      tensors on ``data``'s device.
    """
    device = data.N.device
    events_post = torch.as_tensor(np.asarray(posterior_samples["seir"]),
                                  dtype=dtype, device=device)
    init_state = torch.as_tensor(np.asarray(init_state), dtype=dtype,
                                 device=device)
    num_samples = events_post.shape[0]

    state = seir.compute_state(init_state, events_post)  # [S, M, T, 4]
    new_init_state = state[..., init_step, :].contiguous()  # [S, M, 4]
    del state

    params = _params_from_samples(posterior_samples, dtype=dtype,
                                  device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = CovidUK(data, new_init_state, init_step, num_steps)

    if out_of_sample:
        alpha_traj = params.alpha_0[:, None] + torch.cumsum(
            params.alpha_t, dim=-1)
        if init_step > 0:
            # an index past the walk reads its end, as JAX's gather does
            last = min(init_step - 1, alpha_traj.shape[-1] - 1)
            params = params._replace(alpha_0=alpha_traj[:, last])
        params = params._replace(alpha_t=model.sample_prior_alpha_t(
            gen, dtype, batch_shape=(num_samples,)))

    events = model.sample_seir(gen, params)
    return new_init_state, events


def read_pkl(filename):
    with open(filename, "rb") as f:
        return pkl.load(f)


def predict(
    data,
    posterior_samples,
    output_file,
    initial_step,
    num_steps,
    out_of_sample=False,
    device="cuda",
):
    """CLI-level prediction (reference predict.py:80-146) on ``device``
    (``"cuda"`` raises without a card).

    Writes group ``predictions`` with events [iteration, location, time,
    event] and initial_state [iteration, location, state]; returns both
    as numpy arrays.
    """
    device = run_device(device)
    covar = ncio.load_group(data, "constant_data")
    obs = ncio.load_group(data, "observations")

    samples = read_pkl(posterior_samples)
    initial_state = samples.pop("initial_state")

    if initial_step < 0:
        initial_step = samples["seir"].shape[-2] + initial_step

    origin_date = np.asarray(obs.coords["time"]).astype("datetime64[D]")[0]
    model_data, dates = prediction_data(
        covar.variables, origin_date, initial_step + num_steps, device)

    estimated_init_state, predicted_events = predicted_incidence(
        samples,
        initial_state,
        model_data,
        initial_step,
        num_steps,
        out_of_sample,
    )
    estimated_init_state = estimated_init_state.cpu().numpy()
    predicted_events = predicted_events.cpu().numpy()

    pred = ncio.Group(
        variables=dict(
            events=predicted_events,
            initial_state=estimated_init_state,
        ),
        dims=dict(
            events=("iteration", "location", "time", "event"),
            initial_state=("iteration", "location", "state"),
        ),
        coords=dict(
            time=dates[initial_step:],
            location=covar.coords.get(
                "location", np.arange(predicted_events.shape[1])
            ),
        ),
    )
    ncio.save_group(output_file, "predictions", pred)
    ncio.copy_attrs(data, output_file)
    return estimated_init_state, predicted_events


def prediction_data(covariates, origin_date, num_days, device):
    """ModelData for a prediction that ends ``num_days`` after
    ``origin_date``, with the weekday covariate extended over those days
    (reference predict.py:106-110: 1.0 Monday to Friday, else 0.0); dense
    only and without the raw C, since the simulation reads Cstar alone.
    Returns (ModelData, the days as datetime64[D])."""
    origin = np.datetime64(origin_date, "D")
    dates = np.arange(origin, origin + np.timedelta64(num_days, "D"),
                      np.timedelta64(1, "D"))
    covariates = dict(covariates)
    dow = (dates.view("int64") + 3) % 7  # the epoch, day 0, was a Thursday
    covariates["weekday"] = (dow < 5).astype(float)
    data = ModelData.create(covariates, torch.float32, sparse=False,
                            keep_C=False, device=device)
    return data, dates


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser()
    parser.add_argument(
        "-i", "--initial-step", type=int, default=0, help="Initial step"
    )
    parser.add_argument(
        "-n", "--num-steps", type=int, default=1, help="Number of steps"
    )
    parser.add_argument(
        "-o",
        "--out-of-sample",
        action="store_true",
        help="Out of sample prediction (sample alpha_t)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the run (default cuda; cpu for the CPU)",
    )
    parser.add_argument("data_pkl", type=str, help="Covariate data file")
    parser.add_argument(
        "posterior_samples_pkl", type=str, help="Posterior samples pickle"
    )
    parser.add_argument("output_file", type=str, help="Output file")
    args = parser.parse_args(argv)

    predict(
        args.data_pkl,
        args.posterior_samples_pkl,
        args.output_file,
        args.initial_step,
        args.num_steps,
        args.out_of_sample,
        device=args.device,
    )


if __name__ == "__main__":
    main()
