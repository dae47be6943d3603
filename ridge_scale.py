#!/usr/bin/env python3
"""How finely float32 resolves the gamma0-compensated moves' ridge shift.

    python3 ridge_scale.py

The compensated moves shift gamma0 by ``log PT - log PT'``, PT the
infectious person-time (the sum of the I compartment over locations and
days).  Moving x E->I events by d days changes PT by x*d, so one
person-day shifts gamma0 by about 1/PT, while float32 resolves log PT
only to its spacing.  For each state below the script prints PT, log PT,
the float32 spacing of log PT, 1/PT, and 1/PT in spacings:

* the synthetic full-UK model of ``chip_smoke.py`` (M=380, T=120), one
  chain simulated from seed 0 at the initial parameters;
* the repo's case data, ``data/uk_example/inferencedata.h5`` (380
  local authorities) and ``ni_run/inferencedata.h5`` (Northern
  Ireland), at the state the ``mcmc`` driver starts from
  (``initialize_from_cases``, seed 1).

Runs on the CPU; reading the case data needs h5py.
"""

import os

import numpy as np
import torch

from covid19uk_tpu_torch.inference.driver import initialize_from_cases
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.utils import ncio
from covid19uk_tpu_torch.utils.synthetic import (
    build_synthetic_model, initial_parameters)

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = ["data/uk_example/inferencedata.h5", "ni_run/inferencedata.h5"]


def report(name, state):
    pt = float(torch.sum(state[..., 2], dtype=torch.float64))
    log_pt = np.float32(np.log(pt))
    spacing = float(np.spacing(log_pt))
    print(f"{name}: PT {pt!r} person-days, log PT {float(log_pt)!r}, "
          f"float32 spacing {spacing!r}, 1/PT {1 / pt!r} = "
          f"{1 / pt / spacing!r} spacings")


def main():
    model = build_synthetic_model(380, 120, torch.float32, device="cpu")
    events = model.sample_seir(torch.Generator().manual_seed(0),
                               initial_parameters(model))
    report("synthetic UK model, one chain",
           seir.compute_state(model.initial_state, events))
    for path in DATA:
        obs = ncio.load_group(os.path.join(ROOT, path), "observations")
        const = ncio.load_group(os.path.join(ROOT, path), "constant_data")
        init, events = initialize_from_cases(
            np.asarray(obs["cases"], np.float64), const["N"], 1)
        report(f"{path}, the driver's start",
               seir.compute_state(torch.as_tensor(init),
                                  torch.as_tensor(events)))


if __name__ == "__main__":
    main()
