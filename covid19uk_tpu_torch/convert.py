"""Carries the JAX package's model and chain state over to the port.

Every function takes objects whose fields are array-likes (JAX arrays or
numpy), reads them through ``numpy.asarray`` and returns the port's
objects on ``device``, keeping each array's dtype.  Nothing here imports
JAX: the tests use it to hand both packages the same model and state.
"""

import numpy as np
import torch

from covid19uk_tpu_torch.inference.gibbs import ChainState, HMCTunables
from covid19uk_tpu_torch.models.spec import CovidUK, ModelData


def tensor(a, device):
    """An array-like as a tensor on ``device`` (same dtype, a copy)."""
    return torch.tensor(np.asarray(a), device=device)


def model_data(data, device):
    """A JAX ``ModelData`` (dense) as the port's ``ModelData``."""
    for field in ("Cstar_bsr", "car_band"):
        if getattr(data, field, None) is not None:
            raise NotImplementedError(
                f"{field} is not ported yet (MSOA-scale slice)"
            )
    return ModelData(
        **{f: tensor(getattr(data, f), device) for f in ModelData._fields}
    )


def model(jax_model, device):
    """A JAX ``CovidUK`` as the port's ``CovidUK``."""
    return CovidUK(
        model_data(jax_model.data, device),
        tensor(jax_model.initial_state, device),
        int(jax_model.initial_step),
        int(jax_model.num_steps),
    )


def chain_state(state, device):
    """A ``ChainState`` (shapes as given: stack chains first)."""
    return ChainState(u=tensor(state.u, device),
                      events=tensor(state.events, device))


def hmc_tunables(tune, device):
    """An ``HMCTunables``; None overrides stay None."""
    return HMCTunables(
        *[None if v is None else tensor(v, device) for v in tune]
    )
