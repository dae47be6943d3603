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
    """A JAX ``ModelData`` as the port's ``ModelData``, with its
    block-sparse ``Cstar_bsr`` and banded ``car_band`` operators."""
    from covid19uk_tpu_torch.ops.banded import BandedSym
    from covid19uk_tpu_torch.ops.block_sparse import BlockSparse

    def index(a):
        return None if a is None else tensor(a, device).long()

    fields = {f: tensor(getattr(data, f), device)
              for f in ModelData._fields[:8]}
    bsr = getattr(data, "Cstar_bsr", None)
    if bsr is not None:
        fields["Cstar_bsr"] = BlockSparse(
            tensor(bsr.values, device), tensor(bsr.col_idx, device),
            int(bsr.n), index(bsr.perm), index(bsr.inv_perm))
    band = getattr(data, "car_band", None)
    if band is not None:
        fields["car_band"] = BandedSym(
            tensor(band.diag, device), tensor(band.upper, device),
            index(band.perm), index(band.inv_perm),
            int(band.n))
    return ModelData(**fields)


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
