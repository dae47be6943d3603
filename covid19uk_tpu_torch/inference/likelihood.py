"""Per-sweep rate ingredients of the event kernels (torch).

Port of ``LikelihoodContext`` / ``make_context`` from
``covid19uk_tpu/inference/likelihood.py``, batched over chains.  The
windowed evaluator of the unfused kernels comes with the pair-move slice.
"""

from typing import NamedTuple

import torch

from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import (
    CovidUK,
    Parameters,
    _alpha_timeseries,
    _tail,
)


class LikelihoodContext(NamedTuple):
    """Rate ingredients at fixed parameters (leading chain dim optional)."""

    exp_eta: torch.Tensor  # [..., M, T]
    psi_w: torch.Tensor  # [..., T] = psi * w_t
    rate_ir_t: torch.Tensor  # [..., T]
    nu: torch.Tensor  # scalar
    Cstar: torch.Tensor  # [M, M] dense
    N: torch.Tensor  # [M]


def make_context(model: CovidUK, params: Parameters) -> LikelihoodContext:
    d = model.data
    dtype = model.initial_state.dtype
    t_abs = model._t_abs()
    w_t = model._gather_t(d.W, t_abs)
    weekday_t = model._gather_t(d.weekday, t_abs)
    alpha = _alpha_timeseries(params.alpha_0, params.alpha_t, t_abs)
    eta = (
        alpha[..., None, :]
        + _tail(params.beta_area, 2) * d.log_area[:, None]
        + _tail(params.sigma_space, 2) * params.spatial_effect[..., :, None]
    )
    return LikelihoodContext(
        exp_eta=torch.exp(eta),
        psi_w=_tail(params.psi, 1) * w_t,
        rate_ir_t=torch.exp(
            _tail(params.gamma0, 1) + _tail(params.gamma1, 1) * weekday_t
        ),
        nu=torch.tensor(seir.NU, dtype=dtype, device=d.N.device),
        Cstar=d.Cstar,
        N=d.N,
    )
