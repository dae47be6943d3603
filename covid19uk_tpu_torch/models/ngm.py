"""Next-generation-matrix computation (torch).

Port of ``covid19uk_tpu/models/ngm.py``.  The NGM at day t is

    ngm[i, j] = (1 - exp(-rate[i, j])) * S_i * E[infectious period]
    rate[i, j] = exp(eta_ij) * (I_{ij} + psi * w_t * Cstar[i,j] / N_j) / N_i
    eta_ij     = alpha_t + beta_area * log_area_i + sigma * spatial_j
    E[period]  = 1 / (1 - exp(-exp(gamma0)))

with the reference's broadcasts kept: ``log_area`` runs along the rows
(destinations i), the spatial effect along the columns (sources j), and
S along the rows.  The port evaluates the NGMs of many samples and a
block of days in one call: parameters may lead with a sample axis
``[...]``, and ``t`` is a ``[D]`` tensor of days.
"""

import torch

from covid19uk_tpu_torch.models.spec import ModelData, Parameters, _tail


def _alpha_timeseries_ngm(alpha_0, alpha_t, t_abs):
    """The NGM's random-walk gather, distinct from the rate function's.

    ``b = alpha_0 + cumsum(alpha_t)``; alpha_0 at t == 0, else
    ``b[clip(t, 0, T-2)]``: no ``t - 1`` here, unlike the transition-rate
    gather (:func:`covid19uk_tpu_torch.models.spec._alpha_timeseries`).
    The two conventions are one day apart for 1 <= t <= T-2; both are
    kept (PARITY.md, "NGM alpha_t gather").

    ``alpha_0`` is ``[...]``, ``alpha_t`` ``[..., T-1]``, ``t_abs`` a long
    tensor of any shape; returns ``[...] + t_abs.shape``.
    """
    b = alpha_0[..., None] + torch.cumsum(alpha_t, dim=-1)
    flat = t_abs.reshape(-1)
    idx = torch.clamp(flat, 0, alpha_t.shape[-1] - 1)
    out = torch.where(flat == 0, alpha_0[..., None], b[..., idx])
    return out.reshape(alpha_0.shape + t_abs.shape)


def next_generation_matrix_fn(data: ModelData, params: Parameters):
    """Returns ``fn(t, state) -> ngm`` for a ``[D]`` long tensor of days
    ``t``, ``state`` ``[..., D, M, 4]`` and the result ``[..., D, M, M]``;
    ``[...]`` is the parameters' batch shape (one day is a block of one).
    """

    def fn(t, state):
        t = torch.as_tensor(t, device=state.device)
        dtype = state.dtype
        M = data.num_locations
        w_t = data.W[torch.clamp(t, 0, data.W.shape[0] - 1)]
        alpha = _alpha_timeseries_ngm(params.alpha_0, params.alpha_t, t)
        spatial = params.spatial_effect
        spatial = spatial.reshape(spatial.shape[:-1] + (1, 1, M))
        eta = (
            _tail(alpha, 2)
            + _tail(params.beta_area, 3) * data.log_area[:, None]
            + _tail(params.sigma_space, 3) * spatial
        )  # [..., D, M, M]: rows i, columns j
        infec_rate = (
            torch.exp(eta)
            * (
                torch.eye(M, dtype=dtype, device=state.device)
                + _tail(params.psi, 3) * _tail(w_t, 2)
                * data.Cstar / data.N[None, :]
            )
            / data.N[:, None]
        )
        infec_prob = -torch.expm1(-infec_rate)
        # S broadcasts over the row (destination) axis, as the reference
        # code has it (state[..., 0][..., newaxis]).
        expected_new_infec = infec_prob * state[..., 0][..., :, None]
        expected_infec_period = 1.0 / (
            -torch.expm1(-torch.exp(params.gamma0)))
        return expected_new_infec * _tail(expected_infec_period, 3)

    return fn
