"""CovidUK model: priors + SEIR process as one log-density (torch).

Port of ``covid19uk_tpu/models/spec.py``.  Parameters
may carry a leading chain dimension (``psi`` of shape ``[C]``, ``alpha_t``
of ``[C, T-1]`` and so on); every function broadcasts over it, so C chains
are evaluated together and autograd of the sum over chains gives each
chain's gradient.

Parameter vector order (as the JAX package and the reference):

    [psi, sigma_space, beta_area, gamma0, gamma1, alpha_0,
     alpha_t (T-1), spatial_effect (M)]

with a softplus bijection on (psi, sigma_space).
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.ops.binomial import log_choose

_LOG_2PI = math.log(2.0 * math.pi)

# The reference adds 1e-9 to the infection rate.
RATE_EPS = 1e-9
# CAR prior autocorrelation parameter.
CAR_RHO = 0.25


def _tail(x, n):
    """``x`` with ``n`` trailing singleton dimensions (batch broadcasting)."""
    return x.reshape(x.shape + (1,) * n)


class ModelData(NamedTuple):
    """Pre-processed covariates on the device.

    Same fields and host arithmetic as the JAX ``ModelData``: ``Cstar`` is
    ``C + C'`` with diagonal ``-colsum(C)``, ``car_precision`` is
    ``Dw - rho * adjacency`` and ``car_logdet`` its log-determinant.
    ``Cstar_bsr`` is an optional block-sparse operator for ``Cstar``
    (:class:`ops.block_sparse.BlockSparse`, the K2 kernel) and
    ``car_band`` an optional block-tridiagonal operator for the CAR
    precision (:class:`ops.banded.BandedSym`); with ``car_band`` the dense
    ``car_precision`` is a ``[0, 0]`` placeholder."""

    C: torch.Tensor
    Cstar: torch.Tensor
    W: torch.Tensor
    N: torch.Tensor
    weekday: torch.Tensor
    log_area: torch.Tensor
    car_precision: torch.Tensor
    car_logdet: torch.Tensor
    Cstar_bsr: object = None
    car_band: object = None

    @property
    def num_locations(self):
        return self.N.shape[0]

    @classmethod
    def create(cls, covariates, dtype=torch.float32, sparse="auto",
               keep_C=True, num_chains=1, device="cuda"):
        """Builds ModelData from raw covariate arrays (keys ``C``, ``W``,
        ``N``, ``adjacency``, ``weekday``, ``area``) on ``device``.

        ``sparse``: "auto" builds the block-sparse ``Cstar`` operator when
        M >= 1024, the run is single-chain (``num_chains``) and the block
        density after RCM reordering is <= 0.3, and the banded CAR
        operator when M >= 1024; True forces both, False builds neither.
        ``keep_C=False`` stores ``C`` as a ``[0, 0]`` placeholder."""
        hdtype = np.float64 if dtype == torch.float64 else np.float32
        C = np.array(covariates["C"], hdtype)
        np.fill_diagonal(C, 0.0)
        Cstar = C + C.T
        np.fill_diagonal(
            Cstar, -C.sum(axis=-2, dtype=np.float64).astype(hdtype)
        )

        weekday = np.asarray(covariates["weekday"], np.float64)
        weekday = weekday - weekday.mean()

        area = np.asarray(covariates["area"], np.float64)
        log_area = np.log(area / 100000000.0)
        log_area = log_area - log_area.mean()

        adjacency = np.asarray(covariates["adjacency"])
        deg = adjacency.sum(axis=-1, dtype=np.float64)
        precision = np.multiply(adjacency, -CAR_RHO, dtype=hdtype)
        idx = np.arange(precision.shape[0])
        precision[idx, idx] += deg.astype(hdtype)
        car_logdet = _car_log_det(precision)

        Cstar_bsr = _maybe_block_sparse(Cstar, dtype, sparse, num_chains,
                                        device)
        car_band = _maybe_banded(precision, dtype, sparse, device)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        empty = torch.zeros((0, 0), dtype=dtype, device=device)
        return cls(
            C=dev(C) if keep_C else empty,
            Cstar=dev(Cstar),
            W=dev(np.squeeze(np.asarray(covariates["W"]))),
            N=dev(np.squeeze(np.asarray(covariates["N"]))),
            weekday=dev(weekday),
            log_area=dev(log_area),
            car_precision=empty if car_band is not None else dev(precision),
            car_logdet=dev(car_logdet),
            Cstar_bsr=Cstar_bsr,
            car_band=car_band,
        )


def _maybe_block_sparse(a, dtype, sparse, num_chains=1, device="cuda"):
    """A :class:`BlockSparse` operator for ``a`` when it pays, as the JAX
    package decides: not below M = 1024, not for several chains, not above
    a block density of 0.3 (``sparse="auto"``); always for True."""
    if sparse is False:
        return None
    M = a.shape[0]
    if sparse == "auto" and (M < 1024 or num_chains >= 2):
        return None
    from covid19uk_tpu_torch.ops.block_sparse import BlockSparse

    # symmetric by construction (Cstar = C + C')
    bsr = BlockSparse.from_dense(a, dtype, check_symmetric=False,
                                 device=device)
    if sparse == "auto" and bsr.block_density > 0.3:
        return None
    return bsr


def _maybe_banded(a, dtype, sparse, device="cuda"):
    """A :class:`BandedSym` CAR-precision operator when it pays."""
    if sparse is False:
        return None
    if sparse == "auto" and a.shape[0] < 1024:
        return None
    from covid19uk_tpu_torch.ops.banded import BandedSym

    return BandedSym.from_dense(a, dtype, device=device)


def _car_log_det(precision):
    """``log det`` of the CAR precision: dense Cholesky up to M = 2048, a
    sparse LU above (the matrix is SPD and adjacency-sparse, so
    ``log det = sum log|U_ii| + sum log|L_ii|``)."""
    M = precision.shape[0]
    if M <= 2048:
        L = np.linalg.cholesky(precision)
        return 2.0 * np.sum(np.log(np.diag(L)))
    from scipy.sparse import csc_matrix
    from scipy.sparse.linalg import splu

    lu = splu(csc_matrix(precision))
    return float(
        np.sum(np.log(np.abs(lu.U.diagonal())))
        + np.sum(np.log(np.abs(lu.L.diagonal())))
    )


class Parameters(NamedTuple):
    """Constrained model parameters; each field may lead with a chain dim."""

    psi: torch.Tensor
    sigma_space: torch.Tensor
    beta_area: torch.Tensor
    gamma0: torch.Tensor
    gamma1: torch.Tensor
    alpha_0: torch.Tensor
    alpha_t: torch.Tensor  # [..., T-1] random-walk increments
    spatial_effect: torch.Tensor  # [..., M]


def pack_parameters(params: Parameters):
    """Flattens Parameters into the reference's vector order."""
    scalars = torch.stack(
        [params.psi, params.sigma_space, params.beta_area, params.gamma0,
         params.gamma1, params.alpha_0],
        dim=-1,
    )
    return torch.cat([scalars, params.alpha_t, params.spatial_effect], -1)


def unpack_parameters(flat, num_steps, num_locations) -> Parameters:
    """Inverse of :func:`pack_parameters`."""
    T1 = num_steps - 1
    return Parameters(
        psi=flat[..., 0],
        sigma_space=flat[..., 1],
        beta_area=flat[..., 2],
        gamma0=flat[..., 3],
        gamma1=flat[..., 4],
        alpha_0=flat[..., 5],
        alpha_t=flat[..., 6:6 + T1],
        spatial_effect=flat[..., 6 + T1:6 + T1 + num_locations],
    )


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def constrain_parameters(u):
    """Unconstrained -> constrained: ``eps + softplus`` on (psi,
    sigma_space), identity elsewhere."""
    eps = torch.finfo(u.dtype).eps
    head = eps + _softplus(u[..., :2])
    return torch.cat([head, u[..., 2:]], dim=-1)


def unconstrain_parameters(x):
    """Constrained -> unconstrained (inverse softplus on the first two)."""
    finfo = torch.finfo(x.dtype)
    y = torch.clamp(x[..., :2] - finfo.eps, min=finfo.tiny)
    head = y + torch.log(-torch.expm1(-y))
    return torch.cat([head, x[..., 2:]], dim=-1)


def constrain_log_det_jacobian(u):
    """``log|det d constrain(u)/du|`` = sum of log sigmoid over the
    softplus block."""
    return torch.sum(torch.nn.functional.logsigmoid(u[..., :2]), dim=-1)


def _alpha_timeseries(alpha_0, alpha_t, t_abs):
    """Random-walk log-rate at absolute days ``t_abs`` ([T] long):
    alpha_0 at t == 0, else ``b[clip(t-1, 0, T-2)]`` with
    ``b = alpha_0 + cumsum(alpha_t)``."""
    a0 = alpha_0[..., None]
    b = a0 + torch.cumsum(alpha_t, dim=-1)
    idx = torch.clamp(t_abs - 1, 0, alpha_t.shape[-1] - 1)
    return torch.where(t_abs == 0, a0, b[..., idx])


class CovidUK:
    """The generative model over ``[..., M, T, 3]`` event tensors."""

    def __init__(self, data, initial_state, initial_step, num_steps):
        self.data = data  # ModelData
        self.initial_state = initial_state  # [M, S]
        self.initial_step = initial_step  # int
        self.num_steps = num_steps  # int

    def _t_abs(self):
        return self.initial_step + torch.arange(
            self.num_steps, device=self.initial_state.device
        )

    def _gather_t(self, series, t_abs):
        return series[torch.clamp(t_abs, 0, series.shape[0] - 1)]

    # ---------- rates ----------

    def commute_pressure(self, infectious):
        """``Cstar @ (I/N)`` for all days at once: the block-sparse
        operator (K2) when the model has one, else a dense matmul."""
        d = self.data
        if d.Cstar_bsr is not None:
            return d.Cstar_bsr.matmul(infectious / d.N[:, None])
        return torch.matmul(d.Cstar, infectious / d.N[:, None])

    def transition_rates(self, params: Parameters, state, commute=None):
        """``[..., M, T, X]`` rates for all days at once."""
        d = self.data
        t_abs = self._t_abs()
        w_t = self._gather_t(d.W, t_abs)
        weekday_t = self._gather_t(d.weekday, t_abs)
        alpha = _alpha_timeseries(params.alpha_0, params.alpha_t, t_abs)

        eta = (
            alpha[..., None, :]
            + _tail(params.beta_area, 2) * d.log_area[:, None]
            + _tail(params.sigma_space, 2) * params.spatial_effect[..., :, None]
        )
        infectious = state[..., 2]
        if commute is None:
            commute = self.commute_pressure(infectious)
        rate_se = (
            torch.exp(eta)
            * (infectious + _tail(params.psi, 2) * w_t * commute)
            / d.N[:, None]
            + RATE_EPS
        )
        rate_ei = torch.full_like(rate_se, seir.NU)
        rate_ir = torch.exp(
            _tail(params.gamma0, 1) + _tail(params.gamma1, 1) * weekday_t
        )[..., None, :].expand_as(rate_se)
        return torch.stack([rate_se, rate_ei, rate_ir], dim=-1)

    def reduced_loglik_fn(self, events, state, commute):
        """Chain-binomial log-likelihood for FIXED events, as a closure
        ``params -> [...]`` that touches only the parameter-dependent
        terms: the lgammas and the whole E->I term are constants, and the
        I->R term collapses to two ``[T]`` sums.  Equal in value and
        gradient to the full :meth:`log_prob` likelihood."""
        d = self.data
        dtype = events.dtype
        tiny = torch.finfo(dtype).tiny
        nu = torch.tensor(seir.NU, dtype=dtype, device=events.device)

        n = state[..., seir.SOURCE_STATES]
        y = events
        valid = (y >= 0.0) & (y <= n) & (n >= 0.0)
        lc = torch.where(
            valid,
            log_choose(torch.where(valid, n, torch.ones_like(n)),
                       torch.where(valid, y, torch.zeros_like(y))),
            torch.full_like(n, -torch.inf),
        )
        log_p_nu = torch.log(-torch.expm1(-nu))
        const = (
            torch.sum(lc, dim=(-3, -2, -1))
            + torch.sum(y[..., 1], dim=(-2, -1)) * log_p_nu
            - torch.sum(n[..., 1] - y[..., 1], dim=(-2, -1)) * nu
        )
        sy2 = torch.sum(y[..., 2], dim=-2)  # [..., T]
        sn2 = torch.sum(n[..., 2] - y[..., 2], dim=-2)  # [..., T]

        S_, y0 = n[..., 0], y[..., 0]
        infectious = state[..., 2]
        t_abs = self._t_abs()
        w_t = self._gather_t(d.W, t_abs)
        weekday_t = self._gather_t(d.weekday, t_abs)

        def loglik(params: Parameters):
            alpha = _alpha_timeseries(params.alpha_0, params.alpha_t, t_abs)
            e_t = torch.exp(alpha)  # [..., T]
            e_m = torch.exp(
                _tail(params.beta_area, 1) * d.log_area
                + _tail(params.sigma_space, 1) * params.spatial_effect
            ) / d.N  # [..., M]
            pressure = infectious + _tail(params.psi, 2) * w_t * commute
            r_se = torch.clamp(
                e_m[..., :, None] * e_t[..., None, :] * pressure + RATE_EPS,
                min=tiny,
            )
            se = torch.sum(
                y0 * torch.log(-torch.expm1(-r_se)) - (S_ - y0) * r_se,
                dim=(-2, -1),
            )
            r_ir = torch.clamp(
                torch.exp(
                    _tail(params.gamma0, 1)
                    + _tail(params.gamma1, 1) * weekday_t
                ),
                min=tiny,
            )
            ir = torch.sum(
                sy2 * torch.log(-torch.expm1(-r_ir)) - sn2 * r_ir, dim=-1
            )
            return const + se + ir

        return loglik

    def transition_rate_fn(self, params: Parameters):
        """Single-step rates ``(t, state[..., M, S]) -> [..., M, X]`` for
        forward simulation."""
        d = self.data

        def fn(t, state):
            t_abs = torch.tensor(t, device=state.device)
            w_t = self._gather_t(d.W, t_abs)
            weekday_t = self._gather_t(d.weekday, t_abs)
            alpha = _alpha_timeseries(
                params.alpha_0, params.alpha_t, t_abs.reshape(1)
            )  # [..., 1]
            eta = (
                alpha
                + _tail(params.beta_area, 1) * d.log_area
                + _tail(params.sigma_space, 1) * params.spatial_effect
            )  # [..., M]
            infectious = state[..., 2]
            commute = torch.matmul(
                d.Cstar, (infectious / d.N)[..., None]
            )[..., 0]
            rate_se = (
                torch.exp(eta)
                * (infectious + _tail(params.psi, 1) * w_t * commute)
                / d.N
                + RATE_EPS
            )
            rate_ei = torch.full_like(rate_se, seir.NU)
            rate_ir = torch.exp(
                params.gamma0 + params.gamma1 * weekday_t
            )[..., None].expand_as(rate_se)
            return torch.stack([rate_se, rate_ei, rate_ir], dim=-1)

        return fn

    # ---------- priors ----------

    def log_prior(self, params: Parameters):
        """Sum of prior log-densities (``[...]`` over chains)."""
        dtype = params.spatial_effect.dtype

        def normal_lp(x, scale):
            return -0.5 * (_LOG_2PI + 2.0 * math.log(scale)) - 0.5 * (
                x / scale
            ) ** 2

        lp = normal_lp(params.alpha_0, 10.0)
        lp = lp + normal_lp(params.beta_area, 1.0)
        conc, rate = 3.0, 10.0
        psi_safe = torch.clamp(params.psi, min=torch.finfo(dtype).tiny)
        lp = lp + (
            conc * math.log(rate)
            - math.lgamma(conc)
            + (conc - 1.0) * torch.log(psi_safe)
            - rate * params.psi
        )
        lp = lp + torch.sum(normal_lp(params.alpha_t, 0.005), dim=-1)
        lp = lp + (
            0.5 * math.log(2.0 / math.pi)
            - math.log(0.1)
            - 0.5 * (params.sigma_space / 0.1) ** 2
        )
        x = params.spatial_effect
        M = self.data.num_locations
        if self.data.car_band is not None:
            quad = self.data.car_band.quad(x)
        else:
            quad = torch.sum(x * (x @ self.data.car_precision), dim=-1)
        lp = lp + (
            0.5 * self.data.car_logdet - 0.5 * M * _LOG_2PI - 0.5 * quad
        )
        lp = lp + normal_lp(params.gamma0, 100.0)
        lp = lp + normal_lp(params.gamma1, 100.0)
        return lp

    # ---------- joint density ----------

    def log_prob(self, params: Parameters, events):
        """Joint log-density log p(params, events)."""
        state = seir.compute_state(self.initial_state, events)
        rates = self.transition_rates(params, state)
        ll = seir.chain_binomial_log_prob(events, rates, self.initial_state)
        return self.log_prior(params) + ll

    def joint_log_prob_unconstrained(self, u, events):
        """log p in the HMC sampling space (adds the softplus Jacobian)."""
        params = unpack_parameters(
            constrain_parameters(u), self.num_steps,
            self.data.num_locations,
        )
        return self.log_prob(params, events) + constrain_log_det_jacobian(u)

    # ---------- simulation ----------

    def sample_seir(self, generator, params: Parameters):
        """Forward-simulates ``[..., M, T, X]`` events given (possibly
        chain-batched) parameters."""
        batch = params.psi.shape
        init = self.initial_state.expand(batch + self.initial_state.shape)
        return seir.chain_binomial_sample(
            generator, self.transition_rate_fn(params), init,
            self.initial_step, self.num_steps,
        )
