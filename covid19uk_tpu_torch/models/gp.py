"""Gaussian-process regression conditional (torch).

Port of ``covid19uk_tpu/models/gp.py``.  For a prior ``f ~ GP(m, k)``
observed with iid Gaussian noise at index points ``X``, the posterior at
new points ``X*`` is

    mean* = m(X*) + K(X*,X) (K(X,X) + s2 I)^-1 (y - m(X))
    cov*  = K(X*,X*) - K(X*,X) (K(X,X) + s2 I)^-1 K(X,X*)  [+ s2* I]

computed with one Cholesky factorisation and triangular solves, no
explicit inverse, on the device the observations are on.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "GaussianProcess",
    "GaussianProcessPosterior",
    "conditional_gp",
    "rbf_kernel",
    "matern32_kernel",
]

_JITTER = 1e-9


def _sq_dist(xa, xb):
    return torch.sum((xa[:, None, :] - xb[None, :, :]) ** 2, dim=-1)


def rbf_kernel(amplitude=1.0, length_scale=1.0) -> Callable:
    """Exponentiated-quadratic kernel: ``a^2 exp(-||x-y||^2 / (2 l^2))``."""

    def k(xa, xb):
        return amplitude**2 * torch.exp(-0.5 * _sq_dist(xa, xb)
                                        / length_scale**2)

    return k


def matern32_kernel(amplitude=1.0, length_scale=1.0) -> Callable:
    """Matern-3/2 kernel: ``a^2 (1 + sqrt(3) d / l) exp(-sqrt(3) d / l)``."""

    def k(xa, xb):
        d = torch.sqrt(torch.clamp(_sq_dist(xa, xb), min=1e-36))
        z = math.sqrt(3.0) * d / length_scale
        return amplitude**2 * (1.0 + z) * torch.exp(-z)

    return k


class GaussianProcess(NamedTuple):
    """A GP prior restricted to ``index_points`` (the reference's
    ``tfd.GaussianProcess(kernel, index_points,
    observation_noise_variance)`` parameter bundle)."""

    kernel: Callable  # (xa [N, D], xb [S, D]) -> [N, S] covariance block
    index_points: torch.Tensor  # [N, D], or [N] scalar points
    observation_noise_variance: float = 0.0
    mean_fn: Optional[Callable] = None  # (x [N, D]) -> [N]; None = zero


def _solve_lower(chol, b):
    """``chol^-1 b`` for a vector (or batch of vectors) ``b [..., N]``."""
    return torch.linalg.solve_triangular(chol, b[..., None],
                                         upper=False)[..., 0]


class GaussianProcessPosterior(NamedTuple):
    """The conditioned GP marginal at the new index points: an MVN with a
    dense covariance, sampled and evaluated in Cholesky form."""

    mean: torch.Tensor  # [S]
    covariance: torch.Tensor  # [S, S]

    def stddev(self):
        # the Schur complement's diagonal can dip epsilon-negative
        return torch.sqrt(torch.clamp(torch.diagonal(self.covariance),
                                      min=0.0))

    def _chol(self):
        cov = self.covariance
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        return torch.linalg.cholesky(cov + _JITTER * eye)

    def sample(self, generator, sample_shape=()):
        z = torch.randn(tuple(sample_shape) + tuple(self.mean.shape),
                        generator=generator, dtype=self.mean.dtype,
                        device=self.mean.device)
        return self.mean + z @ self._chol().T

    def log_prob(self, y):
        chol = self._chol()
        w = _solve_lower(chol, y - self.mean)
        half_logdet = torch.sum(torch.log(torch.diagonal(chol)))
        s = self.mean.shape[-1]
        return (-0.5 * torch.sum(w**2, dim=-1) - half_logdet
                - 0.5 * s * math.log(2.0 * math.pi))


def conditional_gp(gp: GaussianProcess, observations, new_index_points,
                   predictive_noise_variance=None
                   ) -> GaussianProcessPosterior:
    """Conditions ``gp`` on ``observations`` at its own index points and
    returns the posterior marginal at ``new_index_points`` (the
    reference's ``conditional_gp`` helper).  As in TFP's
    ``GaussianProcessRegressionModel``, ``predictive_noise_variance=None``
    takes the prior's ``observation_noise_variance`` (a marginal over
    noisy observations at the new points; pass ``0.0`` for the latent
    function).  Index points take the observations' dtype and device.
    """
    y = torch.as_tensor(observations)
    dtype, device = y.dtype, y.device

    def as_points(pts):
        # a plain (N,) vector means N scalar points, [N, 1]
        pts = torch.as_tensor(pts, dtype=dtype, device=device)
        return pts[:, None] if pts.dim() == 1 else pts

    x = as_points(gp.index_points)
    xs = as_points(new_index_points)
    noise = torch.as_tensor(gp.observation_noise_variance, dtype=dtype,
                            device=device)
    pred_noise = noise if predictive_noise_variance is None else (
        torch.as_tensor(predictive_noise_variance, dtype=dtype,
                        device=device))
    mean_fn = gp.mean_fn or (lambda pts: torch.zeros(
        pts.shape[:-1], dtype=dtype, device=device))

    def eye(n):
        return torch.eye(n, dtype=dtype, device=device)

    kxx = gp.kernel(x, x) + (noise + _JITTER) * eye(x.shape[0])
    ksx = gp.kernel(xs, x)  # [S, N]
    kss = gp.kernel(xs, xs)

    chol = torch.linalg.cholesky(kxx)
    # alpha = Kxx^-1 (y - m(X)); v = L^-1 Kxs
    alpha = torch.linalg.solve_triangular(
        chol.T, _solve_lower(chol, y - mean_fn(x))[:, None],
        upper=True)[:, 0]
    v = torch.linalg.solve_triangular(chol, ksx.T, upper=False)  # [N, S]
    mean = mean_fn(xs) + ksx @ alpha
    cov = kss - v.T @ v + pred_noise * eye(xs.shape[0])
    return GaussianProcessPosterior(mean=mean, covariance=cov)
