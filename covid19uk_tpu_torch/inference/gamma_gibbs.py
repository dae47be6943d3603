"""Laplace independence-MH refresh of (gamma0, gamma1) given the events.

Port of ``covid19uk_tpu/inference/gamma_gibbs.py``, batched over chains.
The I->R likelihood depends on (gamma0, gamma1) only through the daily
removals K_t = sum_m events[m, t, I->R] and infectious counts
N_t = sum_m state[m, t, I], so the exact conditional

    f(g) = sum_t [ K_t log(1 - exp(-r_t)) - (N_t - K_t) r_t ]
           - |g|^2 / (2 * 100^2),      r_t = exp(g0 + g1 * wd_t)

is sampled by a Laplace independence MH step: a fixed number of Newton
iterations to the mode, a Student-t(5) proposal with covariance (-H)^-1
and the exact MH ratio.  The proposal depends only on (K, N, wd), which
the move leaves fixed, so it is exactly stationary for the conditional.
Every chain runs its own Newton iterations, Cholesky and accept decision
through ``torch.where``; nothing is read back to the host.
"""

from typing import NamedTuple

import torch

PRIOR_SD = 100.0  # gamma0, gamma1 ~ N(0, 100)
_NEWTON_ITERS = 8
_EXP_CLIP = 25.0  # exponent guard: rates beyond e^25 are out of range
_T_DF = 5.0  # proposal Student-t degrees of freedom


class GammaGibbsInfo(NamedTuple):
    is_accepted: torch.Tensor  # [C]
    log_accept_ratio: torch.Tensor  # [C]


class GammaNoise(NamedTuple):
    """The refresh's draws, for injecting another RNG's numbers."""

    normal: torch.Tensor  # [C, 2] standard normals
    chi2: torch.Tensor  # [C] chi-square(5) draws
    uniform: torch.Tensor  # [C] accept uniforms


def _f_grad_hess(g, K, N, wd):
    """Conditional log-density (up to a constant), gradient and Hessian.

    ``g [..., 2]``; ``K``, ``N`` ``[..., T]``; ``wd [T]``.  Returns
    ``(f [...], grad [..., 2], hess [..., 2, 2])``."""
    x = torch.clamp(g[..., :1] + g[..., 1:] * wd, -_EXP_CLIP, _EXP_CLIP)
    r = torch.exp(x)
    em1 = -torch.expm1(-r)  # 1 - exp(-r), stable for small r
    tiny = torch.finfo(r.dtype).tiny
    f = torch.sum(K * torch.log(torch.clamp(em1, min=tiny)) - (N - K) * r,
                  dim=-1)
    f = f - 0.5 * torch.sum(g * g, dim=-1) / PRIOR_SD**2

    # phi'(r) = K/(e^r - 1) - (N - K); phi''(r) = -K e^r/(e^r - 1)^2
    expm1r = torch.clamp(torch.expm1(r), min=tiny)
    phi1 = K / expm1r - (N - K)
    phi2 = -K * torch.exp(torch.clamp(r, max=_EXP_CLIP)) / expm1r**2
    dfdx = phi1 * r
    d2fdx2 = phi2 * r * r + phi1 * r

    grad = torch.stack([torch.sum(dfdx, dim=-1),
                        torch.sum(dfdx * wd, dim=-1)], -1) - g / PRIOR_SD**2
    h00 = torch.sum(d2fdx2, dim=-1) - 1.0 / PRIOR_SD**2
    h01 = torch.sum(d2fdx2 * wd, dim=-1)
    h11 = torch.sum(d2fdx2 * wd * wd, dim=-1) - 1.0 / PRIOR_SD**2
    hess = torch.stack([torch.stack([h00, h01], -1),
                        torch.stack([h01, h11], -1)], -2)
    return f, grad, hess


def _newton_mode(g, K, N, wd):
    """``_NEWTON_ITERS`` Newton ascent steps to the conditional mode, each
    chain on its own: a 2x2 closed-form solve, a trust region of 2, and a
    step dropped where it would leave a non-finite point."""
    for _ in range(_NEWTON_ITERS):
        _, grad, hess = _f_grad_hess(g, K, N, wd)
        h00, h01 = hess[..., 0, 0], hess[..., 0, 1]
        h10, h11 = hess[..., 1, 0], hess[..., 1, 1]
        det = h00 * h11 - h01 * h10
        det = torch.where(torch.abs(det) < 1e-12,
                          torch.full_like(det, 1e-12), det)
        s0 = (h11 * grad[..., 0] - h01 * grad[..., 1]) / det
        s1 = (h00 * grad[..., 1] - h10 * grad[..., 0]) / det
        step = torch.stack([s0, s1], -1)
        # a wild warmup state must not fling the mode search
        norm = torch.sqrt(torch.sum(step * step, dim=-1, keepdim=True))
        step = step * torch.clamp(2.0 / torch.clamp(norm, min=1e-12),
                                  max=1.0)
        g_new = g - step  # ascent: g - H^-1 grad
        ok = torch.all(torch.isfinite(g_new), dim=-1, keepdim=True)
        g = torch.where(ok, g_new, g)
    return g


def draw_noise(generator, g):
    """The refresh's draws for ``g [C, 2]`` from ``generator``; chi2(5) as
    the sum of five squared standard normals."""
    C = g.shape[0]
    kw = dict(generator=generator, dtype=g.dtype, device=g.device)
    return GammaNoise(
        normal=torch.randn((C, 2), **kw),
        chi2=torch.sum(torch.randn((C, int(_T_DF)), **kw) ** 2, dim=-1),
        uniform=torch.rand((C,), **kw),
    )


def gamma_gibbs_step(generator, g, events_ir_sum, state_i_sum, wd,
                     noise=None):
    """One Laplace independence-MH update of (gamma0, gamma1) | events for
    every chain.

    Args:
      generator: ``torch.Generator`` on ``g``'s device (unused when
        ``noise`` is given).
      g: ``[C, 2]`` current (gamma0, gamma1) (identity bijection: u[:, 3],
        u[:, 4]).
      events_ir_sum: ``[C, T]`` daily removals summed over locations.
      state_i_sum: ``[C, T]`` daily infectious counts summed over
        locations.
      wd: ``[T]`` centred weekday indicator at the model's absolute days.
      noise: optional :class:`GammaNoise` in place of the generator's
        draws.

    Returns:
      ``(g_new [C, 2], GammaGibbsInfo)``.
    """
    dtype = g.dtype
    K = events_ir_sum.to(dtype)
    N = state_i_sum.to(dtype)
    wd = wd.to(dtype)
    if noise is None:
        noise = draw_noise(generator, g)

    mode = _newton_mode(g, K, N, wd)
    _, _, hess = _f_grad_hess(mode, K, N, wd)
    # proposal covariance (-H)^-1; 2x2 Cholesky of -H in closed form
    a, b, c = -hess[..., 0, 0], -hess[..., 0, 1], -hess[..., 1, 1]
    a = torch.clamp(a, min=1e-12)
    l11 = torch.sqrt(a)
    l21 = b / l11
    l22 = torch.sqrt(torch.clamp(c - l21 * l21, min=1e-12))

    def log_q(y):
        # Student-t(df) with scale matrix (L L^T)^-1: m = |L^T (y - mode)|^2;
        # the constants are the same forward and reverse and cancel
        d = y - mode
        z0 = d[..., 0] * l11 + d[..., 1] * l21
        z1 = d[..., 1] * l22
        m = z0 * z0 + z1 * z1
        return -0.5 * (_T_DF + 2.0) * torch.log1p(m / _T_DF)

    # t draw: y = mode + L^-T z / sqrt(chi2 / df)
    zs = noise.normal.to(dtype) * torch.rsqrt(
        torch.clamp(noise.chi2.to(dtype) / _T_DF, min=1e-12))[..., None]
    y1 = zs[..., 1] / l22
    y0 = (zs[..., 0] - l21 * y1) / l11
    prop = mode + torch.stack([y0, y1], -1)

    f_old, _, _ = _f_grad_hess(g, K, N, wd)
    f_new, _, _ = _f_grad_hess(prop, K, N, wd)
    log_ratio = (f_new - f_old) + (log_q(g) - log_q(prop))
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio,
                            torch.full_like(log_ratio, -torch.inf))
    accept = torch.log(torch.clamp(noise.uniform.to(dtype),
                                   min=1e-38)) < log_ratio
    g_new = torch.where(accept[..., None], prop, g)
    return g_new, GammaGibbsInfo(is_accepted=accept,
                                 log_accept_ratio=log_ratio)
