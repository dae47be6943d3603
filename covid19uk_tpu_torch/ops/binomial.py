"""Numerically stable binomial log-pmf primitives (torch).

Port of ``covid19uk_tpu/ops/binomial.py``: ``lgamma(n+1) - lgamma(n-k+1)``
through an analytically recombined Stirling expansion, so that the
likelihood stays float32-safe where ``n`` is ~1e6 and ``k`` ~1e0-1e3.
"""

import torch

# Threshold on n-k+1 above which the Stirling form is used.
_STIRLING_THRESHOLD = 10.0


def lgamma_diff(n, k):
    """``lgamma(n+1) - lgamma(n-k+1)``, cancellation-free (0 <= k <= n)."""
    a = n + 1.0
    b = n - k + 1.0
    # Clamp so both branches of the `where` are NaN-free (grad-safe).
    b_safe = torch.clamp(b, min=0.5)
    a_safe = torch.clamp(a, min=0.5)
    direct = torch.lgamma(a_safe) - torch.lgamma(b_safe)
    log_ab = torch.log1p(k / b_safe)
    stirling = (
        (a_safe - 0.5) * log_ab
        + k * torch.log(b_safe)
        - k
        + (1.0 / 12.0) * (1.0 / a_safe - 1.0 / b_safe)
        - (1.0 / 360.0) * (1.0 / a_safe**3 - 1.0 / b_safe**3)
    )
    return torch.where(b > _STIRLING_THRESHOLD, stirling, direct)


def log_choose(n, k):
    """Stable ``log C(n, k)``; the caller masks invalid (k < 0, k > n)."""
    k_safe = torch.clamp(k, min=0.0)
    return lgamma_diff(n, k_safe) - torch.lgamma(k_safe + 1.0)


def binomial_log_pmf(n, k, log_p, log1m_p):
    """Binomial log-pmf from log(p) and log(1-p); -inf where
    (k < 0) | (k > n) | (n < 0), with a NaN-free (grad-safe) interior."""
    valid = (k >= 0.0) & (k <= n) & (n >= 0.0)
    n_safe = torch.where(valid, n, torch.ones_like(n))
    k_safe = torch.where(valid, k, torch.zeros_like(k))
    logpmf = (
        log_choose(n_safe, k_safe)
        + k_safe * log_p
        + (n_safe - k_safe) * log1m_p
    )
    return torch.where(valid, logpmf, torch.full_like(logpmf, -torch.inf))


def binomial_log_pmf_from_rate(n, k, rate_dt):
    """Binomial log-pmf with ``p = 1 - exp(-rate_dt)``, using
    ``log(1-p) = -rate_dt`` and ``log(p) = log(-expm1(-rate_dt))``."""
    rate_dt = torch.as_tensor(rate_dt, dtype=n.dtype, device=n.device)
    rate_safe = torch.clamp(rate_dt, min=torch.finfo(n.dtype).tiny)
    log_p = torch.log(-torch.expm1(-rate_safe))
    return binomial_log_pmf(n, k, log_p, -rate_safe)
