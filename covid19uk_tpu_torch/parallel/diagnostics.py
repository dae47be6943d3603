"""Cross-chain convergence diagnostics: split-R-hat and effective sample size.

Port of ``covid19uk_tpu/parallel/diagnostics.py``: the two statistics in
torch over ``[chains, draws, ...]`` tensors (ESS through ``torch.fft``),
and ``gate_statistics``, the numpy version the between-burst convergence
gate uses on the host.
"""

import numpy as np
import torch


def potential_scale_reduction(draws):
    """Split-chain R-hat (Gelman-Rubin, split form).

    Args:
      draws: ``[chains, draws, ...]``.

    Returns:
      R-hat per trailing parameter element.
    """
    N = draws.shape[1]
    half = N // 2
    split = torch.cat(
        [draws[:, :half], draws[:, half:2 * half]], dim=0
    )  # [2C, half, ...]
    n = split.shape[1]
    chain_means = torch.mean(split, dim=1)  # [2C, ...]
    B = n * torch.var(chain_means, dim=0, correction=1)
    W = torch.mean(torch.var(split, dim=1, correction=1), dim=0)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / W)


def _autocovariance(x):
    """Autocovariance along axis 1 via FFT; x: [chains, draws, ...]."""
    n = x.shape[1]
    x = x - torch.mean(x, dim=1, keepdim=True)
    size = 2 * n  # zero-pad to avoid circular wrap
    f = torch.fft.rfft(x, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :n]
    return acov / n


def effective_sample_size(draws):
    """Bulk ESS with Geyer initial-positive-sequence truncation (a
    monotone mask rather than a data-dependent loop).

    Args:
      draws: ``[chains, draws, ...]``.

    Returns:
      ESS per trailing parameter element.
    """
    C, N = draws.shape[0], draws.shape[1]
    acov = _autocovariance(draws)  # [C, N, ...]
    mean_acov = torch.mean(acov, dim=0)  # [N, ...]
    chain_var = acov[:, 0] * N / (N - 1.0)
    W = torch.mean(chain_var, dim=0)
    mean_est = torch.mean(draws, dim=1)  # [C, ...]
    B_over_n = torch.var(mean_est, dim=0, correction=1) if C > 1 else 0.0
    var_plus = W * (N - 1.0) / N + B_over_n

    # rho_t = 1 - (W - mean_acov_t) / var_plus
    rho = 1.0 - (W - mean_acov) / var_plus  # [N, ...]
    # Geyer: sum paired rho_{2k}+rho_{2k+1} while positive.
    n_pairs = (N - 1) // 2
    pair = rho[1:1 + 2 * n_pairs]
    pair = pair.reshape((n_pairs, 2) + tuple(rho.shape[1:])).sum(dim=1)
    # keep only the initial run of positive pairs
    keep = torch.cumprod((pair > 0.0).to(rho.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(pair * keep, dim=0)
    tau = torch.clamp(tau, min=1.0 / float(np.log10(N)))
    return C * N / tau


def gate_statistics(draws):
    """Host-side (numpy) split R-hat + bulk ESS for the between-burst
    convergence gate; the same arithmetic as the torch functions above,
    on arrays small enough that the host is the right place.

    Args:
      draws: ``[chains, draws, params]`` numpy array.

    Returns:
      ``(max_rhat, min_ess)`` floats over the parameter axis.
    """
    draws = np.asarray(draws, np.float64)
    C, N = draws.shape[0], draws.shape[1]

    # ---- split R-hat ----
    half = N // 2
    split = np.concatenate(
        [draws[:, :half], draws[:, half : 2 * half]], axis=0
    )
    n = split.shape[1]
    chain_means = split.mean(axis=1)
    B = n * chain_means.var(axis=0, ddof=1)
    W = split.var(axis=1, ddof=1).mean(axis=0)
    rhat = np.sqrt(((n - 1) / n * W + B / n) / W)

    # ---- bulk ESS (Geyer initial positive sequence) ----
    x = draws - draws.mean(axis=1, keepdims=True)
    size = 2 * N
    f = np.fft.rfft(x, n=size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=1)[:, :N].real / N
    mean_acov = acov.mean(axis=0)
    Wv = (acov[:, 0] * N / (N - 1.0)).mean(axis=0)
    B_over_n = draws.mean(axis=1).var(axis=0, ddof=1) if C > 1 else 0.0
    var_plus = Wv * (N - 1.0) / N + B_over_n
    rho = 1.0 - (Wv - mean_acov) / var_plus
    n_pairs = (N - 1) // 2
    pair = rho[1 : 1 + 2 * n_pairs]
    pair = pair.reshape((n_pairs, 2) + rho.shape[1:]).sum(axis=1)
    keep = np.cumprod(pair > 0.0, axis=0)
    tau = np.maximum(
        1.0 + 2.0 * (pair * keep).sum(axis=0), 1.0 / np.log10(N)
    )
    ess = C * N / tau
    return float(np.max(rhat)), float(np.min(ess))
