"""Welford online variance accumulator, batched over chains.

Port of ``covid19uk_tpu/inference/welford.py``: ``count`` is ``[C]`` and
``mean``/``m2`` are ``[C, P]`` (the JAX package vmaps a scalar-count
accumulator over chains).  Draws are draw-major, ``[num_draws, C, P]``.
"""

from typing import NamedTuple

import torch


class RunningVariance(NamedTuple):
    count: torch.Tensor  # [C] (float for weighting flexibility)
    mean: torch.Tensor  # [C, P]
    m2: torch.Tensor  # [C, P] sum of squared deviations


def init(shape, dtype=torch.float32, device="cuda") -> RunningVariance:
    """An empty accumulator for ``shape = (C, P)``."""
    return RunningVariance(
        count=torch.zeros(shape[:-1], dtype=dtype, device=device),
        mean=torch.zeros(shape, dtype=dtype, device=device),
        m2=torch.zeros(shape, dtype=dtype, device=device),
    )


def from_stats(num_samples, mean, variance) -> RunningVariance:
    """Seeds the accumulator from precomputed moments (``num_samples``
    ``[C]`` or a number; ``mean``, ``variance`` ``[C, P]``): the reference
    seeds each slow window from the previous window's last half."""
    num_samples = torch.as_tensor(num_samples, dtype=mean.dtype,
                                  device=mean.device)
    num_samples = num_samples.expand(mean.shape[:-1])
    return RunningVariance(
        count=num_samples, mean=mean, m2=variance * num_samples[..., None]
    )


def update(state: RunningVariance, x) -> RunningVariance:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return RunningVariance(count, mean, m2)


def variance(state: RunningVariance, ddof=0.0):
    denom = torch.clamp(state.count - ddof, min=1.0)
    return state.m2 / denom[..., None]


def from_draws(draws) -> RunningVariance:
    """Seeds from the last half of a window of draws ``[num_draws, C, P]``
    (the reference's ``get_weighted_running_variance``)."""
    half = draws[draws.shape[0] // 2:]
    mean = torch.mean(half, dim=0)
    var = torch.var(half, dim=0, correction=0)
    return from_stats(half.shape[0], mean, var)
