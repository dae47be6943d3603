"""Dual-averaging step-size adaptation (Nesterov / Hoffman-Gelman).

Port of ``covid19uk_tpu/inference/dual_averaging.py`` over a batch of
chains: every field is a ``[C]`` tensor, one entry per chain, updated on
the device without a host sync.  Defaults follow TFP/Stan: shrinkage
target mu = log(10 * init_step), gamma = 0.05, t0 = 10, kappa = 0.75.  The
per-step step size is ``exp(x_t)`` (the non-averaged iterate); the
averaged iterate ``exp(x_bar)`` is carried for diagnostics.
"""

from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor  # x_t
    log_step_avg: torch.Tensor  # x_bar
    error_sum: torch.Tensor  # running sum of (target - accept_prob)
    mu: torch.Tensor  # shrinkage target
    step_count: torch.Tensor  # t


def init(initial_step_size) -> DualAveragingState:
    """State at ``initial_step_size`` (a ``[C]`` tensor: its dtype and
    device are the state's)."""
    log_step = torch.log(initial_step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step,
        error_sum=torch.zeros_like(log_step),
        mu=torch.log(10.0 * initial_step_size),
        step_count=torch.zeros_like(log_step),
    )


def update(
    state: DualAveragingState,
    accept_prob,
    target_accept_prob=0.75,
    gamma=0.05,
    t0=10.0,
    kappa=0.75,
) -> DualAveragingState:
    t = state.step_count + 1.0
    error_sum = state.error_sum + (target_accept_prob - accept_prob)
    # classic form: mu - sqrt(t)/gamma * (1/(t+t0)) * error_sum
    log_step = state.mu - torch.sqrt(t) / (gamma * (t + t0)) * error_sum
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step_avg,
        error_sum=error_sum,
        mu=state.mu,
        step_count=t,
    )


def step_size(state: DualAveragingState):
    return torch.exp(state.log_step)


def averaged_step_size(state: DualAveragingState):
    return torch.exp(state.log_step_avg)
