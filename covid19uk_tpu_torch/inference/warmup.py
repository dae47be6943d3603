"""Stan-style windowed warmup: fast / slow-doubling / fast.

Port of ``covid19uk_tpu/inference/warmup.py``.  A window is a Python loop
over the batched transition ``step(state, tune, generator, noise)`` of
:func:`covid19uk_tpu_torch.inference.gibbs.make_mcmc_step`; the adaptation
state (dual averaging, Welford) stays on the device, one entry per chain,
and nothing in a window waits for the device.  Draws and traces are
stacked draw-major, ``[num_draws, C, ...]``.
"""

from typing import NamedTuple

import torch

from covid19uk_tpu_torch.inference import dual_averaging, welford
from covid19uk_tpu_torch.inference.gibbs import ChainState, HMCTunables


class WarmupSchedule(NamedTuple):
    """Window sizes (reference inference.py:312-321)."""

    first_window: int = 200
    slow_window: int = 25
    num_slow_windows: int = 6
    last_window: int = 50

    @property
    def total(self):
        return (
            self.first_window
            + self.slow_window * (2**self.num_slow_windows - 1)
            + self.last_window
        )


def regularized_variance(wf: welford.RunningVariance):
    """Stan-style shrinkage of the variance estimate toward 1e-3 I."""
    n = wf.count[..., None]
    var = welford.variance(wf)
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


def stack(trees):
    """Stacks a list of equally shaped NamedTuple trees of tensors along a
    new leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*[stack([t[i] for t in trees])
                         for i in range(len(first))])


def _tunables(step_size, inv_mass, decays):
    # decays: None (the config's) or (move_decay_se, move_decay_ei,
    # x_decay_se, x_decay_ei)
    return HMCTunables(step_size[:, None], inv_mass, *(decays or ()))


class _Draws:
    """Collects a window's or a burst's draws on the device: ``u`` of
    every draw, the events of draws ``k-1, 2k-1, ...`` for ``k =
    keep_events_every`` (none for 0), and every trace."""

    def __init__(self, keep_events_every):
        self.every = keep_events_every
        self.us, self.events, self.traces = [], [], []

    def add(self, state, trace):
        self.us.append(state.u)
        if self.every and len(self.us) % self.every == 0:
            self.events.append(state.events)
        self.traces.append(trace)

    def stacked(self):
        """``(ChainState [n, C, ...], StepTrace [n, C, ...])`` with
        ``hmc.step_size`` as ``[n, C]``."""
        traces = stack(self.traces)
        traces = traces._replace(hmc=traces.hmc._replace(
            step_size=traces.hmc.step_size.reshape(len(self.us), -1)))
        events = torch.stack(self.events) if self.events else None
        return ChainState(u=torch.stack(self.us), events=events), traces


def make_window_runner(mcmc_step, num_draws: int, adapt_mass: bool,
                       keep_events_every: int = 1):
    """Builds a window runner.

    Args:
      mcmc_step: ``(state, tune, generator, noise) -> (ChainState,
        StepTrace)``.
      num_draws: window length.
      adapt_mass: if True, update the Welford accumulator with each draw and
        refresh the mass matrix every step (slow window); else mass is
        frozen (fast window).
      keep_events_every: keep the events of every k-th draw; 0 keeps
        only ``u`` (a window that is not stored).

    Returns:
      ``run(state, da_state, wf_state, inv_mass, generator=None,
      decays=None, noise=None) -> (state, da_state, wf_state, inv_mass,
      draws, traces)``; ``noise`` is an optional sequence of one
      :class:`~covid19uk_tpu_torch.inference.gibbs.StepNoise` per draw.
    """

    def run(state, da_state, wf_state, inv_mass, generator=None,
            decays=None, noise=None):
        da, wf = da_state, wf_state
        out = _Draws(keep_events_every)
        for i in range(num_draws):
            tune = _tunables(dual_averaging.step_size(da), inv_mass, decays)
            state, trace = mcmc_step(state, tune, generator,
                                     None if noise is None else noise[i])
            accept = torch.exp(
                torch.clamp(trace.hmc.log_accept_ratio, max=0.0))
            accept = torch.where(torch.isfinite(accept), accept,
                                 torch.zeros_like(accept))
            da = dual_averaging.update(da, accept)
            if adapt_mass:
                wf = welford.update(wf, state.u)
                inv_mass = regularized_variance(wf)
            out.add(state, trace)
        return (state, da, wf, inv_mass, *out.stacked())

    return run


def make_fixed_runner(mcmc_step, num_draws: int, keep_events_every: int = 1):
    """Fixed-tuning sampling burst (reference make_fixed_window_sampler,
    inference.py:199-242).  Returns ``run(state, step_size [C], inv_mass
    [C, P], generator=None, decays=None, noise=None) -> (state, draws,
    traces)``; ``keep_events_every`` as for :func:`make_window_runner`."""

    def run(state, step_size, inv_mass, generator=None, decays=None,
            noise=None):
        tune = _tunables(step_size, inv_mass, decays)
        out = _Draws(keep_events_every)
        for i in range(num_draws):
            state, trace = mcmc_step(state, tune, generator,
                                     None if noise is None else noise[i])
            out.add(state, trace)
        return (state, *out.stacked())

    return run
