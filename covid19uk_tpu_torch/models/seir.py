"""Discrete-time chain-binomial SEIR process (torch).

Port of ``covid19uk_tpu/models/seir.py``.  The state is an exclusive
cumulative sum of the events along time, so the log-density factorises
over time; only forward simulation is a sequential loop.

Layouts: events ``[..., M, T, X]`` with X = 3 transitions (S->E, E->I,
I->R), states ``[..., M, T, S]`` with S = 4 compartments (S, E, I, R).
"""

import numpy as np
import torch

from covid19uk_tpu_torch.ops.binomial import binomial_log_pmf_from_rate

STOICHIOMETRY = np.array(
    [[-1, 1, 0, 0], [0, -1, 1, 0], [0, 0, -1, 1]], dtype=np.float32
)
TIME_DELTA = 1.0
NU = 0.28  # E->I rate, fixed

# Transition -> source-state index: S->E from S(0), E->I from E(1),
# I->R from I(2).
SOURCE_STATES = [0, 1, 2]


def _stoich(like):
    return torch.as_tensor(STOICHIOMETRY, dtype=like.dtype, device=like.device)


def compute_state(initial_state, events):
    """``state[..., m, t, s] = initial_state[..., m, s]
    + sum_{t' < t} events[..., m, t', x] S[x, s]`` (exclusive cumsum)."""
    deltas = torch.einsum("...mtx,xs->...mts", events, _stoich(events))
    cum = torch.cumsum(deltas, dim=-2)
    cum = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], -2)
    return initial_state.to(events.dtype)[..., :, None, :] + cum


def chain_binomial_log_prob(events, rates, initial_state,
                            time_delta=TIME_DELTA):
    """``sum_{m,t,x} Binomial(src_state, 1 - exp(-rate dt)).log_prob(y)``;
    -inf for an event tensor that is not a valid counting process."""
    n = compute_state(initial_state, events)[..., SOURCE_STATES]
    logpmf = binomial_log_pmf_from_rate(n, events, rates * time_delta)
    return torch.sum(logpmf, dim=(-3, -2, -1))


def chain_binomial_sample(generator, rate_fn, initial_state, initial_step,
                          num_steps, time_delta=TIME_DELTA):
    """Forward-simulates the process: ``rate_fn(t, state[..., M, S]) ->
    rates[..., M, X]`` at absolute day ``t``.  Returns ``[..., M, T, X]``.

    Draws come from ``torch.binomial`` with the given generator, so they
    differ from the JAX package's draws for the same seed."""
    state = initial_state
    stoich = _stoich(state)
    draws_t = []
    for t in range(initial_step, initial_step + num_steps):
        rates = rate_fn(t, state)
        n = state[..., SOURCE_STATES]
        p = -torch.expm1(-rates * time_delta)
        draws = torch.binomial(n.contiguous(), p.contiguous(),
                               generator=generator)
        state = state + draws @ stoich
        draws_t.append(draws)
    return torch.stack(draws_t, dim=-2)
