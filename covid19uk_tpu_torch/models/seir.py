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


def _stoich(like, stoichiometry=None):
    return torch.as_tensor(
        STOICHIOMETRY if stoichiometry is None else stoichiometry,
        dtype=like.dtype, device=like.device)


def compute_state(initial_state, events, stoichiometry=None):
    """``state[..., m, t, s] = initial_state[..., m, s]
    + sum_{t' < t} events[..., m, t', x] S[x, s]`` (exclusive cumsum);
    ``stoichiometry [X, S]`` defaults to the SEIR ``STOICHIOMETRY``."""
    deltas = torch.einsum("...mtx,xs->...mts", events,
                          _stoich(events, stoichiometry))
    cum = torch.cumsum(deltas, dim=-2)
    cum = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], -2)
    return initial_state.to(events.dtype)[..., :, None, :] + cum


def transition_source_counts(initial_state, events, stoichiometry=None):
    """Source-compartment counts ``n[..., m, t, x]`` of each transition:
    the binomial trial counts of S->E, E->I and I->R at each (m, t)."""
    return compute_state(initial_state, events,
                         stoichiometry)[..., SOURCE_STATES]


def chain_binomial_log_prob(events, rates, initial_state,
                            stoichiometry=None, time_delta=TIME_DELTA):
    """``sum_{m,t,x} Binomial(src_state, 1 - exp(-rate dt)).log_prob(y)``;
    -inf for an event tensor that is not a valid counting process."""
    n = transition_source_counts(initial_state, events, stoichiometry)
    logpmf = binomial_log_pmf_from_rate(n, events, rates * time_delta)
    return torch.sum(logpmf, dim=(-3, -2, -1))


def chain_binomial_sample(generator, rate_fn, initial_state, initial_step,
                          num_steps, stoichiometry=None,
                          time_delta=TIME_DELTA):
    """Forward-simulates the process: ``rate_fn(t, state[..., M, S]) ->
    rates[..., M, X]`` at absolute day ``t``.  Returns ``[..., M, T, X]``.

    Draws come from ``torch.binomial`` with the given generator, so they
    differ from the JAX package's draws for the same seed."""
    state = initial_state
    stoich = _stoich(state, stoichiometry)
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


def simulation_problems(initial_state, events):
    """What is wrong with simulated ``events [..., M, T, X]`` from
    ``initial_state [..., M, S]``, as a list of messages (empty when
    nothing is): events that are not non-negative integers, a draw above
    its source compartment, or an implied state, the end state included,
    that goes negative."""
    problems = []
    if not (bool((events >= 0).all())
            and bool((events == torch.round(events)).all())):
        problems.append("events are not non-negative integers")
    state = compute_state(initial_state, events)  # each day's start
    if bool((events > state[..., SOURCE_STATES]).any()):
        problems.append("a draw exceeds its source compartment")
    end = state[..., -1, :] + events[..., -1, :] @ _stoich(events)
    if bool((state < 0).any()) or bool((end < 0).any()):
        problems.append("the implied state goes negative")
    return problems
