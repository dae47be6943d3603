"""Censored-event imputation: geometric back-distribution of case counts.

Host-side numpy port of the reference initialization chain
(``/root/reference/covid19uk/model_spec.py:108-126`` and
``/root/reference/covid19uk/util.py:120-182``): observed I->R case counts are
back-distributed over geometric waiting times to impute initial E->I and
S->E event time series.  This runs once at inference startup; it is not a
hot path, so plain numpy (with a seeded Generator) is the right tool.
Copied unchanged from ``covid19uk_tpu/utils/impute.py``: the same seed gives
the same events, bit for bit.
"""

import numpy as np


def distribute_geom(events, rate, rng, delta_t=1.0):
    """Distributes events backward over geometric waiting times.

    Repeatedly binomially thins the remaining counts with
    ``p = 1 - exp(-rate * delta_t)`` until all are allocated
    (reference ``util.py:120-145``).

    Args:
      events: ``[M, T]`` counts.
      rate: scalar rate.
      rng: ``np.random.Generator``.

    Returns:
      ``[M, n_lags, T]`` tensor of events distributed over lags.
    """
    events = np.asarray(events, np.float64)
    prob = 1.0 - np.exp(-rate * delta_t)
    remaining = events.copy()
    # Lag slice 0 is all-zero: the reference's while_loop starts writing at
    # index 1 (util.py:142), so every imputed event lands strictly *before*
    # its source event — this is what guarantees the imputed tensor is a
    # valid counting process (E->I never precedes its S->E, etc.).
    slices = [np.zeros_like(events)]
    while remaining.sum() > 0:
        failures = rng.binomial(remaining.astype(np.int64), prob).astype(
            np.float64
        )
        slices.append(failures)
        remaining = remaining - failures
    return np.stack(slices, axis=1)  # [M, n_lags, T]


def reduce_diagonals(m):
    """Anti-diagonal reduction realigning lag slices to calendar time.

    ``out[m, j - i + R - 1] += in[m, i, j]`` for an ``[M, R, T]`` input,
    producing ``[M, R + T - 1]`` (reference ``util.py:148-159``).
    """
    m = np.asarray(m)
    M, R, T = m.shape
    out = np.zeros((M, R + T - 1), m.dtype)
    idx = np.arange(T)[None, :] - np.arange(R)[:, None] + R - 1  # [R, T]
    np.add.at(out, (np.arange(M)[:, None, None], idx[None, :, :]), m)
    return out


def impute_previous_cases(events, rate, rng, delta_t=1.0):
    """Imputes earlier-stage events via geometric waiting times.

    Returns ``(prev_cases [M, T'], lag)`` where ``lag`` is the number of
    time steps the series extends into the past
    (reference ``util.py:162-182``).
    """
    prev_case_distn = distribute_geom(events, rate, rng, delta_t)
    prev_cases = reduce_diagonals(prev_case_distn)

    # Trim leading all-zero days
    total_events = prev_cases.sum(axis=-2)
    num_zero_days = int(
        total_events.shape[-1] - np.count_nonzero(np.cumsum(total_events))
    )
    return (
        prev_cases[..., num_zero_days:],
        prev_case_distn.shape[-2] - num_zero_days,
    )


def generate_case_numbers(n, rate, rng):
    """Forward binomial-thinning case generator.

    Repeatedly draws ``new_n ~ Binomial(n, 1 - exp(-rate))`` and subtracts
    it from the remaining pool until exhausted, returning the per-round
    draws stacked along a leading axis (reference ``util.py:56-74``'s
    ``tf.while_loop`` + ``TensorArray``; here the dynamic-length output is
    a plain host-side list — this is a data-synthesis helper, not a
    device-side op).

    Args:
      n: ``[...]`` initial counts.
      rate: scalar rate; the per-round thinning prob is ``1 - exp(-rate)``.
      rng: ``np.random.Generator``.

    Returns:
      ``[num_rounds, ...]`` float array; sums to ``rint(n)`` over axis 0.
    """
    # Counts must be finite non-negative integers or the depletion loop
    # cannot terminate (Binomial(floor(0.5), p) draws 0 forever); round to
    # the nearest integer up front and validate.
    remaining = np.rint(np.asarray(n, np.float64))
    if not np.isfinite(remaining).all() or (remaining < 0).any():
        raise ValueError("generate_case_numbers: n must be finite and >= 0")
    prob = 1.0 - np.exp(-float(rate))
    rounds = []
    while remaining.sum() > 0:
        new_n = rng.binomial(remaining.astype(np.int64), prob).astype(
            np.float64
        )
        rounds.append(new_n)
        remaining = remaining - new_n
    if not rounds:
        return np.zeros((0,) + remaining.shape, np.float64)
    return np.stack(rounds, axis=0)


def impute_censored_events(cases, seed=0, rates=(0.25, 0.5)):
    """Builds the initial ``[M, T', 3]`` event tensor from observed cases.

    Mirrors ``model_spec.impute_censored_events`` (model_spec.py:108-126):
    the default rates 0.25 (E->I lag behind I->R) and 0.5 (S->E lag behind
    E->I) are application-tuned magic numbers preserved from the reference.

    NOTE the defaults are INCONSISTENT with the model's own sojourn rates
    (I->R rate exp(gamma0), E->I rate NU=0.28), and the mismatch inflates
    the derived initial I_0 — the calibration study (docs/calibration.md)
    measures a resulting −13 posterior-sd gamma0 recovery offset that is
    entirely attributable to this fixed, conditioned-on initial state (the
    reference shares the structure, inference.py:490-513).  Pass
    ``rates=(removal_rate_estimate, 0.28)`` to reduce it.
    """
    rng = np.random.default_rng(seed)
    cases = np.asarray(cases, np.float64)
    ei_events, lag_ei = impute_previous_cases(cases, rates[0], rng)
    se_events, lag_se = impute_previous_cases(ei_events, rates[1], rng)
    ir_events = np.pad(cases, ((0, 0), (lag_ei + lag_se - 2, 0)))
    ei_events = np.pad(ei_events, ((0, 0), (lag_se - 1, 0)))
    return np.stack([se_events, ei_events, ir_events], axis=-1)
