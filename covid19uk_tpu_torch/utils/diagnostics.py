"""Offline MCMC diagnostics over posterior files.

Port of ``covid19uk_tpu/utils/diagnostics.py`` (the reference's analysis
helpers, ``util.py:77-117,185-247``): squared jumping distance, null-move
probability, per-kernel jump summaries, mean sojourn time, and the
occult-validity repair loop.  Host-side numpy, plus the port's
``seir.compute_state`` on float64 CPU tensors; h5py is imported inside
:func:`jump_summary`.  Not a hot path.
"""

import numpy as np
import torch

from covid19uk_tpu_torch.models import seir


def squared_jumping_distance(chain):
    """SJD per draw pair (reference util.py:77-81)."""
    chain = np.asarray(chain)
    diff = chain[1:] - chain[:-1]
    cumdiff = np.cumsum(diff, axis=-1)
    return np.sum(cumdiff, axis=-1) ** 2


def p_null(is_accepted, x_star):
    """Probability an accepted move was null (moved zero events)
    (reference util.py:84-87 adapted to this store's layout)."""
    accepted = np.asarray(is_accepted).astype(bool)
    if not accepted.any():
        return np.nan
    moved = np.asarray(x_star)[accepted]
    total = moved.reshape(moved.shape[0], -1).sum(axis=-1)
    return float(np.mean(total == 0))


def jump_summary(posterior_file):
    """Per-kernel SJD + acceptance + null-move summary of a posterior HDF5
    (reference util.py:90-117)."""
    import h5py

    out = {}
    with h5py.File(posterior_file, "r") as f:
        events = f["samples/seir"][:]
        for name, key in [("S->E", "move/S->E"), ("E->I", "move/E->I")]:
            ev_idx = 0 if name == "S->E" else 1
            acc = f[f"results/{key}/is_accepted"][:]
            delta = f[f"results/{key}/proposed_delta"][:]
            # proposed_delta rows: [m, t, delta_t, x_star]
            x_star = delta[..., 3, :] if delta.ndim >= 3 else delta[..., 3]
            out[name] = {
                "sjd": float(
                    np.mean(squared_jumping_distance(events[..., ev_idx]))
                ),
                "accept": float(np.mean(acc)),
                "p_null": p_null(acc, x_star),
            }
    return out


def mean_sojourn(in_events, out_events, init_state):
    """Mean sojourn time in a compartment (reference util.py:185-196)."""
    in_events = np.asarray(in_events)
    out_events = np.asarray(out_events)
    state = (
        np.concatenate(
            [
                np.zeros_like(in_events[..., :1]),
                np.cumsum(in_events - out_events, axis=-1)[..., :-1],
            ],
            axis=-1,
        )
        + np.asarray(init_state)[..., None]
    )
    total_state = state.sum(axis=(-2, -1))
    total_events = out_events.sum(axis=(-2, -1))
    return 1.0 + total_state / total_events


def regularize_occults(events, occults, init_state, stoichiometry=None):
    """Clips occults wherever the implied state goes negative
    (reference util.py:199-247).  Iterates until the counting process is
    valid; returns (state, occults) as float64 numpy."""
    if stoichiometry is None:
        stoichiometry = seir.STOICHIOMETRY
    stoich = np.asarray(stoichiometry, np.float64)
    events = np.asarray(events, np.float64)
    occults = np.asarray(occults, np.float64).copy()
    init_state = torch.as_tensor(np.asarray(init_state, np.float64))

    def state_of(occ):
        return seir.compute_state(
            init_state, torch.as_tensor(events + occ)).numpy()

    state = state_of(occults)
    for _ in range(10000):
        if state.min() >= 0:
            break
        state_t1 = np.roll(state, shift=-1, axis=-2)
        neg = state_t1 < 0  # [M, T, S]
        # first negative time per location, repaired one step at a time
        # like the reference's while_loop
        mask = np.zeros_like(state_t1)
        m_idx, t_idx, s_idx = np.nonzero(neg)
        if len(m_idx) == 0:
            break
        first = {}
        for m, t, s in zip(m_idx, t_idx, s_idx):
            if m not in first or t < first[m][0]:
                first[m] = (t, s)
        for m, (t, s) in first.items():
            mask[m, t, s] = 1.0
        delta_occ = np.einsum("mts,xs->mtx", state_t1 * mask, stoich)
        occults = np.clip(occults - delta_occ, 0.0, 1.0e6)
        state = state_of(occults)
    return state, occults
