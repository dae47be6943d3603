"""Burst-granular checkpoint/resume.

Port of ``covid19uk_tpu/utils/checkpoint.py``: the full sampler state —
chain state, random-number state, step size, mass matrix, draw offset — is
written after every burst, so a preempted run resumes losing at most one
burst.  The chain state is stored as named arrays (``state_<field>``), and
the random-number state is the ``torch.Generator``'s ``get_state()``
bytes.
"""

import os

import numpy as np


def save(path, *, state, key, step_size, inv_mass_diag, offset, extra=None):
    """Atomically writes a checkpoint npz.

    Args:
      state: a NamedTuple of arrays (the chains' ``ChainState``).
      key: the generator's state, a ``uint8`` array.
      step_size, inv_mass_diag: arrays; offset: the next draw's row.
      extra: dict of further arrays, stored as ``extra_<name>``.
    """
    # np.savez appends ".npz" unless the name already ends with it
    tmp = path + ".tmp.npz"
    payload = {
        "key": np.asarray(key, np.uint8),
        "step_size": np.asarray(step_size),
        "inv_mass_diag": np.asarray(inv_mass_diag),
        "offset": np.asarray(offset),
    }
    for name, value in zip(state._fields, state):
        payload["state_" + name] = np.asarray(value)
    for k, v in (extra or {}).items():
        payload["extra_" + k] = np.asarray(v)
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load(path, state_template):
    """Loads a checkpoint; returns (state, key, step_size, inv_mass, offset,
    extra), ``state`` of ``state_template``'s type holding numpy arrays."""
    with np.load(path) as z:
        state = type(state_template)(
            *[z["state_" + name] for name in state_template._fields])
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
        return (
            state,
            z["key"],
            z["step_size"],
            z["inv_mass_diag"],
            int(z["offset"]),
            extra,
        )


def exists(path):
    return os.path.exists(path)
