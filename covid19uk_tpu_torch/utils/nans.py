"""NaN checking: the port's counterpart of JAX's ``jax_debug_nans``.

:class:`NanCheck` is a ``TorchDispatchMode`` that looks at the
floating-point outputs of every aten op run inside it, backward ops
included, and raises ``FloatingPointError`` naming the op at the first
NaN.  As in JAX, an infinity alone is not an error.  The allocation ops
(``empty*``, ``new_empty*``) are skipped: their outputs are uninitialised
memory.  The mode waits for the device once per op.

The hand kernels are launched through ctypes, out of the mode's sight, so
their wrappers call :func:`check` on their outputs, which raises while a
:class:`NanCheck` is active and does nothing otherwise.

:func:`checked_step` is what the MCMC driver's ``debug_nans`` runs.
JAX's check looks at the outputs of a jitted computation (a whole
transition), not inside it, and on a NaN runs the computation again op
by op to name the op. The same holds here: an HMC trajectory that
diverges computes NaNs (an overflowed ``exp`` times zero in the
gradient) that the accept test then rejects, so a check of every op of
every transition would stop healthy runs in their first warmup window.
"""

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves

_UNINITIALISED = ("empty", "new_empty")


def _has_nan(t):
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and bool(torch.isnan(t).any()))


class NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first aten op inside it whose
    floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.overloadpacket.__name__.startswith(_UNINITIALISED):
            if any(_has_nan(t) for t in tree_leaves(out)):
                raise FloatingPointError(
                    f"NaN in the output of {func} (debug_nans)")
        return out


def active():
    """True inside a :class:`NanCheck`."""
    return any(isinstance(m, NanCheck)
               for m in _get_current_dispatch_mode_stack())


def check(name, tensors):
    """For a hand kernel's wrapper: raises ``FloatingPointError`` naming
    ``name`` if NaN-checking is active and one of ``tensors`` holds a
    NaN."""
    if active() and any(_has_nan(t) for t in tensors):
        raise FloatingPointError(
            f"NaN in the output of the {name} kernel (debug_nans)")


def checked_step(step, agree=None):
    """``step(state, tune, generator=None, noise=None)`` (the transition of
    ``gibbs.make_mcmc_step``) with NaN checking: each transition's
    floating-point outputs are checked (one wait for the device), and a
    transition that returns a NaN runs again from the same generator
    state inside :class:`NanCheck`, which raises at the first op that
    made one.  The draws are those of ``step``.

    ``agree(flag) -> flag`` makes the ranks that run a transition together
    (a space group, whose ranks hold different bands of the events) take
    one decision: a rank whose band holds no NaN reruns with the one whose
    band does, so that their collectives still pair up."""

    def run(state, tune, generator=None, noise=None):
        before = None if generator is None else generator.get_state()
        out = step(state, tune, generator, noise)
        found = any(_has_nan(t) for t in tree_leaves(out))
        if agree is not None:
            found = agree(found)
        if not found:
            return out
        if generator is not None:
            generator.set_state(before)
        with NanCheck():
            step(state, tune, generator, noise)
        raise FloatingPointError(
            "NaN in a transition's output that no op and no kernel check "
            "shows (debug_nans)")

    return run
