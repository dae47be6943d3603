"""Preconditioned Hamiltonian Monte Carlo with a diagonal mass matrix.

Port of ``covid19uk_tpu/inference/hmc.py`` over a ``[C, P]`` batch of
chains: the log-density returns ``[C]``, and the gradient of its sum over
chains is each chain's gradient.  ``inv_mass_diag`` is the inverse mass
(the posterior-variance estimate): momentum ~ N(0, diag(1/inv_mass)).
"""

from typing import Callable, NamedTuple

import torch


class HMCInfo(NamedTuple):
    is_accepted: torch.Tensor  # [C] bool
    log_accept_ratio: torch.Tensor  # [C]
    target_log_prob: torch.Tensor  # [C], of the (possibly old) state
    step_size: torch.Tensor


def value_and_grad(logdensity_fn, q):
    """``([C], [C, P])``: the density and each chain's gradient."""
    with torch.enable_grad():
        q = q.detach().requires_grad_(True)
        lp = logdensity_fn(q)
        (grad,) = torch.autograd.grad(lp.sum(), q)
    return lp.detach(), grad


def hmc_step(
    position,
    logdensity_fn: Callable,
    step_size,
    num_leapfrog_steps: int,
    inv_mass_diag=None,
    generator=None,
    z=None,
    u_accept=None,
):
    """One HMC transition for every chain.

    Args:
      position: ``[C, P]`` positions.
      logdensity_fn: ``u[C, P] -> [C]`` log target density.
      step_size: scalar (or ``[C, 1]``) leapfrog step size.
      num_leapfrog_steps: leapfrog count (the reference uses 16).
      inv_mass_diag: ``[P]`` or ``[C, P]``; identity if None.
      generator: torch.Generator for the momentum and the accept uniform.
      z, u_accept: optional standard-normal ``[C, P]`` and uniform ``[C]``
        draws used instead of the generator (the tests inject the JAX
        package's draws).

    Returns:
      ``(new_position, HMCInfo)``.
    """
    dtype, device = position.dtype, position.device
    if inv_mass_diag is None:
        inv_mass_diag = torch.ones_like(position)
    step_size = torch.as_tensor(step_size, dtype=dtype, device=device)
    if z is None:
        z = torch.randn(position.shape, generator=generator, dtype=dtype,
                        device=device)
    if u_accept is None:
        u_accept = torch.rand(position.shape[:-1], generator=generator,
                              dtype=dtype, device=device)

    logp0, grad0 = value_and_grad(logdensity_fn, position)
    momentum = z * torch.rsqrt(inv_mass_diag)

    def kinetic(p):
        return 0.5 * torch.sum(p * p * inv_mass_diag, dim=-1)

    q, p, grad, logp_new = position, momentum, grad0, logp0
    for _ in range(num_leapfrog_steps):
        p = p + 0.5 * step_size * grad
        q = q + step_size * inv_mass_diag * p
        logp_new, grad = value_and_grad(logdensity_fn, q)
        p = p + 0.5 * step_size * grad

    energy0 = -logp0 + kinetic(momentum)
    energy1 = -logp_new + kinetic(p)
    # NaN-safe: non-finite proposals are rejected
    log_accept_ratio = torch.where(
        torch.isfinite(energy1), energy0 - energy1,
        torch.full_like(energy0, -torch.inf),
    )
    accept_prob = torch.clamp(torch.exp(log_accept_ratio), max=1.0)
    accepted = u_accept < accept_prob
    new_position = torch.where(accepted[:, None], q, position)
    info = HMCInfo(
        is_accepted=accepted,
        log_accept_ratio=log_accept_ratio,
        target_log_prob=torch.where(accepted, logp_new, logp0),
        step_size=step_size,
    )
    return new_position, info
