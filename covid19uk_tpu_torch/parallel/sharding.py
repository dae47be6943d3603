"""Sharded multi-chain MCMC over a device mesh: the chain axis.

Port of the chain half of ``covid19uk_tpu/parallel/sharding.py``.  The
chain axis is data parallelism: rank ``r`` of ``w`` along the mesh's
``chain`` axis holds chains ``[r * C / w, (r + 1) * C / w)`` and advances
them as its own batch; the transition itself runs no collective.  The
ranks' rows come together again only where the driver already waits for
the host (:func:`gather_chains`).  Pooled adaptation across the ranks
lives in the driver (``inference/driver.py``).

The space half (the event tensor's location axis over a ``space`` mesh
axis) raises ``NotImplementedError``: in eager torch every read across
locations needs a collective of its own (the commute product, the sweep's
location sampling, the windowed deltas), which is the later space-axis
slice's work.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from covid19uk_tpu_torch.inference.gibbs import ChainState, HMCTunables


def _no_space(shard_space):
    if shard_space:
        raise NotImplementedError(
            "sharding the location axis over a space mesh axis is not "
            "ported: the space-axis slice comes later (ROADMAP.md §1)")


def chain_rows(num_chains, mesh):
    """This rank's rows of ``num_chains`` chains along ``mesh``'s
    ``chain`` axis."""
    size = mesh.shape[mesh.mesh_dim_names.index("chain")]
    if num_chains % size:
        raise ValueError(f"num_chains={num_chains} must be a multiple of "
                         f"the chain-axis device count {size}")
    per = num_chains // size
    r = mesh.get_local_rank("chain")
    return slice(r * per, (r + 1) * per)


def shard_chain_state(state: ChainState, mesh, shard_space=False):
    """This rank's rows of a batched ``ChainState [C, ...]``."""
    _no_space(shard_space)
    rows = chain_rows(state.u.shape[0], mesh)
    return ChainState(u=state.u[rows], events=state.events[rows])


def shard_tunables(tune: HMCTunables, mesh):
    """This rank's rows of chain-batched tunables: ``step_size [C, ...]``
    and ``inv_mass_diag [C, P]``; the move decays are shared."""
    rows = chain_rows(tune.step_size.shape[0], mesh)
    return tune._replace(step_size=tune.step_size[rows],
                         inv_mass_diag=tune.inv_mass_diag[rows])


def gather_chains(tree, mesh, axis=0, dst=None):
    """The inverse of the sharding: every leaf of ``tree`` (a tuple or
    NamedTuple tree of tensors or numpy arrays holding this rank's rows
    along ``axis``) concatenated over the ``chain`` axis in rank order.
    With ``dst`` (a global rank) only that rank receives the result and
    the others get None.  The leaves travel as numpy through the host
    (pickled, on a gloo or an NCCL group alike); a tensor comes back on
    its device."""
    group = mesh.get_group("chain")
    size = dist.get_world_size(group)
    if size == 1:
        return tree
    leaves, spec = tree_flatten(tree)
    mine = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
            for x in leaves]
    if dst is None:
        parts = [None] * size
        dist.all_gather_object(parts, mine, group=group)
    else:
        parts = [None] * size if dist.get_rank() == dst else None
        dist.gather_object(mine, parts, dst=dst, group=group)
        if parts is None:
            return None
    out = []
    for i, x in enumerate(leaves):
        joined = None if x is None else np.concatenate(
            [p[i] for p in parts], axis=axis)
        if isinstance(x, torch.Tensor):
            joined = torch.as_tensor(joined, device=x.device)
        out.append(joined)
    return tree_unflatten(out, spec)


def make_sharded_step(step_fn, mesh, shard_space=False):
    """The transition over this rank's chains.

    Args:
      step_fn: ``gibbs.make_mcmc_step``'s ``(state, tune, generator=None,
        noise=None) -> (state, trace)`` over a batch of chains.
      mesh: a ``DeviceMesh`` with a ``chain`` axis.

    Returns:
      ``step(state, tune, generator=None, noise=None)`` with ``state`` and
      ``tune`` this rank's rows (:func:`shard_chain_state`,
      :func:`shard_tunables`) and ``noise`` an optional ``StepNoise`` of
      all ``C`` chains, of which the step takes the same rows.  No
      collective runs.
    """
    _no_space(shard_space)

    def step(state, tune, generator=None, noise=None):
        if noise is not None:
            rows = chain_rows(noise.z.shape[0], mesh)
            noise = type(noise)(*[None if x is None else x[rows]
                                  for x in noise])
        return step_fn(state, tune, generator, noise)

    return step
