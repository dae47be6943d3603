"""Sharded multi-chain MCMC over a device mesh: the chain and space axes.

Port of ``covid19uk_tpu/parallel/sharding.py``.  The chain axis is data
parallelism: rank ``r`` of ``w`` along the mesh's ``chain`` axis holds
chains ``[r * C / w, (r + 1) * C / w)`` and advances them as its own
batch; the transition itself runs no collective over it.  The ranks' rows
come together again only where the driver already waits for the host
(:func:`gather_chains`).  Pooled adaptation across the ranks lives in the
driver (``inference/driver.py``).

The space axis shards the event tensor's location axis: the ranks of one
space group (``mesh.get_group("space")``) hold the same chains, each on
its contiguous band of ``M / space`` locations (:func:`location_band`).
XLA derives the JAX package's collectives from sharding annotations; in
eager torch each read across locations is an explicit collective of
:class:`SpaceBand`, which ``gibbs.make_mcmc_step(space=...)`` takes: the
commute ``Cstar @ (I/N)`` from the gathered ``I/N`` (a dense row band, or
K2 on the rank's band of block rows and a sum), HMC's value and gradient
summed over the group, and the event sweep run on every rank of the group
on the gathered events with one generator, each rank keeping its band.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from covid19uk_tpu_torch.inference.gibbs import ChainState, HMCTunables
from covid19uk_tpu_torch.parallel.mesh import axis


def location_band(M, space, r):
    """Rank ``r``'s band of ``M`` locations split over ``space`` ranks;
    ``M`` must be a multiple of ``space``, as the JAX driver requires."""
    if M % space:
        raise ValueError(f"num_locations={M} must be a multiple of "
                         f"space_devices={space}")
    per = M // space
    return slice(r * per, (r + 1) * per)


class SpaceBand:
    """This rank's band of ``M`` locations on ``mesh``'s space axis and the
    collectives of its space group.

    Every result of :meth:`gather` and :meth:`sum` is bitwise the same on
    all ranks of the group, so that the ranks take the same decisions.
    Gloo has no all-gather of CUDA tensors: there :meth:`gather` goes
    through the host (one card, several ranks); NCCL gathers on the
    device."""

    def __init__(self, mesh, M):
        self.size, self.rank = axis(mesh, "space")
        self.group = mesh.get_group("space") if self.size > 1 else None
        self.rows = location_band(M, self.size, self.rank)
        self.lead = self.rank == 0  # adds the replicated terms once
        self._bsr = (None, None)  # the last operator and its band

    def gather(self, x, dim):
        """``x`` (this rank's band along ``dim``) joined over the group."""
        if self.group is None:
            return x
        host = x.is_cuda and dist.get_backend(self.group) == "gloo"
        part = (x.cpu() if host else x).contiguous()
        parts = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(parts, part, group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if host else out

    def sum(self, x):
        """``x`` summed over the group (in place)."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def sum_value_grad(self, value, grad):
        """``hmc.value_and_grad``'s ``reduce``: the ranks' partial values
        ``[C]`` and gradients ``[C, P]`` summed in one all-reduce."""
        packed = self.sum(torch.cat([value[:, None], grad], dim=1))
        return packed[:, 0], packed[:, 1:]

    def any(self, flag):
        """True on every rank when ``flag`` is on one of the group's."""
        if self.group is None:
            return flag
        nccl = dist.get_backend(self.group) == "nccl"
        t = torch.tensor([int(flag)], device=torch.cuda.current_device()
                         if nccl else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def bsr_band(self, op):
        """This rank's :class:`~covid19uk_tpu_torch.ops.block_sparse.RowBand`
        of the block-sparse ``op``, or None when its block rows do not split
        over the group: the operator then stays whole on every rank, as
        the JAX driver keeps it replicated (``shard_bsr``)."""
        if self._bsr[0] is not op:
            R = op.col_idx.shape[0]
            self._bsr = (op, op.row_band(self.rank, self.size)
                         if R % self.size == 0 else None)
        return self._bsr[1]


def chain_rows(num_chains, mesh):
    """This rank's rows of ``num_chains`` chains along ``mesh``'s
    ``chain`` axis."""
    size, r = axis(mesh, "chain")
    if num_chains % size:
        raise ValueError(f"num_chains={num_chains} must be a multiple of "
                         f"the chain-axis device count {size}")
    per = num_chains // size
    return slice(r * per, (r + 1) * per)


def shard_chain_state(state: ChainState, mesh, shard_space=False):
    """This rank's rows of a batched ``ChainState [C, ...]``; with
    ``shard_space``, its events on this rank's band of locations too
    (``[C / chain, M / space, T, X]``, contiguous)."""
    rows = chain_rows(state.u.shape[0], mesh)
    events = state.events[rows]
    if shard_space:
        size, r = axis(mesh, "space")
        events = events[:, location_band(events.shape[1], size, r)]
    return ChainState(u=state.u[rows], events=events.contiguous())


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


def gather_space(tree, mesh, axis_, to_lead=False):
    """The inverse of the space sharding: every leaf of ``tree`` (tensors
    or numpy arrays holding this rank's band of locations along
    ``axis_``) joined over the space group in rank order, through the host
    as :func:`gather_chains` joins chains; with ``to_lead`` only the
    group's first rank receives it and the others get None."""
    size, r = axis(mesh, "space")
    if size == 1:
        return tree
    group = mesh.get_group("space")
    leaves, spec = tree_flatten(tree)
    mine = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
            for x in leaves]
    if not to_lead:
        parts = [None] * size
        dist.all_gather_object(parts, mine, group=group)
    else:
        dst = dist.get_global_rank(group, 0)
        parts = [None] * size if r == 0 else None
        dist.gather_object(mine, parts, dst=dst, group=group)
        if parts is None:
            return None
    out = []
    for i, x in enumerate(leaves):
        joined = np.concatenate([p[i] for p in parts], axis=axis_)
        if isinstance(x, torch.Tensor):
            joined = torch.as_tensor(joined, device=x.device)
        out.append(joined)
    return tree_unflatten(out, spec)


def make_sharded_step(step_fn, mesh, shard_space=False):
    """The transition over this rank's chains.

    Args:
      step_fn: ``gibbs.make_mcmc_step``'s ``(state, tune, generator=None,
        noise=None) -> (state, trace)`` over a batch of chains; with
        ``shard_space``, built with ``space=SpaceBand(mesh, M)``.
      mesh: a ``DeviceMesh`` with a ``chain`` axis (and a ``space`` axis
        with ``shard_space``).
      shard_space: the state's events hold this rank's band of locations.

    Returns:
      ``step(state, tune, generator=None, noise=None)`` with ``state`` and
      ``tune`` this rank's rows (:func:`shard_chain_state`,
      :func:`shard_tunables`) and ``noise`` an optional ``StepNoise`` of
      all ``C`` chains, of which the step takes the same rows.  Over the
      chain axis no collective runs; the space group's run inside the
      step, and its ranks must share the generator's seed.
    """
    if shard_space and getattr(step_fn, "space", None) is None:
        raise ValueError("a space-sharded step needs make_mcmc_step("
                         "..., space=SpaceBand(mesh, M))")

    def step(state, tune, generator=None, noise=None):
        if noise is not None:
            rows = chain_rows(noise.z.shape[0], mesh)
            noise = type(noise)(*[None if x is None else x[rows]
                                  for x in noise])
        return step_fn(state, tune, generator, noise)

    return step
