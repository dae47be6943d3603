"""Device-mesh construction helpers.

Port of ``covid19uk_tpu/parallel/mesh.py`` on ``torch.distributed``: one
rank drives one device, so a mesh of ``n`` devices is a
``DeviceMesh`` over ranks ``0 .. n-1`` of the initialized group
(``parallel/distributed.py:initialize``).  :func:`mesh_shape` is the
(chain, space) shape rule alone, with no group.  A mesh's sub-groups are
the DeviceMesh's own: ``mesh.get_group("space")`` holds the ranks that
share one slice of the chains (the space group), ``mesh.get_group("chain")``
the ranks that hold one band of the locations; :func:`axis` reads a rank's
place on either axis.
"""

import torch
import torch.distributed as dist


def mesh_shape(n, space=None):
    """The shape of :func:`chain_space_mesh` over ``n`` devices,
    ``{"chain": n // space, "space": space}``; by default ``space`` is 2
    when ``n`` is even and at least 4, else 1 (the JAX package's rule)."""
    if space is None:
        space = 2 if n % 2 == 0 and n >= 4 else 1
    if n % space:
        raise ValueError(f"space={space} must divide the device count {n}")
    return {"chain": n // space, "space": space}


def _device_mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for v in shape.values():
        n *= v
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} devices over {dist.get_world_size()}"
                         " ranks: one rank drives one device")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(
        tuple(shape.values())), mesh_dim_names=tuple(shape))


def chain_mesh(n=None):
    """1-D mesh over a ``chain`` axis (pure data parallelism) of ``n``
    ranks, by default all of them."""
    return _device_mesh({"chain": n or dist.get_world_size()})


def chain_space_mesh(n=None, space=None):
    """2-D mesh (chain, space) of ``n`` ranks, by default all of them;
    ``space`` as :func:`mesh_shape` sets it."""
    return _device_mesh(mesh_shape(n or dist.get_world_size(), space))


def axis(mesh, name):
    """``(size, this rank's index)`` along ``mesh``'s axis ``name``; ``(1,
    0)`` when the mesh has no such axis (a chain mesh has no ``space``)."""
    if name not in mesh.mesh_dim_names:
        return 1, 0
    return (mesh.shape[mesh.mesh_dim_names.index(name)],
            mesh.get_local_rank(name))
