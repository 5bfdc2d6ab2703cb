"""The data and model groups (counterpart of ``repro/launch/mesh.py``'s
``make_host_mesh(model=)``, ``make_production_mesh``, ``make_grid_mesh``,
``dp_size``, ``mp_size`` and ``mp_axis_name``).

The JAX package names ``('data', 'model')`` mesh axes and lets
``lax.psum`` reduce over them.  Here each axis is a ``torch.distributed``
process group, one process per card:

  * :func:`init_data_group` starts the default group (the world), from
    its arguments or from the variables ``torchrun`` sets
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, and
    ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``); alone it is the
    data group of pure data parallelism;
  * :func:`init_mesh` lays the started world out as a (dp, mp) grid, as
    JAX reshapes its devices to ``(data, model)``: rank r sits at data
    row ``r // mp`` and model column ``r % mp``, its model group being
    its row (the mp ranks that hold the same data shard) and its data
    group its column (the dp ranks that hold the same filter block);
  * :func:`make_host_mesh` gives the started world's ``(data, model)``
    mesh shape and this rank's coordinates on it, what
    ``models/sharding.py``'s rules read to place a tensor-parallel
    model's blocks (JAX's ``make_host_mesh(model=)``);
  * :func:`regroup` starts the next *generation* of the default group
    over the survivors of a fault (counterpart of JAX's
    ``make_elastic_mesh``): ``torch.distributed`` cannot shrink a group,
    so the old one is torn down and a new one started from the
    rendezvous store :func:`init_data_group` kept, each generation under
    its own key prefix (``elastic/gen<g>``).  A process keeps its
    :func:`launch_rank`, its rank in generation 0, across generations;
  * :func:`make_production_mesh` gives JAX's production meshes, single
    ``(data 16, model 16)`` and multi ``(pod 2, data 16, model 16)``, as
    a ``sharding.MeshShape``: names and sizes, no process group.  Nothing
    starts 256 or 512 ranks; the dry-run (``launch/dryrun.py``) builds
    one rank of them over counting groups;
  * :func:`dp_size` of a ``MeshShape`` is the product of its ``'pod'``
    and ``'data'`` axes (JAX's ``dp_size(mesh)``); of a process group (or
    None), its ranks.  :func:`dp_rank`, :func:`mp_size`, :func:`mp_rank`,
    :class:`GradReducer` and :class:`ModelReducer`, which read the groups
    and reduce over them, live in ``kernels/reduce.py`` (the conv
    Functions reduce through them) and are re-exported here.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.kernels import reduce as _reduce
from repro_torch.kernels.reduce import (GradReducer, ModelReducer, dp_rank,
                                        mp_rank, mp_size)
from repro_torch.models.sharding import MeshShape, data_size

__all__ = ["GradReducer", "ModelReducer", "destroy", "dp_rank", "dp_size",
           "init_data_group", "init_mesh", "launch_rank", "local_rank",
           "make_host_mesh", "make_production_mesh", "mp_rank", "mp_size",
           "regroup"]

# the rendezvous of the group init_data_group started: (store, launch
# rank), beside torch.distributed's own default group, which is as global
_launch: tuple | None = None


def init_data_group(backend: str | None = None, init_method: str | None = None,
                    world_size: int | None = None, rank: int | None = None):
    """Start the default process group and return it (the data group), or
    return None for a world of 1 that asks for no backend.

    Absent arguments come from ``torchrun``'s variables (``WORLD_SIZE``,
    ``RANK``; ``init_method`` then defaults to ``env://``, or for a world
    of 1 outside ``torchrun`` to an in-process store).  ``backend``
    defaults to ``"nccl"`` when CUDA is available, else ``"gloo"``; a
    world of 1 with no ``backend`` named and no ``torchrun`` needs no
    group.  A group already started is returned as it is, unless it runs
    another backend than the one named.

    The rendezvous store (``dist.rendezvous``) is kept for
    :func:`regroup`, and generation 0 starts over its ``elastic/gen0``
    prefix.  Under ``env://`` outside ``torchrun`` launch rank 0 hosts
    the TCP store, so it must outlive the run; ``torchrun``'s agent
    hosts it there, and ``file://`` needs no host."""
    global _launch
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(f"a {dist.get_backend()} group is already "
                             f"started; {backend} was asked for")
        return dist.group.WORLD
    env_world = os.environ.get("WORLD_SIZE")
    if world_size is None:
        world_size = int(env_world) if env_world else 1
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size == 1 and backend is None and env_world is None:
        return None
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None and world_size == 1 \
            and "MASTER_ADDR" not in os.environ:
        # a world of 1 meets no one: an in-process store, no rendezvous
        store = dist.HashStore()
    else:
        store, rank, world_size = next(dist.rendezvous(
            init_method or "env://", rank=rank, world_size=world_size))
    _launch = (store, rank)
    dist.init_process_group(backend, store=dist.PrefixStore(
        "elastic/gen0", store), world_size=world_size, rank=rank)
    return dist.group.WORLD


def launch_rank() -> int:
    """This process's rank in generation 0 of the group
    :func:`init_data_group` started (the identity a regroup keeps); the
    started group's rank otherwise, 0 without one."""
    if _launch is not None:
        return _launch[1]
    return dist.get_rank() if dist.is_initialized() else 0


def regroup(survivors, generation: int):
    """Start generation ``generation`` of the default group over
    ``survivors`` (launch ranks, in launch order), ranked by their place
    in it, with the backend of the group it replaces; return it, or None
    in a process whose launch rank is not among them, which leaves.

    Every process of the ending generation calls it with the same
    arguments: all of them meet at one barrier of the old group, so no
    collective of it is in flight when it is torn down
    (``dist.destroy_process_group``; the groups that ``init_mesh`` made
    end with it).  The survivors then meet over
    ``PrefixStore(f"elastic/gen{generation}", store)`` of the store
    :func:`init_data_group` kept.  Handles to the old groups (reducers,
    steps, closures) must not be used again."""
    if _launch is None:
        raise ValueError("regroup needs the group init_data_group started "
                         "(it keeps the rendezvous store)")
    store, me = _launch
    backend = dist.get_backend()
    dist.barrier()
    dist.destroy_process_group()
    survivors = list(survivors)
    if me not in survivors:
        return None
    dist.init_process_group(
        backend, store=dist.PrefixStore(f"elastic/gen{generation}", store),
        world_size=len(survivors), rank=survivors.index(me))
    return dist.group.WORLD


def init_mesh(dp: int, mp: int):
    """``(data_group, model_group)`` of this rank on a ``dp`` x ``mp``
    layout of the started world (``dp * mp`` ranks; rank r at data row
    ``r // mp``, model column ``r % mp``).

    ``mp == 1`` is pure data parallelism: the data group is the world and
    there is no model group (None, a model axis of size 1).  Otherwise
    every rank creates every row and every column group, in the same
    order, as ``dist.new_group`` requires of all ranks, and keeps the two
    it is in; a dp of 1 gives a data group of one rank, whose reduces are
    the identity.  Without a started group the world is one process:
    ``(None, None)`` for ``dp == mp == 1``."""
    if dp < 1 or mp < 1:
        raise ValueError(f"a mesh needs dp >= 1 and mp >= 1, got ({dp}, {mp})")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * mp != world:
        raise ValueError(f"a ({dp}, {mp}) mesh needs {dp * mp} ranks; the "
                         f"world has {world}")
    if mp == 1:
        return (dist.group.WORLD if dist.is_initialized() else None), None
    rank = dist.get_rank()
    data = model = None
    for row in range(dp):
        g = dist.new_group([row * mp + m for m in range(mp)])
        if row == rank // mp:
            model = g
    for col in range(mp):
        g = dist.new_group([d * mp + col for d in range(dp)])
        if col == rank % mp:
            data = g
    return data, model


def make_host_mesh(*, model: int = 1) -> tuple[MeshShape, dict[str, int]]:
    """The started world as a ``("data", "model")`` mesh of ``(world /
    model, model)`` and this rank's coordinates on it, ``{"data": r //
    model, "model": r % model}``: the layout :func:`init_mesh` gives its
    groups (a world of one process without a group: ``(1, 1)``, rank
    0)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {world} ranks")
    return (MeshShape(("data", "model"), (world // model, model)),
            {"data": rank // model, "model": rank % model})


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """JAX's production mesh: ``(data 16, model 16)``, 256 ranks, or with
    ``multi_pod`` ``(pod 2, data 16, model 16)``, 512."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def dp_size(mesh_or_group=None) -> int:
    """The data-parallel width: of a ``MeshShape``, the product of its
    ``'pod'`` and ``'data'`` axes (JAX's ``dp_size(mesh)``); of a data
    group, its ranks; 1 for None."""
    if isinstance(mesh_or_group, MeshShape):
        return data_size(mesh_or_group)
    return _reduce.dp_size(mesh_or_group)


def local_rank() -> int:
    """The process's card on its host (``torchrun``'s ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def destroy() -> None:
    """End the default process group, if one was started, and forget its
    rendezvous."""
    global _launch
    _launch = None
    if dist.is_initialized():
        dist.destroy_process_group()
