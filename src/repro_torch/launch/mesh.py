"""The data and model groups (counterpart of ``repro/launch/mesh.py``'s
``make_host_mesh(model=)``, ``make_grid_mesh``, ``dp_size``, ``mp_size``
and ``mp_axis_name``).

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
  * :func:`dp_size`, :func:`dp_rank`, :func:`mp_size`, :func:`mp_rank`,
    :class:`GradReducer` and :class:`ModelReducer`, which read the groups
    and reduce over them, live in ``kernels/reduce.py`` (the conv
    Functions reduce through them) and are re-exported here.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.kernels.reduce import (GradReducer, ModelReducer, dp_rank,
                                        dp_size, mp_rank, mp_size)

__all__ = ["GradReducer", "ModelReducer", "destroy", "dp_rank", "dp_size",
           "init_data_group", "init_mesh", "local_rank", "mp_rank", "mp_size"]


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
    another backend than the one named."""
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
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
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


def local_rank() -> int:
    """The process's card on its host (``torchrun``'s ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def destroy() -> None:
    """End the default process group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()
