"""The data-parallel group (counterpart of the data half of
``repro/launch/mesh.py``).

The JAX package names a ``('data',)`` mesh axis and lets ``lax.psum``
reduce over it.  Here the axis is a ``torch.distributed`` process group,
one process per card:

  * :func:`init_data_group` starts it, from its arguments or from the
    variables ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    and ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``);
  * :func:`dp_size`, :func:`dp_rank` and :class:`GradReducer`, which
    read the group and reduce over it, live in ``kernels/reduce.py``
    (the conv Functions reduce through them) and are re-exported here.

The model axis of tensor parallelism waits in ROADMAP.md queue A.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.kernels.reduce import GradReducer, dp_rank, dp_size

__all__ = ["GradReducer", "destroy", "dp_rank", "dp_size", "init_data_group",
           "local_rank"]


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


def local_rank() -> int:
    """The process's card on its host (``torchrun``'s ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def destroy() -> None:
    """End the default process group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()
