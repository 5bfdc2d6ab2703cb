"""Elastic scaling: recompute the run's layout when the set of ranks
changes (counterpart of ``repro/runtime/elastic.py``; the same plans).

A checkpoint stores whole tensors (``checkpoint/checkpoint.py``), so
scaling is a *layout* problem, not a data problem:

  1. the supervisor observes the new healthy-rank count,
  2. ``plan_mesh`` picks the largest usable (data, model) grid; the model
     axis is kept fixed (the K-sharded layers assume the tensor-parallel
     width), so only 'data' and 'pod' shrink or grow,
  3. ``plan_batch`` re-derives gradient accumulation so the GLOBAL batch
     (and with it the training trajectory) is preserved exactly across
     the scale event,
  4. ``build_groups`` tears the process group down and starts the next
     generation's over the survivors (``launch.mesh.regroup``), and the
     launcher rebuilds its step and restores the checkpoint.

The JAX package refuses impossible inputs with ``assert``; these raise
``ValueError`` with the same numbers.

    >>> plan_mesh(8, model_parallel=2)
    ((4, 2), ('data', 'model'))
    >>> p = make_plan(4, model_parallel=1, global_batch=8)   # dp 8 -> 4
    >>> (p.mesh_shape, p.accum_steps * p.microbatch)
    ((4, 1), 8)
    >>> plan_batch(24, 4, max_microbatch_per_shard=4)  # 4 does not divide 6
    (2, 12)
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_devices: int
    mesh_shape: tuple
    axis_names: tuple
    accum_steps: int
    microbatch: int


def plan_mesh(n_devices: int, *, model_parallel: int,
              pod_size: int | None = None):
    """Largest (pod, data, model) grid using <= n_devices whole data
    rows."""
    if n_devices < model_parallel:
        raise ValueError((n_devices, model_parallel))
    rows = n_devices // model_parallel
    if pod_size and rows > pod_size:
        pods = rows // pod_size
        return (pods, pod_size, model_parallel), ("pod", "data", "model")
    return (rows, model_parallel), ("data", "model")


def plan_batch(global_batch: int, dp_size: int, *,
               max_microbatch_per_shard: int = 1) -> tuple[int, int]:
    """(accum_steps, microbatch) preserving the exact global batch.

    Requires dp_size | global_batch (``make_plan`` only admits such data
    widths; otherwise it rounds the layout down further).
    """
    if global_batch % dp_size:
        raise ValueError((global_batch, dp_size))
    per_shard = global_batch // dp_size
    micro_per_shard = max(1, min(per_shard, max_microbatch_per_shard))
    # the per-shard microbatch must DIVIDE the per-shard batch, or accum x
    # microbatch under-counts the global batch (per_shard=6, cap=4 would
    # plan accum=1 x micro=4 and drop a third of the batch); walk down to
    # the largest divisor <= the cap instead
    while per_shard % micro_per_shard:
        micro_per_shard -= 1
    accum = per_shard // micro_per_shard
    return accum, micro_per_shard * dp_size


def make_plan(n_devices: int, *, model_parallel: int, global_batch: int,
              pod_size: int | None = None,
              max_microbatch_per_shard: int = 1) -> ElasticPlan:
    """The plan over ``n_devices`` healthy ranks: the largest data width
    <= the available rows (whole pods) that divides the global batch."""
    rows = n_devices // model_parallel
    if pod_size and rows >= pod_size:
        rows = (rows // pod_size) * pod_size  # whole pods only
    dp = rows
    while dp > 0 and global_batch % dp != 0:
        dp -= 1
        if pod_size and dp >= pod_size:
            dp = (dp // pod_size) * pod_size
    if dp <= 0:
        raise ValueError((n_devices, model_parallel, global_batch))
    shape, names = plan_mesh(dp * model_parallel,
                             model_parallel=model_parallel, pod_size=pod_size)
    accum, micro = plan_batch(
        global_batch, dp, max_microbatch_per_shard=max_microbatch_per_shard)
    return ElasticPlan(dp * model_parallel, shape, names, accum, micro)


def build_groups(plan: ElasticPlan, survivors, generation: int):
    """Start generation ``generation``'s groups over the first
    ``prod(plan.mesh_shape)`` of ``survivors`` (launch ranks, in launch
    order), as JAX's ``build_mesh`` takes the first devices of the
    survivors: ``(data_group, model_group)`` of this rank
    (``launch.mesh.init_mesh``), or None for a rank that sits this
    generation out (a lost rank, or a survivor beyond the plan's ranks).

    Every rank of the ending generation calls it (or
    ``launch.mesh.regroup``) with the same arguments: the old group is
    torn down behind one barrier of all its ranks."""
    from repro_torch.launch import mesh
    need = math.prod(plan.mesh_shape)
    survivors = list(survivors)
    if need > len(survivors):
        raise ValueError(f"mesh shape {tuple(plan.mesh_shape)} needs {need} "
                         f"ranks, only {len(survivors)} healthy")
    if mesh.regroup(survivors[:need], generation) is None:
        return None
    mp = plan.mesh_shape[-1]
    return mesh.init_mesh(need // mp, mp)
