"""Batch-sharded (data-parallel) spellings of the conv1d ops (counterpart
of the data half of ``repro/kernels/sharded.py``).

The paper's end-to-end result is data-parallel AtacWorks training with
the gradients all-reduced over the sockets.  Here each rank of a
``torch.distributed`` data group (``launch.mesh``) holds its share of the
batch:

  * ``x`` (and ``residual``) are the rank's local batch; ``w`` and
    ``bias`` are the same on every rank;
  * the body is the ordinary ``ops.conv1d`` / ``ops.depthwise_conv1d`` at
    the local shape, so a ``backend="auto"`` call resolves its plan from
    the local ``ConvProblem`` (N_local = N / dp), never the global one;
  * the output is the rank's local output; under autograd the weight and
    bias gradients come back summed over the ranks (``ops.ReduceGrad``
    on the replicated operands, as ``shard_map``'s transpose psums a
    replicated operand's cotangent); ``dx`` stays local.

**Where the reduce happens** depends on where the gradient is taken, as
in the JAX package.  Differentiating *through* these wrappers, the
wrapper's own ``ReduceGrad`` sums the gradients: the body must NOT also
get ``grad_reduce``, or every weight gradient counts dp times (``grad_reduce``
here raises).  Taking the gradient of a loss whose every layer runs on a
rank's share, the training path (``train/data_parallel.py``), nothing
reduces for you: there ``grad_reduce`` sums each layer's gradients right
after its bwd-weight pass.

A wrapper's reduce waits where it is issued, so ``.backward()`` may read
``w.grad`` at once.  Each call checks that the data group exists and that
the ranks' local batches are equal (one all-gather of the local batch
size), the JAX package's two errors.

Example (a world of 1 on the CPU)::

    >>> import os, tempfile, torch
    >>> from repro_torch.launch import mesh
    >>> from repro_torch.kernels.sharded import sharded_conv1d
    >>> store = os.path.join(tempfile.mkdtemp(), "store")
    >>> group = mesh.init_data_group("gloo", f"file://{store}", 1, 0)
    >>> x, w = torch.ones(4, 8, 64), torch.ones(3, 4, 8)
    >>> sharded_conv1d(x, w, group=group, dilation=2, padding="SAME").shape
    torch.Size([4, 4, 64])
    >>> mesh.destroy()
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import ops
from .reduce import dp_size


def _check_batch(n_local: int, group, device) -> None:
    """Raise unless ``group`` is a started data group over which the
    ranks' local batches are equal (the global batch divides)."""
    if group is None or not dist.is_initialized():
        raise ValueError(
            "no data-parallel group to shard the batch over: start one "
            "with launch.mesh.init_data_group and pass it as group=")
    dp = dp_size(group)
    sizes = [torch.zeros((), dtype=torch.int64, device=device)
             for _ in range(dp)]
    dist.all_gather(sizes, torch.tensor(n_local, device=device), group=group)
    sizes = [int(s) for s in sizes]
    if len(set(sizes)) > 1:
        raise ValueError(
            f"batch {sum(sizes)} does not divide over {dp} data-parallel "
            f"shards (local batches {sizes}); pad or re-batch the input")


def _sharded_call(fn, group, x, w, bias, residual, kwargs):
    if "grad_reduce" in kwargs:
        raise ValueError(
            "grad_reduce inside a sharded wrapper would count every weight "
            "gradient dp times: the wrapper already sums them over the "
            "group (see the module docstring)")
    _check_batch(x.shape[0], group, x.device)
    w = ops.ReduceGrad.reduce(group, w)
    if bias is not None:
        bias = ops.ReduceGrad.reduce(group, bias)
    return fn(x, w, bias=bias, residual=residual, **kwargs)


def sharded_conv1d(x: torch.Tensor, w: torch.Tensor, *, group,
                   bias: torch.Tensor | None = None,
                   residual: torch.Tensor | None = None,
                   **kwargs) -> torch.Tensor:
    """Data-parallel ``ops.conv1d`` on the rank's local batch ``x`` (and
    ``residual``), ``w``/``bias`` the same on every rank; returns the
    local output, and under autograd the w and bias gradients summed over
    ``group``.  Every other ``conv1d`` keyword (activation, dilation,
    padding, backend, tile, the pass pins, out_dtype) passes through to
    the body; ``grad_reduce`` is refused (the double count)."""
    return _sharded_call(ops.conv1d, group, x, w, bias, residual, kwargs)


def sharded_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *, group,
                             bias: torch.Tensor | None = None,
                             residual: torch.Tensor | None = None,
                             **kwargs) -> torch.Tensor:
    """Data-parallel ``ops.depthwise_conv1d`` (the contract of
    :func:`sharded_conv1d`)."""
    return _sharded_call(ops.depthwise_conv1d, group, x, w, bias, residual,
                         kwargs)
