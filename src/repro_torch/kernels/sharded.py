"""Batch-sharded (data-parallel) and filter-sharded (tensor-parallel)
spellings of the conv1d ops (counterpart of ``repro/kernels/sharded.py``).

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

**Model-axis (tensor-parallel) spellings** compose with the above on a
(data, model) layout of ranks (``launch.mesh.init_mesh``):

  * :func:`model_sharded_conv1d` K-shards the dense filter dimension: each
    rank of the model group computes its own K/mp filter rows from all C
    input channels, and the output is reassembled by an all-gather along
    K (:func:`model_concat`, no sum).  Under autograd dx is summed over
    the model group (x is the same on every model rank) and dw, dbias
    come back full and summed over the data group on every rank;
  * :func:`model_sharded_depthwise_conv1d` shards channel groups: no
    model collective on any pass, since each output channel reads only
    its own input channel;
  * a loss whose gradient is taken over the whole model (the training
    path, ``core/blocks.py``) composes the pieces itself:
    :func:`shard_param` (this rank's block of a replicated parameter; its
    backward pads the block's data-summed gradient and sums it over the
    model group, so every rank gets the full gradient),
    :func:`shard_block` (a plain slice of an activation whose cotangent
    stays the rank's own, the residual), ``ops.conv1d(grad_reduce=,
    model_reduce=)`` (the block's (dw, dbias) summed over the data group
    after bwd-weight, chunked by ``grad_reduce_chunks``; dx summed over
    the model group after bwd-data, chunked by ``model_reduce_chunks``)
    and :func:`model_concat`.

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
from .reduce import GradReducer, dp_size, mp_rank, mp_size


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


# ---------------------------------------------------------------------------
# Model-axis (tensor-parallel) sharding
# ---------------------------------------------------------------------------


def _check_model(model_group, *, K=None, C=None, depthwise=False) -> int:
    """Raise unless ``model_group`` is a started group over which the
    sharded dimension divides; return mp (possibly 1)."""
    if model_group is None or not dist.is_initialized():
        raise ValueError(
            "no model group to shard filters or channels over: start one "
            "with launch.mesh.init_mesh and pass it as model_group=")
    mp = mp_size(model_group)
    if depthwise:
        if C % mp:
            raise ValueError(
                f"channel count C={C} does not divide over mp={mp} model "
                "shards (depthwise channel groups must split evenly); "
                "pick C % mp == 0 or lower the model axis")
    elif K % mp:
        raise ValueError(
            f"filter count K={K} does not divide over mp={mp} model "
            "shards; pick K % mp == 0 or lower the model axis")
    return mp


def _block(a: torch.Tensor, dim: int, mp: int, rank: int) -> torch.Tensor:
    """Block ``rank`` of ``mp`` equal blocks of ``a`` along ``dim``."""
    size = a.shape[dim] // mp
    return a.narrow(dim, rank * size, size)


def shard_block(a: torch.Tensor, dim: int, mp: int,
                rank: int) -> torch.Tensor:
    """This rank's block of a sharded *activation* (the residual feeding a
    K-sharded conv), as a contiguous copy (the kernels take contiguous
    operands).  Plain autograd is right: the slice's backward zero-pads
    the block cotangent back, with no sum, because each rank's block
    cotangent is a distinct piece of the full activation's gradient, not
    a partial sum of it."""
    return _block(a, dim, mp, rank).contiguous()


class ShardParam(torch.autograd.Function):
    """This rank's block of a replicated parameter, whose backward gives
    every rank the full, summed gradient (JAX's ``shard_param``).

    The sums follow JAX's order.  The block gradient arrives summed over
    the data group by the conv that used the block, under the same
    ``grad_reduce`` (on the kernels, the fp32 accumulator summed, then
    cast to the parameter's dtype), as JAX's conv psums over ``'data'``.
    The backward zero-pads it into the parameter's full shape and sums
    that over the model group ``group`` (JAX's psum over ``'model'``).
    The model ranks' blocks are disjoint, so each element of that sum is
    one rank's value plus zeros: exact in any dtype and order.

    ``grad_reduce`` None or a bare group (no data sum, or one waited
    where it was issued): the block gradient is final and the model sum
    is waited here.  A ``reduce.GradReducer``: the block gradient may be
    a buffer whose data sum is still in flight, so the backward reads
    none of it; it defers the padding and the model sum to the reducer's
    wait (:meth:`~reduce.GradReducer.defer`), which runs them after the
    data sum and waits on the model sum in turn.  The padded buffer it
    hands autograd is filled then (the reducer's rules: the parameter
    feeds one call a backward, and its gradient is read after the
    wait)."""

    @staticmethod
    def forward(ctx, a, dim, mp, rank, group, grad_reduce):
        ctx.dim, ctx.mp, ctx.rank, ctx.group = dim, mp, rank, group
        ctx.reducer = (grad_reduce if isinstance(grad_reduce, GradReducer)
                       else None)
        ctx.shape, ctx.key = a.shape, a.data_ptr()
        return _block(a, dim, mp, rank).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        reducer = ctx.reducer or GradReducer()

        def pad_and_sum():
            _block(full, ctx.dim, ctx.mp, ctx.rank).copy_(g)
            reducer.all_reduce_(full, group=ctx.group)

        if ctx.reducer is None:
            pad_and_sum()
            reducer.wait()
        else:
            reducer.claim(ctx.key)
            reducer.defer(pad_and_sum)
        return full, None, None, None, None, None


def shard_param(a: torch.Tensor, dim: int, mp: int, rank: int, group,
                grad_reduce=None) -> torch.Tensor:
    """This rank's block of the replicated parameter ``a`` along ``dim``,
    its gradient summed over the model group ``group`` after the data sum
    ``grad_reduce`` of the conv that uses it (:class:`ShardParam`)."""
    return ShardParam.apply(a, dim, mp, rank, group, grad_reduce)


class ModelConcat(torch.autograd.Function):
    """A K-sharded layer's output reassembled: the blocks of the model
    group gathered along ``dim`` (JAX's tiled ``all_gather``), with no
    sum, since each rank owns its filter rows.

    The backward takes this rank's own block of the cotangent, with no
    sum.  The cotangent of the gathered activation is already the same
    on every model rank where it came through a K-sharded conv, whose dx
    was summed over the model group after its bwd-data pass, plus this
    rank's own residual block; summing again (the reduce-scatter JAX
    would transpose a gather to) would count the shared part mp times.
    Pairing the own-block backward with the dx sum inside the conv's
    backward is what lets that sum run beside the bwd-data pass."""

    launches = 0  # all-gathers issued, over every call

    @staticmethod
    def forward(ctx, y, dim, group):
        mp = mp_size(group)
        ctx.dim, ctx.mp, ctx.rank = dim, mp, mp_rank(group)
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(mp)]
        dist.all_gather(parts, y, group=group)
        ModelConcat.launches += 1
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.mp, ctx.rank), None, None


def model_concat(y: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model group's blocks of ``y`` gathered along ``dim``
    (:class:`ModelConcat`)."""
    return ModelConcat.apply(y, dim, group)


def _refuse_reduces(kwargs) -> None:
    for k in ("grad_reduce", "model_reduce"):
        if k in kwargs:
            raise ValueError(
                f"{k} inside a sharded wrapper would sum a gradient twice: "
                "the wrapper already sums them over its groups (see the "
                "module docstring)")


def model_sharded_conv1d(x: torch.Tensor, w: torch.Tensor, *, group,
                         model_group, bias: torch.Tensor | None = None,
                         residual: torch.Tensor | None = None,
                         **kwargs) -> torch.Tensor:
    """Tensor-parallel ``ops.conv1d``: ``x`` (and ``residual``) are the
    rank's local batch with all channels, the same on every rank of its
    model group; ``w`` (S, K, C) and ``bias`` the full, replicated
    parameters.  Each rank computes its K/mp filter rows at the local
    shape (a ``backend="auto"`` call resolves its plan from the local K,
    ``ConvProblem.localized(model_shards=)``) and the output, the rank's
    rows with all K filters, is gathered over the model group.  Under
    autograd dx is summed over the model group, and dw, dbias come back
    full: the block summed over the data group inside the conv (on the
    kernels, its fp32 accumulator), then zero-padded and summed over the
    model group (:class:`ShardParam`), both waited before the backward
    returns.  Requires K % mp == 0 and equal local batches; every other
    ``conv1d`` keyword passes through, ``grad_reduce`` and
    ``model_reduce`` are refused (the double count)."""
    _refuse_reduces(kwargs)
    _check_batch(x.shape[0], group, x.device)
    mp = _check_model(model_group, K=w.shape[1])
    r = mp_rank(model_group)
    w_l = shard_param(w, 1, mp, r, model_group)
    b_l = None if bias is None else shard_param(bias, 0, mp, r, model_group)
    res_l = None if residual is None else shard_block(residual, 1, mp, r)
    y = ops.conv1d(x, w_l, bias=b_l, residual=res_l, grad_reduce=group,
                   model_reduce=model_group, **kwargs)
    return model_concat(y, 1, model_group)


def model_sharded_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                                   group, model_group,
                                   bias: torch.Tensor | None = None,
                                   residual: torch.Tensor | None = None,
                                   **kwargs) -> torch.Tensor:
    """Tensor-parallel ``ops.depthwise_conv1d`` on channel groups: ``x``
    (and ``residual``) are the rank's local batch, ``w`` (S, C) and
    ``bias`` the full parameters; the rank computes, and returns, its
    channel group ``[r * C/mp, (r + 1) * C/mp)`` of the output.  No
    model collective runs on any pass: each output channel reads only its
    own input channel.  Under autograd the gradients of x, w and bias are
    the rank's channel group, zeros elsewhere, w's and bias's summed over
    the data group.  Requires C % mp == 0 and equal local batches."""
    _refuse_reduces(kwargs)
    _check_batch(x.shape[0], group, x.device)
    mp = _check_model(model_group, C=w.shape[1], depthwise=True)
    r = mp_rank(model_group)
    w, bias = ops._reduce_params(group, w, bias)
    return ops.depthwise_conv1d(
        shard_block(x, 1, mp, r), shard_block(w, 1, mp, r),
        bias=None if bias is None else shard_block(bias, 0, mp, r),
        residual=None if residual is None else shard_block(residual, 1, mp,
                                                           r), **kwargs)
