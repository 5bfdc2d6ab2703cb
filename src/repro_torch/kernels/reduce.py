"""The sums over the groups of data and tensor parallelism: what the JAX
package spells ``lax.psum`` over its ``'data'`` and ``'model'`` axes,
here ``torch.distributed`` process groups.

  * :func:`dp_size` / :func:`dp_rank` read the data group, and
    :func:`mp_size` / :func:`mp_rank` the model group; ``None`` (no group)
    is a group of 1, where every reduce is the identity, as JAX's psum
    over a size-1 axis is;
  * :class:`GradReducer` issues a step's gradient all-reduces
    asynchronously and keeps their handles until :meth:`GradReducer.wait`;
  * :class:`ModelReducer` sums a K-sharded layer's data gradient over the
    model group, waited inside the backward that issued it.

``ops``, ``sharded`` and ``train.data_parallel`` reduce through this
module; ``launch.mesh`` starts the groups and re-exports these names.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def dp_size(group=None) -> int:
    """Ranks in the data group; 1 without one."""
    if group is None:
        return 1
    return dist.get_world_size(group)


def dp_rank(group=None) -> int:
    """This process's rank in the data group; 0 without one."""
    if group is None:
        return 0
    return dist.get_rank(group)


def mp_size(group=None) -> int:
    """Ranks in the model group (the tensor-parallel width); 1 without
    one."""
    return dp_size(group)


def mp_rank(group=None) -> int:
    """This process's rank in the model group: the filter block it holds;
    0 without one."""
    return dp_rank(group)


class GradReducer:
    """The gradient all-reduces of one backward over ``group``, summed.

    :meth:`all_reduce_` issues one ``dist.all_reduce(..., async_op=True)``
    and keeps its handle with a ``finish`` callable that runs once the
    reduce is done (the cast to the parameter's dtype, or the fixed-order
    sum of a layer's chunked partials).  Issued inside a backward, it also
    queues :meth:`wait` to run when that backward ends, before
    ``torch.autograd.grad`` returns.  The reduces are asynchronous so that
    layer *l*'s can run while the backward of layers < *l* computes, and
    no caller of ``torch.autograd.grad`` sees a gradient whose reduce is
    in flight.

    The gradient a layer hands to autograd is the buffer being reduced in
    place, or one that ``finish`` fills.  Autograd must pass it through
    untouched until the wait: each parameter is used by one call per
    backward (:meth:`claim` refuses a second, whose sum autograd would take
    before the reduce ends), and the gradients are read through
    ``torch.autograd.grad``, not ``.backward()``, whose accumulation into
    ``.grad`` copies them at once.  A bare process group passed as
    ``grad_reduce`` has no such rule: its reduces wait where they are
    issued.

    A second sum that must follow a first (a K-sharded layer's parameter
    block, summed over the data group and then, zero-padded, over the
    model group) is :meth:`defer`'d: its callable runs in :meth:`wait`
    once the reduces issued before it are done, and may issue reduces of
    its own over another group (``all_reduce_(..., group=)``), which the
    same wait waits on.

    A backward that raises runs no queued callback: its caller calls
    :meth:`wait` itself (``make_sharded_grad_fn`` does, in a ``finally``),
    which also drops the claims, so the next step starts clean."""

    launches = 0  # all-reduces issued, over every reducer

    def __init__(self, group=None):
        self.group = group
        self._pending: list = []
        self._claimed: set[int] = set()
        self._queued = False

    @property
    def pending(self) -> int:
        """All-reduces issued and not yet waited on."""
        return len(self._pending)

    def claim(self, key: int) -> None:
        """Refuse a parameter (its ``data_ptr()``) reduced twice before one
        wait."""
        if key in self._claimed:
            raise RuntimeError(
                "a parameter's gradient was all-reduced twice in one "
                "backward: a weight under grad_reduce may feed one conv "
                "call per step (autograd would sum the two gradients "
                "before their reduces end)")
        self._claimed.add(key)

    def all_reduce_(self, buf: torch.Tensor, finish=None,
                    group=None) -> None:
        """Sum ``buf`` over ``group`` (by default the reducer's) in place,
        asynchronously; ``finish`` runs after the sum is complete.  Without
        a group (a world of 1) the sum is ``buf`` itself and ``finish``
        runs at once."""
        group = self.group if group is None else group
        if group is None:
            if finish is not None:
                finish()
            return
        work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                               async_op=True)
        GradReducer.launches += 1
        self._pending.append((work, finish))
        self._queue()

    def defer(self, fn) -> None:
        """Run ``fn`` in :meth:`wait`, after every reduce issued before it
        is done and its ``finish`` has run."""
        self._pending.append((None, fn))
        self._queue()

    def _queue(self) -> None:
        # torch has no public test for "inside a backward"; a graph task id
        # of -1 means none is running
        if not self._queued and torch._C._current_graph_task_id() >= 0:
            torch.autograd.Variable._execution_engine.queue_callback(
                self.wait)
            self._queued = True

    def wait(self) -> None:
        """Wait on every pending reduce, in issue order, and run its
        ``finish`` (and each deferred callable in its place), down to the
        reduces those issue; the reducer is empty afterwards, even if a
        wait raises."""
        try:
            i = 0
            while i < len(self._pending):  # grows while deferred steps run
                work, finish = self._pending[i]
                i += 1
                if work is not None:
                    work.wait()
                if finish is not None:
                    finish()
        finally:
            self._pending = []
            self._claimed.clear()
            self._queued = False


class ModelReducer:
    """The sum of a K-sharded layer's data gradient over the model group
    (JAX's ``_model_psum`` and ``_chunked_psum_bwd_data``).

    Under K-sharding each rank's dx contracts over its own K/mp filter
    rows only, a partial sum; the layer before reads dx at once, so the
    sum is waited inside the backward that issued it, unlike the
    parameter reduces of :class:`GradReducer`.  :meth:`all_reduce_`
    issues one asynchronous all-reduce, so a chunked caller can compute
    chunk i+1 while chunk i's sum is in flight; :meth:`wait` waits on
    them in issue order.  Without a group every sum is the buffer
    itself."""

    launches = 0  # model all-reduces issued, over every reducer

    def __init__(self, group=None):
        self.group = group
        self._pending: list = []

    def all_reduce_(self, buf: torch.Tensor) -> None:
        """Sum ``buf`` over the model group in place, asynchronously."""
        if self.group is None:
            return
        self._pending.append(dist.all_reduce(
            buf, op=dist.ReduceOp.SUM, group=self.group, async_op=True))
        ModelReducer.launches += 1

    def wait(self) -> None:
        """Wait on every pending sum, in issue order."""
        pending, self._pending = self._pending, []
        for work in pending:
            work.wait()
