"""Data-parallel gradients over a ``torch.distributed`` group (counterpart
of ``repro/train/data_parallel.py``): the paper's data-parallel AtacWorks
training, one process per card.

``make_sharded_grad_fn`` returns the step's gradient engine,
``grad_fn(model, batch) -> ((loss, aux), grads)``, run by every rank on
its own share of the global batch (``SyntheticLoader(rank=, world=)`` or
:func:`shard_batch`):

  * the local loss is scaled by 1/dp before the backward, so the summed
    gradients ARE the gradients of the global mean loss (equal shards make
    the mean of the local means the global mean), with no rescale after;
  * the conv family threads a per-step ``kernels.reduce.GradReducer`` into
    every layer (``grad_reduce``), so each layer's (dw, dbias) all-reduce
    is issued, asynchronously, right after its bwd-weight pass, free to
    run while the layers before it compute their backward; the reducer
    waits before the gradients are handed back, and also when the
    backward raises, so a failed step leaves nothing in flight;
  * the other families all-reduce the whole gradient list after the
    backward: correct, not overlapped, as in the JAX package's
    ``shard_map`` path; or, on an FSDP rank (``models.fsdp_model``:
    ``model.ds``, the placement JAX's launcher trains them with), each
    layer's blocks are gathered in its forward and its gradients
    reduce-scattered back to the blocks as its backward ends
    (``models/sharding.py DataShards``), and only the whole leaves (norm
    scales, biases, leaves with no split dimension) are all-reduced
    after the backward;
  * the loss and aux come back as their global means, and the gradients
    are equal on every rank.

Each rank traces the model at its local batch, so a ``backend="auto"``
conv resolves its plan from the local problem (N / dp).  A world of 1
(``group=None``) is the single-process gradient.

On a (data, model) layout (``launch.mesh.init_mesh``) with a model group
of mp > 1 ranks (conv family only), every layer whose filter count
divides is also K-sharded over the model group (``blocks.forward``): the
mp ranks of a model group hold the same data shard, so the loss is still
scaled by 1/dp, not 1/(dp x mp); each layer's dx is summed over the model
group inside its backward; every layer's (dw, dbias) is summed over the
data group as above, and a sharded layer's summed block is then
zero-padded and summed over the model group through the same per-step
``GradReducer``, after the data sum (JAX's order).  The heads (K=1 < mp)
run replicated.  Parameters and gradients stay whole and equal on every
rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.kernels.reduce import (GradReducer, dp_rank, dp_size,
                                        mp_size)
from repro_torch.train.losses import make_loss_fn


def param_grads(loss: torch.Tensor, params) -> tuple[torch.Tensor, ...]:
    """The gradients of ``loss`` to ``params``, zeros (in the parameter's
    dtype) for a parameter the loss does not read, as JAX's ``grad`` gives
    (Whisper's conv frontend; AdamW then decays its matrices, as in
    JAX)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params))


def shard_batch(batch: dict, group) -> dict:
    """This rank's contiguous share of a global batch (every leaf sliced
    on its leading axis); the global batch must divide over the ranks."""
    dp, r = dp_size(group), dp_rank(group)
    n = next(iter(batch.values())).shape[0]
    if n % dp:
        raise ValueError(
            f"batch {n} does not divide over {dp} data-parallel shards; pad "
            "or re-batch the input")
    m = n // dp
    return {k: v[r * m:(r + 1) * m] for k, v in batch.items()}


def make_sharded_grad_fn(cfg, group, *, loss_fn=None,
                         grad_reduce_chunks: int | None = None,
                         model_group=None,
                         model_reduce_chunks: int | None = None):
    """``grad_fn(model, batch) -> ((loss, aux), grads)`` over the data group
    ``group`` (None: a world of 1), ``grads`` a tuple in
    ``model.named_parameters()`` order.  ``batch`` is this rank's share;
    ``grad_fn(..., probe=)`` marks the end of the forward and of the
    backward on a ``train_step.PhaseProbe``.  Making it logs the
    ``train.mesh`` event (dp, mp) when telemetry is on.

    ``loss_fn(model, batch) -> (loss, aux)`` replaces the family's loss
    (``make_loss_fn``); its gradients are then all-reduced as a whole
    after the backward, as the non-conv families' are.
    ``grad_reduce_chunks`` > 1 (conv family) reduces each layer in that
    many width ranges, as ``kernels/ops.py`` describes.  A group of one
    rank still issues every reduce (the identity), so a one-card run
    exercises the collective path.

    ``model_group`` (this rank's model group from ``launch.mesh.init_mesh``,
    None: mp = 1) of mp > 1 ranks turns on tensor parallelism (conv
    family, default loss only; module docstring), with
    ``model_reduce_chunks`` column ranges to each layer's dx sum.
    Requires cfg.conv_channels % mp == 0 and the world to be the dp x mp
    ranks."""
    dp, mp = dp_size(group), mp_size(model_group)
    fused_reduce = cfg.family == "conv" and loss_fn is None
    reducer = GradReducer(group)
    if mp > 1:
        if cfg.family != "conv":
            raise ValueError(
                f"model-parallel grad fn supports the conv family only "
                f"(cfg family is {cfg.family!r}); the language models' "
                "parameter sharding waits in ROADMAP.md queue A")
        if loss_fn is None and cfg.conv_channels % mp:
            raise ValueError(
                f"conv_channels={cfg.conv_channels} does not divide over "
                f"mp={mp} model shards: every body layer has "
                f"K=C={cfg.conv_channels} filters, so C % mp must be 0; "
                "pick a divisible channel count (atacworks-bf16 has 16) "
                "or lower the model axis")
        if dist.get_world_size() != dp * mp:
            raise ValueError(f"the world has {dist.get_world_size()} ranks, "
                             f"not dp x mp = {dp} x {mp}")
    if fused_reduce:
        loss_fn = make_loss_fn(cfg, grad_reduce=reducer,
                               grad_reduce_chunks=grad_reduce_chunks,
                               model_group=model_group,
                               model_reduce_chunks=model_reduce_chunks)
    loss_fn = loss_fn or make_loss_fn(cfg)
    # the layout, for the report's mesh line (JAX logs it here too)
    obs.event("train.mesh", dp=dp, mp=mp, axes="data,model")

    def grad_fn(model, batch, probe=None):
        names, params = zip(*model.named_parameters())
        shards = getattr(model, "ds", None)
        if shards is not None and (group is None or shards.group != group):
            raise ValueError("an FSDP model's blocks are over another data "
                             "group than the gradient function's")
        loss, aux = loss_fn(model, batch)
        if probe is not None:
            probe.mark("forward")
        # 1/dp before the backward: the summed gradients are the gradients
        # of the global mean loss
        try:
            grads = param_grads(loss / dp, params)
            if not fused_reduce:
                # one buffer per leaf (autograd may hand one tensor to two);
                # an FSDP rank's blocks were reduce-scattered in the backward
                out, seen = [], set()
                for name, g in zip(names, grads):
                    if shards is not None and shards.split(name):
                        out.append(g)
                        continue
                    if id(g) in seen or not g.is_contiguous():
                        g = g.clone(memory_format=torch.contiguous_format)
                    seen.add(id(g))
                    reducer.all_reduce_(g)
                    out.append(g)
                grads = tuple(out)
        finally:
            # every gradient is read below this line, and only after the
            # wait; a backward that raised leaves no claim or reduce behind
            reducer.wait()
        if probe is not None:
            probe.mark("backward")
        keys = sorted(aux)
        metrics = torch.stack([loss.detach().float()]
                              + [aux[k].detach().float() for k in keys])
        if group is not None:
            metrics = metrics / dp
            dist.all_reduce(metrics, group=group)
        loss = metrics[0]
        aux = {k: metrics[i + 1] for i, k in enumerate(keys)}
        return (loss, aux), grads

    grad_fn.reducer = reducer  # empty between calls
    return grad_fn
