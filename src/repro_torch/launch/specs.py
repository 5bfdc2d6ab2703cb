"""Cell construction for the dry-run (counterpart of
``repro/launch/specs.py``).

A *cell* is one (architecture x shape x mesh) combination.  JAX builds a
cell's step and its sharded abstract arguments for the whole mesh
(``ShapeDtypeStruct``s carrying ``NamedSharding``s) and compiles it for
256 or 512 placeholder devices.  The port has no placement compiler:
:func:`build_cell` builds ONE rank of the cell, its step and its own
arguments, as tensors on the ``meta`` device by default (no memory, no
values; ``roofline/analysis.py`` counts what the step runs) or on a card
with weights drawn from a seed (``chip_smoke.py``'s phase 28).

  * :func:`input_specs` gives the cell's whole inputs as ``meta``
    tensors where JAX gives ``ShapeDtypeStruct``s, with JAX's names,
    shapes and dtypes;
  * :func:`batch_structs` gives a rank's share: the batch split over
    ``('pod', 'data')`` where the global batch divides, every row
    otherwise (``long_500k``, B = 1), as JAX's ``batch_structs`` places
    it;
  * :func:`pick_accum` and :func:`applicable` are JAX's, verbatim;
  * :func:`build_cell` gives the rank's step and arguments: prefill
    cells run ``train/serve_step.py make_prefill_step`` (the fused
    last-token prefill); decode and long cells run ``make_serve_step``,
    one token at position ``seq_len - 1`` against a ``seq_len`` cache
    (``make_cache(dp=, mp=, rank=)``, bf16 as JAX's), so the step reads
    the whole cache.  The rank's model is ``models.rank_model``: its
    blocks built from the shapes, placed over ``sharding.CountingGroup``
    stand-ins (``sharding.counting_groups``).

The rank is the mesh's origin unless ``coords`` names another.
``sharding.head_blocks`` gives the first model rank the largest head
block where the heads do not split evenly, so the origin is a rank with
the most work; the record says which rank it is.

Not built: a language model's ``train_4k`` cell.  JAX's dry-run lowers
``train_step`` for language models with ``'model'`` specs at mp 16;
the port's tensor-parallel language models serve only
(``sharding.ModelGroup`` refuses a gradient), so :func:`build_cell`
raises naming ``ROADMAP.md``'s queue A item 9.  Nor the conv family's
train cell (``conv_train_refusal``): JAX's rules replicate the conv
weights on ``'model'``, where the port's tensor-parallel conv trainer
splits the filters over it (``kernels/sharded.py``), and AtacWorks' 15
do not divide over 16; its reducers (``kernels/reduce.py``) have no
counting stand-in either (the same item).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import models
from repro_torch.configs.base import SUBQUADRATIC, ModelConfig, ShapeConfig
from repro_torch.launch.mesh import dp_size
from repro_torch.models import sharding
from repro_torch.train.serve_step import (make_cache, make_prefill_step,
                                          make_serve_step)

TRAIN_ITEM = ("training on the (data, model) mesh is ROADMAP.md queue A "
              "item 9: the port's tensor-parallel models serve only")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict[str, torch.Tensor]:
    """An empty tensor (on ``device``, ``meta`` by default: no memory)
    for every model input of this cell, JAX's names, shapes and dtypes."""
    B, T = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def t(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)
    if shape.kind == "decode":
        return {"tokens": t((B, 1), torch.int32)}
    if cfg.family == "conv":
        d = {"noisy": t((B, T), torch.float32),
             "clean": t((B, T), torch.float32),
             "peaks": t((B, T), torch.int8)}
        return d if shape.kind == "train" else {"noisy": d["noisy"]}
    t_text = T - cfg.n_image_tokens if cfg.family == "vlm" else T
    d = {"tokens": t((B, t_text), torch.int32)}
    if shape.kind == "train":
        d["labels"] = t((B, t_text), torch.int32)
    if cfg.family == "vlm":
        d["patches"] = t((B, cfg.n_image_tokens, cfg.d_model), dt)
    if cfg.family == "encdec":
        d["frames"] = t((B, cfg.encoder_width, cfg.d_model), dt)
    return d


def batch_rows(shape: ShapeConfig, mesh, coords) -> slice:
    """The rows of the global batch the rank at ``coords`` serves: its
    data row's share where the batch divides over ``('pod', 'data')``,
    every row otherwise."""
    return sharding.batch_rows(shape.global_batch, dp_size(mesh),
                               sharding.data_index(mesh, coords))


def batch_structs(cfg, shape, mesh, coords=None, device="meta"
                  ) -> dict[str, torch.Tensor]:
    """The rank's share of :func:`input_specs` (:func:`batch_rows`), as
    empty tensors on ``device``."""
    coords = _origin(mesh) if coords is None else coords
    rows = batch_rows(shape, mesh, coords)
    n = rows.stop - rows.start
    return {k: torch.empty((n, *v.shape[1:]), dtype=v.dtype, device=device)
            for k, v in input_specs(cfg, shape).items()}


def pick_accum(cfg, shape, mesh) -> int:
    """JAX's: one sample a data shard a microbatch for language-model
    train cells; 1 otherwise."""
    if shape.kind != "train":
        return 1
    if shape.microbatch:
        return max(1, shape.global_batch // shape.microbatch)
    dp = dp_size(mesh)
    if cfg.family == "conv":
        return 1
    return max(1, shape.global_batch // dp)


class Cell(NamedTuple):
    fn: Any               # the rank's step
    args: tuple           # its arguments (meta tensors by default)
    meta: dict
    groups: dict          # sharding.counting_groups of the rank


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable?  (JAX's, verbatim.)"""
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, ("long_500k needs sub-quadratic mixing; skipped for "
                       "full-attention archs")
    if cfg.family == "conv" and shape.kind != "train":
        return False, "conv net has no decode/prefill serving step"
    return True, ""


def conv_train_refusal(cfg, mesh) -> str:
    """Why the port builds no train cell of the conv family on ``mesh``."""
    mp = mesh.shape.get("model", 1)
    split = ("" if cfg.conv_channels % mp == 0 else
             f"; its {cfg.conv_channels} filters do not divide over the "
             f"model axis of {mp}, where JAX's rules replicate the conv "
             "weights")
    return ("the port's tensor-parallel conv trainer splits the filters "
            "over the model axis (kernels/sharded.py) and its reducers "
            f"(kernels/reduce.py) have no counting stand-in{split} "
            f"({TRAIN_ITEM})")


def _origin(mesh) -> dict[str, int]:
    return {a: 0 for a in mesh.axis_names}


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, coords=None, *,
               device="meta", seed: int | None = None) -> Cell:
    """One rank's step of the cell and its arguments (module docstring):
    ``(model, batch)`` for a prefill, ``(model, cache, tokens, pos)`` for
    a decode.  ``meta`` records the cell, the rank (``coords``, its data
    row's ``rows``, its head block) and the mesh."""
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell {cfg.name}x{shape.name} inapplicable: {why}")
    if shape.kind == "train":
        raise ValueError(f"cell {cfg.name}x{shape.name}: " + (
            TRAIN_ITEM if cfg.family != "conv"
            else conv_train_refusal(cfg, mesh)))
    coords = _origin(mesh) if coords is None else dict(coords)
    groups = sharding.counting_groups(mesh, coords)
    mp = mesh.shape.get("model", 1)
    model = models.rank_model(
        cfg, mesh, coords, device=device, seed=seed,
        model_group=groups["model"], data_group=groups["data"],
        batch=shape.global_batch, groups=groups["groups"])
    rows = batch_rows(shape, mesh, coords)
    meta = {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
            "mesh": dict(mesh.shape), "coords": coords,
            "rows": [rows.start, rows.stop], "attn_impl": cfg.attn_impl}
    if cfg.n_heads:
        q, kv = sharding.rank_heads(cfg, mesh, coords)
        meta["heads"] = [len(q), len(kv)]
    batch = batch_structs(cfg, shape, mesh, coords, device=device)
    if device != "meta" and seed is not None:
        g = torch.Generator().manual_seed(seed)
        for k, v in batch.items():
            if v.dtype == torch.int32:
                batch[k] = torch.randint(0, cfg.vocab_size, v.shape,
                                         generator=g, dtype=torch.int32
                                         ).to(device)
            else:
                batch[k] = torch.randn(v.shape, generator=g).to(v.dtype).to(
                    device)
    if shape.kind == "prefill":
        return Cell(make_prefill_step(cfg), (model, batch), meta, groups)
    step = make_serve_step(cfg)
    cache = make_cache(cfg, shape.global_batch, shape.seq_len,
                       dtype=torch.bfloat16, device=device,
                       dp=dp_size(mesh), mp=mp, rank=coords.get("model", 0))
    if device != "meta":
        for t in sharding.tree_leaves(cache):
            t.zero_()
    return Cell(step, (model, cache, batch["tokens"], shape.seq_len - 1),
                meta, groups)

