"""Model registry of the port (counterpart of ``repro/models/__init__.py``):
``get_model(cfg)`` returns the module that builds the config's family, and
``init_model`` builds the model of any ported family from a seed.

Every language-model family is ported: the SSM family (Mamba2), the
dense transformers, the MoE transformers (Moonlight; DeepSeek-V3, whose
attention is MLA, ``models/mla.py``), the VLM (InternVL2: the dense
transformer behind image embeddings), the encoder-decoder (Whisper) and
the hybrid (Zamba2), each module with the
functional surface of the JAX package's (``repro/models/__init__.py``),
the model an ``nn.Module``:

    init_params(cfg, *, seed, device) -> model
    forward(model, tokens, *, last_only=False, ...) -> logits
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    decode_step(model, cache, tokens, pos) -> (logits, cache)

(an MLA model's ``decode_step`` also takes ``absorb``)

An MoE model's ``forward`` returns ``(logits, aux)``, aux its summed
load-balance loss, as the JAX package's ``forward`` does for every
family.

``decode_step`` updates the cache in place and returns it.  A VLM's
``forward`` also takes the image embeddings, ``extra_embeds``.  Whisper's
``forward`` also takes the encoder's ``frames``, its ``init_cache`` an
``enc_len``, and ``whisper.fill_cross_cache`` fills the cross-attention
K/V before the first decode step.  The conv family's model is
``repro_torch.core.blocks``, which serves through ring-buffer streaming
instead of a cache.

Every language-model family serves on JAX's serve launcher's ``(dp,
mp)`` host mesh: ``local_model`` gives a rank its 2-D blocks
(``models/sharding.py``), its model group and, for dp > 1, its
``sharding.DataShards``, and each family's ``forward`` and
``decode_step`` gather a layer's column block over the data group where
the layer runs and run the model group's collectives on it; its
``init_cache`` takes ``mp=`` and a data row's batch.  Every one trains
FSDP on a data group: ``fsdp_model`` gives a rank its blocks on a (dp,
1) mesh and its ``sharding.DataShards``, and each family's ``forward``
gathers the whole leaves where it reads them.
"""
from __future__ import annotations


def get_model(cfg):
    """The model module of ``cfg.family`` (the surface above)."""
    if cfg.family == "ssm":
        from repro_torch.models import mamba2
        return mamba2
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "encdec":
        from repro_torch.models import whisper
        return whisper
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        return zamba2
    raise ValueError(f"unknown family {cfg.family!r}")


def model_class(cfg):
    """The ``nn.Module`` class of the config's language model, built as
    ``model_class(cfg)(cfg, leaves)`` from a state dict of its leaves."""
    mod = get_model(cfg)
    return getattr(mod, {"ssm": "Mamba2", "hybrid": "Zamba2",
                         "encdec": "Whisper"}.get(cfg.family, "Transformer"))


def init_model(cfg, *, seed: int = 0, device="cpu"):
    """The ``nn.Module`` of the config's family with seeded weights: the
    AtacWorks stack for ``conv``, the language model otherwise."""
    if cfg.family == "conv":
        from repro_torch.core import blocks
        return blocks.init_params(cfg, seed=seed, device=device)
    return get_model(cfg).init_params(cfg, seed=seed, device=device)


def leaf_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """key -> shape of every leaf of the config's language model, read
    from the family's leaf specs without drawing a value."""
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models import mamba2, zamba2
        shapes = mamba2.leaf_shapes(cfg)
        if cfg.family == "hybrid":
            shapes.update({f"shared.{k}": v[0] for k, v in
                           zamba2.shared_leaves(cfg).items()})
        return shapes
    return {k: v[0] for k, v in get_model(cfg)._leaf_spec(cfg).items()}


def leaf_spec(cfg) -> dict[str, tuple]:
    """key -> ``(shape, init, scale, dtype)`` of every leaf of the
    config's language model, without drawing: ``init`` is ``"normal"``
    (times ``scale``), ``"zeros"`` or ``"ones"``, or for an SSM model's
    ``dt_bias`` and ``A_log`` their own name (``mamba2.draw_leaves``);
    ``dtype`` a ``torch.dtype``.  An SSM model's entries restate
    ``mamba2.draw_leaves``' distributions, which draws whole leaves."""
    import torch
    default = getattr(torch, cfg.dtype)
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models import zamba2
        shapes = leaf_shapes(cfg)
        D = cfg.d_model
        d_inner = cfg.ssm.expand * D
        init = {"embed.tok": ("normal", 0.02),
                "layers.mixer.in_proj": ("normal", D ** -0.5),
                "layers.mixer.conv_w": ("normal", cfg.ssm.conv_width ** -0.5),
                "layers.mixer.conv_b": ("zeros", 0.0),
                "layers.mixer.dt_bias": ("dt_bias", 0.0),
                "layers.mixer.A_log": ("A_log", 0.0),
                "layers.mixer.out_proj": ("normal", d_inner ** -0.5),
                "unembed": ("normal", D ** -0.5)}
        fp32 = ("layers.mixer.dt_bias", "layers.mixer.A_log",
                "layers.mixer.D")
        spec = {k: (s, *init.get(k, ("ones", 0.0)),
                    "float32" if k in fp32 else cfg.dtype)
                for k, s in shapes.items() if not k.startswith("shared.")}
        if cfg.family == "hybrid":
            spec.update({f"shared.{k}": v for k, v in
                         zamba2.shared_leaves(cfg).items()})
    else:
        spec = get_model(cfg)._leaf_spec(cfg)
    return {k: (tuple(shape), init, scale,
                getattr(torch, dt[0]) if dt else default)
            for k, (shape, init, scale, *dt) in spec.items()}


def rank_shapes(cfg, mesh, coords) -> dict[str, tuple[int, ...]]:
    """key -> the shape of the block of each leaf that the device at
    ``coords`` of ``mesh`` holds (what ``sharding.local_state_dict(...,
    cfg=)`` cuts from the whole leaf), from the shapes alone: its model
    column's block (``sharding.model_block_shape``: head- and
    segment-aligned) with the data-split dimension divided over its data
    axes (``sharding.fsdp_dims``)."""
    from repro_torch.models import sharding
    shapes = leaf_shapes(cfg)
    specs, dims = sharding.fsdp_dims(shapes, mesh)
    out = {}
    for k, s in shapes.items():
        b = list(sharding.model_block_shape(k, s, specs[k], mesh, cfg,
                                            coords))
        if dims[k] is not None:
            b[dims[k]] //= sharding.data_parts(specs[k][dims[k]], mesh)[0]
        out[k] = tuple(b)
    return out


def rank_model(cfg, mesh, coords, *, device="meta", seed: int | None = None,
               model_group=None, data_group=None, batch=None, groups=None):
    """The serving model of the rank at ``coords`` of ``mesh`` built from
    the shapes (``rank_shapes``), with no whole leaf drawn: on ``meta``
    (or with no ``seed``) empty blocks, which cost no memory there; on a
    real device each block drawn there from its own generator, seeded
    from ``seed`` and the leaf's place in ``leaf_spec`` (the JAX
    package's distributions; an SSM model's small ``dt_bias`` and
    ``A_log`` computed whole and cut).  The weights are a function of the
    seed and the layout, not those of ``init_model`` at the same seed.
    Then placed by :func:`place_rank` over the groups given (for a
    dry-run, ``sharding.counting_groups``)."""
    import math

    import torch

    from repro_torch.models import sharding
    spec, shapes = leaf_spec(cfg), rank_shapes(cfg, mesh, coords)
    device = torch.device(device)
    draw = seed is not None and device.type != "meta"
    leaves = {}
    for i, (k, (whole, init, scale, dtype)) in enumerate(spec.items()):
        shape = shapes[k]
        if not draw:
            leaves[k] = torch.empty(shape, dtype=dtype, device=device)
        elif init == "normal":
            g = torch.Generator(device=device).manual_seed(
                seed * 1_000_003 + i)
            leaves[k] = (torch.randn(shape, generator=g, device=device)
                         * scale).to(dtype)
        elif init in ("zeros", "ones"):
            leaves[k] = torch.full(shape, float(init == "ones"),
                                   dtype=dtype, device=device)
        else:  # an SSM's per-head constants: (L, H), whole then cut
            s = cfg.ssm
            L, H = whole
            if init == "A_log":
                t = torch.log(torch.arange(1, H + 1, dtype=torch.float32)
                              ).repeat(L, 1)
            else:
                g = torch.Generator().manual_seed(seed * 1_000_003 + i)
                dt = torch.exp(torch.rand((L, H), generator=g)
                               * (math.log(s.dt_max) - math.log(s.dt_min))
                               + math.log(s.dt_min))
                t = dt + torch.log(-torch.expm1(-dt))
            leaves[k] = sharding.local_state_dict(
                {k: t}, mesh, coords, device=device, cfg=cfg)[k].to(dtype)
        if tuple(leaves[k].shape) != shape:
            raise ValueError(f"{k}: drew {tuple(leaves[k].shape)}, the "
                             f"rank holds {shape}")
    return place_rank(model_class(cfg)(cfg, leaves), mesh, coords,
                      model_group, data_group, batch, groups)


def local_model(model, mesh, coords, model_group, device=None,
                data_group=None, batch=None):
    """A rank's serving model of any language-model family on ``mesh``
    (JAX's serve launcher's ``(world / mp, mp)`` host mesh): a model of
    ``model``'s class and config whose leaves are the blocks the device
    at ``coords`` holds (``sharding.local_state_dict(..., cfg=)``: JAX's
    2-D blocks, an SSM model's fused leaves segment-aligned and the
    attention's leaves head-aligned on ``'model'``), on ``device``
    (default: where they are), placed by :func:`place_rank`."""
    from repro_torch.models import sharding
    cfg = model.cfg
    return place_rank(type(model)(cfg, sharding.local_state_dict(
        model, mesh, coords, device=device, cfg=cfg)), mesh, coords,
        model_group, data_group, batch)


def place_rank(model, mesh, coords, model_group, data_group=None,
               batch=None, groups=None):
    """Give ``model``, whose leaves are the 2-D blocks the device at
    ``coords`` of ``mesh`` holds (``local_model``, or
    ``convert.params_from_jax(..., mesh=, coords=, cfg=)``), the groups
    it serves over; returns it.

    Its ``tp`` is the ``sharding.ModelGroup`` of ``model_group`` (None on
    a model axis of one).  On a data axis of more than one rank its
    ``ds`` is the ``sharding.DataShards`` of ``data_group`` over the
    mesh: each family's ``forward`` and ``decode_step`` gather over the
    data group, where a layer runs, the block its model column executes
    (its own head-aligned shapes, ``sharding.model_block_shape``, the same
    on every rank of the data group),
    then run the model group's sums and gathers on it; no gathered weight
    outlives its layer, so a rank's memory holds its 2-D blocks and one
    layer's column block at a time.  An MoE model's ``expert_ids`` are
    the experts its column runs (``sharding.expert_ids``; None: all);
    its ``data_group``, over whose global batch the capacity dispatch
    drops, is ``data_group`` where ``batch`` (the global batch served;
    None: a split one) splits over the data rows
    (``sharding.batch_splits``), None where every data row serves the
    whole batch.  On a mesh with a ``'pod'`` axis the data group is the
    column's ``('pod', 'data')`` ranks and ``groups`` gives the group of
    its pod's data ranks, ``{("data",): group}``, over which the expert
    stacks are split (``sharding.DataShards``).  A group may be a
    ``sharding.CountingGroup`` (a dry-run's rank, ``rank_model``)."""
    from repro_torch.models import sharding
    cfg = model.cfg
    dp = sharding.data_size(mesh)
    shapes = leaf_shapes(cfg)
    model.tp = None if model_group is None else sharding.ModelGroup(
        model_group)
    if dp > 1:
        model.ds = sharding.DataShards(data_group, shapes, mesh, coords, cfg,
                                       groups=groups)
    if cfg.moe is not None:
        key = next(k for k in shapes if k.endswith("moe.w_gate"))
        ids = sharding.expert_ids(cfg.moe.n_experts,
                                  sharding.param_pspecs(shapes, mesh)[key][1],
                                  mesh, coords)
        model.expert_ids = None if ids == list(range(cfg.moe.n_experts)) \
            else ids
        if dp > 1 and (batch is None or sharding.batch_splits(batch, dp)):
            model.data_group = data_group
    return model


def fsdp_model(model, group, device=None):
    """An FSDP rank's language model (JAX's launcher's placement on a
    ``(dp, 1)`` mesh): a model of ``model``'s class and config whose
    leaves are this rank's blocks of ``model``'s (whole) leaves
    (``sharding.DataShards`` over the data group ``group``), on
    ``device`` (default: where they are), its ``ds`` that
    ``DataShards``; each family's forward gathers the whole leaves where
    it reads them."""
    from repro_torch.models import sharding
    ds = sharding.DataShards(group, model)
    out = type(model)(model.cfg, sharding.local_state_dict(
        model, ds.mesh, ds.coords, device=device))
    out.ds = ds
    if model.cfg.moe is not None:  # the load-balance loss's global batch
        out.data_group = group
    return out


def fsdp_template(model, cfg, group, device):
    """An uninitialised model of ``model``'s class under ``cfg`` whose
    leaves (of ``model``'s dtypes) are this rank's blocks over the data
    group ``group`` (whole for None), on ``device``: what a checkpoint
    restores into once the data axis has changed."""
    import torch

    from repro_torch.models import sharding
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    shapes = leaf_shapes(cfg)
    ds = None if group is None else sharding.DataShards(group, shapes)
    out = type(model)(cfg, {k: torch.empty(
        shapes[k] if ds is None else ds.block_shape(k), dtype=dtypes[k],
        device=device) for k in shapes})
    out.ds = ds
    if cfg.moe is not None:
        out.data_group = group
    return out
