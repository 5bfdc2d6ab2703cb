"""State across the two packages: the JAX package's parameter tree, or its
whole ``TrainState``, given as numpy arrays, becomes the port's.

The tree's nesting of dicts and lists maps onto dotted state-dict keys
(``{"res": [{"conv1": {"w": ...}}]}`` -> ``"res.0.conv1.w"``), which is how
``core.blocks.AtacWorks`` and ``models.mamba2.Mamba2`` name their
parameters.  Mamba2's per-layer leaves keep the JAX tree's leading ``L``
axis in the port (``layers.mixer.in_proj`` is (L, D, d_proj) in both), as
the transformers' do (Whisper's ``enc_layers.attn.wq`` (L_enc, D, H * hd),
``dec_layers.cross.wk`` (L, D, H * hd), beside ``embed.pos`` and
``frontend.conv1_w`` (3, D, 128)), and Zamba2's (its Mamba2 leaves under
``layers.`` beside the shared block's ``shared.wq`` (2·D, H * hd) and
``shared.mlp.w_gate``) and an MoE model's (``dense_layers.mlp.w_gate``
(L_dense, D, d_ff_dense), ``moe_layers.moe.w_gate`` (L_moe, E, D, F),
``moe_layers.moe.shared.w_up``, and ``moe_layers.moe.router`` (L_moe,
D, E) and ``router_bias``, fp32 in a bf16 tree and kept so; an MLA
model's ``dense_layers.attn.kv_up`` (L_dense, kv_lora, H * (nope + v))
beside ``q_down``, ``q_norm``, ``q_up``, ``kv_down``, ``kv_norm``,
``wo``; a VLM's tree is the dense one, ``dense_layers.`` with an untied
``unembed``: the image embeddings are an input, not a leaf), so nothing
is split or joined::

    model.load_state_dict(params_from_jax(jax_tree_as_numpy))
    state = train_state_from_jax(jax_train_state_as_numpy, cfg)

A decode cache keeps its nesting (``cache_from_jax``): the port's caches
are the JAX package's trees of the same layouts.

Given a ``models.sharding.MeshShape``, a device's coordinates on it and
the model's config, both give the blocks that device executes instead
(a tensor-parallel rank's): ``params_from_jax`` by the parameter rules
(``sharding.local_state_dict(..., cfg=)``), ``cache_from_jax`` by
``sharding.cache_pspecs``, except that an MLA model's latent ``c_kv``
stays whole over ``'model'`` (``models/mla.py``), an SSM model's fused
leaves and conv state take their segment-aligned blocks
(``sharding.segment_block``), and the attention's leaves and the
cache's K and V their head-aligned ones (``sharding.head_blocks``: whole
KV heads, where JAX's ``cache_pspecs`` splits the head_dim of KV heads
that do not divide over ``'model'``), as ``models.local_model`` and
``init_cache(mp=, rank=)`` lay them out, and ``models.place_rank`` gives
the model its groups (and an MoE model its expert ids)::

    model = models.place_rank(models.model_class(cfg)(cfg, params_from_jax(
        tree, mesh=m, coords=c, cfg=cfg)), m, c, model_group)
    cache = cache_from_jax(jax_cache, mesh=m, coords=c, cfg=cfg)

On JAX's serve launcher's ``(dp, mp)`` host mesh the same calls give a
rank's 2-D blocks (every ``'dp'`` dimension split over the data rows)
and a data row's rows of the cache (the batch on ``'data'`` where it
divides); ``place_rank(..., data_group=, batch=)`` then sets the model's
``ds``.

``train_state_from_jax(state, cfg, group=data_group)`` gives an FSDP
rank's state: its blocks of the parameters and of both moments on a
``(dp, 1)`` mesh, the model's ``ds`` set (``models.fsdp_model``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import (fsdp_model, init_model, model_class,
                                sharding)
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.train_step import TrainState


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes) has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, prefix: str = "", *, mesh=None, coords=None,
                    cfg=None) -> dict[str, torch.Tensor]:
    """Flatten a parameter tree of dicts, lists and arrays into a state
    dict of CPU tensors (same values and dtypes); with ``mesh`` and
    ``coords``, each leaf's block that the device there executes
    (``sharding.local_state_dict``; an SSM model's needs ``cfg``)."""
    if mesh is not None:
        return sharding.local_state_dict(params_from_jax(tree, prefix),
                                         mesh, coords, cfg=cfg)
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _tensor(tree)}
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(params_from_jax(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


# a cache's head-carrying leaves: the self-attention's K and V hold KV
# heads, Whisper's cross K and V every query head's
CACHE_HEADS = {"k": "kv", "v": "kv", "cross_k": "q", "cross_v": "q"}


def cache_from_jax(tree, *, device: torch.device | str = "cpu", mesh=None,
                   coords=None, cfg=None):
    """A JAX decode cache (its leaves as numpy arrays) as the port's: the
    same nesting of dicts, each leaf a tensor of its own with the same
    layout and dtype (Mamba2 ``{"conv": (L, B, S-1, conv_dim), "ssm": (L,
    B, H, N, P)}``, dense ``{"dense": {"k"|"v": (L, B, Tmax, KV, hd)}}``,
    Whisper ``{"k"|"v": (L, B, Tmax, KV, hd), "cross_k"|"cross_v": (L, B,
    Te, H, hd)}``, its cross K/V filled or not; Zamba2 ``{"mamba": {"conv",
    "ssm"}, "k"|"v": (n_app, B, Tmax, KV, hd)}``; MoE ``{"dense"|"moe":
    {"k"|"v": (L_stack, B, Tmax, KV, hd)}}``, with MLA ``{"dense"|"moe":
    {"c_kv": (L_stack, B, Tmax, kv_lora), "k_rope": (L_stack, B, Tmax,
    rope)}}``), so ``decode_step`` may write into it.  With ``mesh`` and
    ``coords``, the device's blocks (the module docstring; an SSM
    model's need ``cfg``)."""
    if mesh is not None:
        cache = cache_from_jax(tree)
        batch = next(sharding.tree_leaves(cache)).shape[1]
        specs = sharding.cache_pspecs(cache, mesh, batch)

        def block(c, s, name=None):
            if isinstance(c, dict):
                return {k: block(c[k], s[k], k) for k in c}
            if name == "c_kv":  # whole over 'model': each head reads it
                s = tuple(None if e == "model" else e for e in s)
            if name in CACHE_HEADS and cfg is not None:
                # whole KV heads (query heads of the cross K/V), the rank's
                # head block, where JAX may split the head_dim
                q, kv = sharding.rank_heads(cfg, mesh, coords)
                heads = ((kv, cfg.n_kv_heads) if CACHE_HEADS[name] == "kv"
                         else (q, cfg.n_heads))
                s = tuple(None if e == "model" else e for e in s)
                b = sharding.head_block(sharding.local_block(
                    c, s, mesh, coords), c.dim() - 2, *heads)
            elif name == "conv" and cfg is not None and cfg.ssm is not None:
                # segment-aligned over 'model', as init_cache(mp=) has it
                *lead, last = s
                parts, index = sharding.split_index(last, mesh, coords)
                b = sharding.segment_block(
                    sharding.local_block(c, (*lead, None), mesh, coords),
                    sharding.ssm_segments(cfg, "conv", parts), parts, index)
            else:
                b = sharding.local_block(c, s, mesh, coords)
            return b.contiguous().to(device)
        return block(cache, specs)
    if isinstance(tree, dict):
        return {k: cache_from_jax(v, device=device) for k, v in tree.items()}
    return _tensor(tree).to(device)


def train_state_from_jax(state, cfg, *,
                         device: torch.device | str = "cpu", mesh=None,
                         coords=None, group=None) -> TrainState:
    """The JAX ``TrainState`` (params, AdamW moments and count, step; its
    leaves as numpy arrays) as the port's, on ``device``.  With ``mesh``
    and ``coords``, a device's blocks of the parameters and of both
    moments (``params_from_jax``); with ``group`` (a data group), this
    rank's blocks on the ``(dp, 1)`` mesh of an FSDP rank, the model's
    ``ds`` its ``sharding.DataShards``."""
    if group is not None:
        model = fsdp_model(model_class(cfg)(cfg, params_from_jax(
            state.params)), group, device)
        mesh, coords = model.ds.mesh, model.ds.coords

    def leaves(tree):
        return {k: t.to(device) for k, t in params_from_jax(
            tree, mesh=mesh, coords=coords, cfg=cfg).items()}

    if mesh is None:
        model = init_model(cfg, device=device)
        model.load_state_dict(params_from_jax(state.params))
    elif group is None:
        model = model_class(cfg)(cfg, leaves(state.params))
    opt = AdamWState(m=leaves(state.opt.m), v=leaves(state.opt.v),
                     count=_tensor(state.opt.count).to(device, torch.int32))
    return TrainState(params=model, opt=opt,
                      step=_tensor(state.step).to(device, torch.int32))
