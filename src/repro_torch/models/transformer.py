"""The decoder-only transformer LM, dense and MoE families (counterpart
of ``repro/models/transformer.py``: StarCoder2, Qwen2, Qwen3; Moonlight).

Each layer is ``x + attn(norm(x))`` then ``x + ffn(norm(x))``, the FFN an
MLP or, in an MoE model's layers after its ``first_dense_layers``, the
MoE FFN (``models/moe.py``).  Attention is grouped-query attention with
rotary embeddings, through the flash kernels
(``kernels/flash_attention.py``) when ``cfg.attn_impl == "flash"`` and
through the plain chunked ``common.gqa_attention`` otherwise, as in the
JAX package.

Parameters are kept as the JAX package keeps them: the per-layer leaves
stacked with a leading layer axis, under ``dense_layers`` (a dense
model's every layer, an MoE model's leading dense ones, whose MLP is
``d_ff_dense`` wide) and ``moe_layers`` (``moe_layers.moe.w_gate`` is
(L_moe, E, D, F)), so the state-dict keys, shapes and AdamW's ``ndim >=
2`` decay rule are the JAX tree's, and checkpoints cross between the
packages unchanged.  The forward takes each layer's slice through one
``unbind`` per stacked leaf (see ``models/mamba2.py``).  An MoE model's
``forward`` returns ``(logits, aux)``, aux the summed load-balance loss
of its MoE layers, as JAX's does; a dense model's returns the logits
(JAX's aux is 0 there).

Decode (``init_cache``, ``decode_step``) runs one token through every
layer against a KV cache of (L, B, Tmax, KV, hd) tensors a stack, updated
in place; it runs no kernel (``common.attention_decode``, as in the JAX
package).  Not ported (ROADMAP.md queue A): the MLA layers and their
decode, and the VLM's image embeddings.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch
from torch import nn

from repro_torch.models import common as cm
from repro_torch.models import moe

PREFIX = "dense_layers."
MOE_PREFIX = "moe_layers."
# the layer stacks (and Whisper's), whose leaves are drawn a layer's slab
# at a time
STACKS = (PREFIX, MOE_PREFIX, "enc_layers.", "dec_layers.")


def norm_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """A norm's leaves, as ``common.attention_leaves``."""
    return {k: ((cfg.d_model,), "ones" if k == "scale" else "zeros", 0.0)
            for k in cm.init_norm(cfg, cfg.d_model, torch.float32)}


def layer_leaves(cfg, *, moe_layer: bool = False
                 ) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """One layer's leaves without the leading ``L``: ``attn_norm``,
    ``attn``, ``mlp_norm`` and ``mlp`` (an MoE model's dense layer: of
    ``d_ff_dense``), or ``moe`` in an MoE layer (``moe.moe_leaves``)."""
    norm = norm_leaves(cfg)
    layer = {f"attn_norm.{k}": v for k, v in norm.items()}
    layer.update({f"attn.{k}": v for k, v in cm.attention_leaves(cfg).items()})
    layer.update({f"mlp_norm.{k}": v for k, v in norm.items()})
    if moe_layer:
        layer.update({f"moe.{k}": v for k, v in moe.moe_leaves(cfg).items()})
    else:
        d_ff = cfg.d_ff if cfg.moe is None else cfg.moe.d_ff_dense
        layer.update({f"mlp.{k}": v
                      for k, v in cm.mlp_leaves(cfg, d_ff=d_ff).items()})
    return layer


def stacked_leaves(prefix: str, n: int, layer: dict) -> dict:
    """``layer``'s leaves under ``prefix``, each with a leading axis of
    ``n``."""
    return {prefix + k: ((n, *shape), *rest)
            for k, (shape, *rest) in layer.items()}


def stacks(cfg) -> list[tuple[str, int, bool]]:
    """The layer stacks in order: (prefix, layers, whether MoE); JAX's
    ``dense_layers`` then ``moe_layers``, each left out when empty."""
    n_dense = cfg.n_layers if cfg.moe is None else cfg.moe.first_dense_layers
    out = [(PREFIX, n_dense, False), (MOE_PREFIX, cfg.n_layers - n_dense,
                                      True)]
    return [s for s in out if s[1]]


def _leaf_spec(cfg) -> dict[str, tuple]:
    """Every leaf of the model: ``key -> (shape, init, scale[, dtype])``,
    the per-layer ones with their leading ``L``."""
    D = cfg.d_model
    spec = {f"embed.{k}": v for k, v in cm.embedding_leaves(cfg).items()}
    for prefix, n, moe_layer in stacks(cfg):
        spec.update(stacked_leaves(prefix, n,
                                   layer_leaves(cfg, moe_layer=moe_layer)))
    spec.update({f"final_norm.{k}": v for k, v in norm_leaves(cfg).items()})
    if not cfg.tie_embeddings:
        spec["unembed"] = ((D, cfg.padded_vocab), "normal", D ** -0.5)
    return spec


def draw_leaves(spec: dict, cfg, *, seed: int,
                device: torch.device | str) -> dict[str, torch.Tensor]:
    """``spec``'s leaves (``key -> (shape, init, scale[, dtype])``, the
    dtype defaulting to the config's) drawn on the host from ``seed`` and
    moved to ``device``.  A leaf of a layer stack (its key under
    ``STACKS``) is drawn a layer's slab at a time, each slab from a
    generator of its own seeded from the model's generator in the spec's
    order, on host threads at once (up to 8); the other leaves whole from
    the model's generator.  The weights are a function of the seed alone,
    the same on every device whatever the threads' timing, and the host
    holds one fp32 slab a thread at most (an expert leaf's slab of
    Moonlight is 185 M values, 0.74 GB): the host's normal draw is
    serial, about 120 M values a second a core."""
    gen = torch.Generator().manual_seed(seed)
    default = getattr(torch, cfg.dtype)
    leaves, slabs = {}, []
    for key, (shape, init, scale, *dt) in spec.items():
        dtype = getattr(torch, dt[0]) if dt else default
        if init != "normal":
            leaves[key] = torch.full(shape, 1.0 if init == "ones" else 0.0,
                                     dtype=dtype, device=device)
        elif key.startswith(STACKS):
            out = torch.empty(shape, dtype=dtype, device=device)
            seeds = torch.randint(0, 2 ** 62, (shape[0],), generator=gen)
            slabs += [(out[i], s, scale) for i, s in enumerate(seeds.tolist())]
            leaves[key] = out
        else:
            leaves[key] = (torch.randn(shape, generator=gen) * scale).to(
                dtype).to(device)

    def fill(job):
        slab, slab_seed, scale = job
        g = torch.Generator().manual_seed(slab_seed)
        slab.copy_(torch.randn(slab.shape, generator=g).mul_(scale).to(
            slab.dtype))

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for _ in pool.map(fill, slabs):  # reads every result: raises
            pass
    return leaves


class Transformer(nn.Module):
    """The language model; ``forward(tokens)`` is :func:`forward`.  Its
    parameters are the JAX tree's leaves under their dotted keys
    (``embed.tok``, ``dense_layers.attn.wq``, ``final_norm.scale``, ...).
    ``routing``: a ``moe.RoutingLog`` the MoE layers record their
    selection into (or replay it from), or None."""

    routing: moe.RoutingLog | None = None

    def __init__(self, cfg, leaves: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for key, t in leaves.items():
            *path, name = key.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(name, nn.Parameter(t))

    def forward(self, tokens: torch.Tensor, *, last_only: bool = False,
                hidden_only: bool = False) -> torch.Tensor:
        return forward(self, tokens, last_only=last_only,
                       hidden_only=hidden_only)


def init_params(cfg, *, seed: int = 0,
                device: torch.device | str = "cpu") -> Transformer:
    """The model with weights drawn on the host from a generator seeded
    with ``seed`` (the same weights on every device), each leaf moved to
    ``device`` as it is drawn, by the JAX package's distributions: normal
    projections scaled by fan-in ** -0.5, embeddings by 0.02, zero biases,
    unit norm scales; an MoE model's router in fp32 (``draw_leaves``)."""
    _check_family(cfg)
    return Transformer(cfg, draw_leaves(_leaf_spec(cfg), cfg, seed=seed,
                                        device=device))


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the {cfg.family!r} family's transformer is not ported to "
            "repro_torch yet: only the dense and MoE ones are (ROADMAP.md "
            "queue A)")


def _nest(keys: list[str], values) -> dict:
    """``["attn.wq", "moe.shared.w_up", ...]`` and their tensors ->
    ``{"attn": {"wq": ...}, "moe": {"shared": {"w_up": ...}}}``."""
    out: dict = {}
    for key, t in zip(keys, values):
        *path, name = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[name] = t
    return out


def _attn_half(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x + attn(norm(x))`` and its FFN's input, ``norm`` of it."""
    h = cm.apply_norm(lp["attn_norm"]["scale"], x, cfg,
                      lp["attn_norm"].get("bias"))
    x = x + cm.attention_block(lp["attn"], h, cfg, positions)
    return x, cm.apply_norm(lp["mlp_norm"]["scale"], x, cfg,
                            lp["mlp_norm"].get("bias"))


def _layer_fwd(lp: dict, x: torch.Tensor, cfg,
               positions: torch.Tensor) -> torch.Tensor:
    x, h = _attn_half(lp, x, cfg, positions)
    return x + cm.apply_mlp(lp["mlp"], h, cfg)


def _moe_layer_fwd(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                   routing, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    x, h = _attn_half(lp, x, cfg, positions)
    o, aux = moe.moe_ffn(lp["moe"], h, cfg, routing=routing, layer=layer)
    return x + o, aux


def _stacked(model: nn.Module, prefix: str = PREFIX
             ) -> tuple[list[str], list[torch.Tensor]]:
    """The per-layer leaves' keys below ``prefix`` and their stacked
    tensors."""
    pairs = [(k[len(prefix):], p) for k, p in model.named_parameters()
             if k.startswith(prefix)]
    return [k for k, _ in pairs], [p for _, p in pairs]


def _final(model: nn.Module, x: torch.Tensor, hidden_only: bool = False
           ) -> torch.Tensor:
    """The final norm, then the logits unless ``hidden_only``."""
    cfg = model.cfg
    fn = model.final_norm
    x = cm.apply_norm(fn.scale, x, cfg, getattr(fn, "bias", None))
    if hidden_only:
        return x
    return cm.logits_from_hidden(model.embed.tok,
                                 getattr(model, "unembed", None), x, cfg)


def forward(model: Transformer, tokens: torch.Tensor, *,
            last_only: bool = False, hidden_only: bool = False):
    """tokens (B, T) int -> fp32 logits (B, T, padded_vocab), the padded
    columns at ``common.NEG_INF``; for the MoE family ``(logits, aux)``,
    aux the MoE layers' load-balance losses summed (0-d fp32).
    ``last_only`` keeps the last position only (B, 1, ...);
    ``hidden_only`` returns the final-normed hidden state instead of
    logits.  With ``cfg.remat`` each layer's activations are recomputed
    in the backward.  The MoE layers record into ``model.routing``."""
    cfg = model.cfg
    x = cm.embed_tokens(model.embed.tok, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if cfg.family == "moe" else None)
    first = 0  # the stack's first layer, counted over both stacks
    for prefix, n, moe_layer in stacks(cfg):
        keys, stacked = _stacked(model, prefix)
        # keys and the layer's index bound now: remat calls the layer
        # again in the backward, after the loop has moved on
        for i, lp in enumerate(zip(*(p.unbind(0) for p in stacked))):
            if moe_layer:
                def layer(x, *leaves, keys=keys, i=first + i):
                    return _moe_layer_fwd(_nest(keys, leaves), x, cfg,
                                          positions, model.routing, i)
                x, a = cm.maybe_remat(layer, cfg)(x, *lp)
                aux = aux + a
            else:
                def layer(x, *leaves, keys=keys):
                    return _layer_fwd(_nest(keys, leaves), x, cfg, positions)
                x = cm.maybe_remat(layer, cfg)(x, *lp)
        first += n
    if last_only:
        x = x[:, -1:]
    out = _final(model, x, hidden_only)
    return (out, aux) if cfg.family == "moe" else out


# --- decode (KV cache) ---------------------------------------------------------

_CACHE_OF = {PREFIX: "dense", MOE_PREFIX: "moe"}


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu") -> dict:
    """The KV cache, the JAX package's layout: a stack's ``{"k": (L, B,
    max_len, KV, hd), "v": (...)}`` in ``dtype``, zeros, under
    ``"dense"`` and (an MoE model's) ``"moe"``."""
    _check_family(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {_CACHE_OF[prefix]: {
        k: torch.zeros((n, *shape), dtype=dtype, device=device)
        for k in ("k", "v")} for prefix, n, _ in stacks(cfg)}


def _layer_decode(lp: dict, x: torch.Tensor, cfg, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, pos: int, routing=None,
                  layer: int = 0) -> torch.Tensor:
    h = cm.apply_norm(lp["attn_norm"]["scale"], x, cfg,
                      lp["attn_norm"].get("bias"))
    x = x + cm.attention_decode(lp["attn"], h, cfg, cache_k, cache_v, pos)
    h = cm.apply_norm(lp["mlp_norm"]["scale"], x, cfg,
                      lp["mlp_norm"].get("bias"))
    if "moe" in lp:
        o, _ = moe.moe_ffn(lp["moe"], h, cfg, routing=routing, layer=layer,
                           pos=pos)
        return x + o
    return x + cm.apply_mlp(lp["mlp"], h, cfg)


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int at position ``pos`` (the
    cache's valid length) -> (fp32 logits (B, 1, padded_vocab), cache),
    each layer's k and v written into the cache at ``pos`` in place; the
    MoE layers record into ``model.routing`` (at position ``pos``)."""
    cfg = model.cfg
    _check_family(cfg)
    slots = next(iter(cache.values()))["k"].shape[2]
    if pos >= slots:
        raise ValueError(f"position {pos} is past the cache's {slots} "
                         "slots")
    x = cm.embed_tokens(model.embed.tok, tokens, cfg)
    first = 0
    for prefix, n, _ in stacks(cfg):
        keys, stacked = _stacked(model, prefix)
        c = cache[_CACHE_OF[prefix]]
        for i, (lp, ck, cv) in enumerate(zip(
                zip(*(p.unbind(0) for p in stacked)), c["k"].unbind(0),
                c["v"].unbind(0))):
            x = _layer_decode(_nest(keys, lp), x, cfg, ck, cv, pos,
                              model.routing, first + i)
        first += n
    return _final(model, x), cache
