"""The decoder-only transformer LM, dense family (counterpart of
``repro/models/transformer.py``'s dense stack: StarCoder2, Qwen2, Qwen3).

Each layer is ``x + attn(norm(x))`` then ``x + mlp(norm(x))``.  Attention
is grouped-query attention with rotary embeddings, through the flash
kernels (``kernels/flash_attention.py``) when ``cfg.attn_impl ==
"flash"`` and through the plain chunked ``common.gqa_attention``
otherwise, as in the JAX package.

Parameters are kept as the JAX package keeps them: the per-layer leaves
stacked with a leading ``L`` axis under ``dense_layers``
(``dense_layers.attn.wq`` is (L, D, H * hd)), so the state-dict keys,
shapes and AdamW's ``ndim >= 2`` decay rule are the JAX tree's, and
checkpoints cross between the packages unchanged.  The forward takes each
layer's slice through one ``unbind`` per stacked leaf (see
``models/mamba2.py``).

Decode (``init_cache``, ``decode_step``) runs one token through every
layer against a KV cache of (L, B, Tmax, KV, hd) tensors, updated in
place; it runs no kernel (``common.attention_decode``, as in the JAX
package).  Not ported (ROADMAP.md queue A): the MoE and MLA layers and
their decode, and the VLM's image embeddings.  The JAX forward also
returns the MoE auxiliary loss, which is 0 for the dense family; the
port's returns the logits only.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common as cm

PREFIX = "dense_layers."


def norm_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """A norm's leaves, as ``common.attention_leaves``."""
    return {k: ((cfg.d_model,), "ones" if k == "scale" else "zeros", 0.0)
            for k in cm.init_norm(cfg, cfg.d_model, torch.float32)}


def layer_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """One layer's leaves without the leading ``L``: ``attn_norm``,
    ``attn``, ``mlp_norm`` and ``mlp``."""
    norm = norm_leaves(cfg)
    layer = {f"attn_norm.{k}": v for k, v in norm.items()}
    layer.update({f"attn.{k}": v for k, v in cm.attention_leaves(cfg).items()})
    layer.update({f"mlp_norm.{k}": v for k, v in norm.items()})
    layer.update({f"mlp.{k}": v for k, v in cm.mlp_leaves(cfg).items()})
    return layer


def stacked_leaves(prefix: str, n: int, layer: dict) -> dict:
    """``layer``'s leaves under ``prefix``, each with a leading axis of
    ``n``."""
    return {prefix + k: ((n, *shape), init, scale)
            for k, (shape, init, scale) in layer.items()}


def _leaf_spec(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """Every leaf of the model: ``key -> (shape, init, scale)``, the
    per-layer ones with their leading ``L``."""
    D = cfg.d_model
    spec = {f"embed.{k}": v for k, v in cm.embedding_leaves(cfg).items()}
    spec.update(stacked_leaves(PREFIX, cfg.n_layers, layer_leaves(cfg)))
    spec.update({f"final_norm.{k}": v for k, v in norm_leaves(cfg).items()})
    if not cfg.tie_embeddings:
        spec["unembed"] = ((D, cfg.padded_vocab), "normal", D ** -0.5)
    return spec


def draw_leaves(spec: dict, cfg, *, seed: int,
                device: torch.device | str) -> dict[str, torch.Tensor]:
    """``spec``'s leaves drawn in its order on the host from a generator
    seeded with ``seed`` (the same weights on every device), in the
    config's dtype, each moved to ``device`` as it is drawn."""
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    leaves = {}
    for key, (shape, init, scale) in spec.items():
        if init == "normal":
            t = (torch.randn(shape, generator=gen) * scale).to(dtype)
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(shape,
                                                                dtype=dtype)
        leaves[key] = t.to(device)
    return leaves


class Transformer(nn.Module):
    """The language model; ``forward(tokens)`` is :func:`forward`.  Its
    parameters are the JAX tree's leaves under their dotted keys
    (``embed.tok``, ``dense_layers.attn.wq``, ``final_norm.scale``, ...)."""

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
    unit norm scales."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family's transformer is not ported to "
            "repro_torch yet: only the dense one is (ROADMAP.md queue A)")
    return Transformer(cfg, draw_leaves(_leaf_spec(cfg), cfg, seed=seed,
                                        device=device))


def _nest(keys: list[str], values) -> dict:
    """``["attn.wq", ...]`` and their tensors -> ``{"attn": {"wq": ...}}``."""
    out: dict = {}
    for key, t in zip(keys, values):
        group, name = key.split(".")
        out.setdefault(group, {})[name] = t
    return out


def _layer_fwd(lp: dict, x: torch.Tensor, cfg,
               positions: torch.Tensor) -> torch.Tensor:
    h = cm.apply_norm(lp["attn_norm"]["scale"], x, cfg,
                      lp["attn_norm"].get("bias"))
    x = x + cm.attention_block(lp["attn"], h, cfg, positions)
    h = cm.apply_norm(lp["mlp_norm"]["scale"], x, cfg,
                      lp["mlp_norm"].get("bias"))
    return x + cm.apply_mlp(lp["mlp"], h, cfg)


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
            last_only: bool = False, hidden_only: bool = False
            ) -> torch.Tensor:
    """tokens (B, T) int -> fp32 logits (B, T, padded_vocab), the padded
    columns at ``common.NEG_INF``.  ``last_only`` keeps the last position
    only (B, 1, ...); ``hidden_only`` returns the final-normed hidden state
    instead of logits.  With ``cfg.remat`` each layer's activations are
    recomputed in the backward."""
    cfg = model.cfg
    x = cm.embed_tokens(model.embed.tok, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    keys, stacked = _stacked(model)

    def layer(x, *leaves):
        return _layer_fwd(_nest(keys, leaves), x, cfg, positions)

    step = cm.maybe_remat(layer, cfg)
    for lp in zip(*(p.unbind(0) for p in stacked)):
        x = step(x, *lp)
    if last_only:
        x = x[:, -1:]
    return _final(model, x, hidden_only)


# --- decode (KV cache) ---------------------------------------------------------

def _check_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family's decode path (MoE, MLA) is not "
            "ported to repro_torch yet: only the dense one is (ROADMAP.md "
            "queue A)")


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu") -> dict:
    """The KV cache, the JAX package's layout: ``{"dense": {"k": (L, B,
    max_len, KV, hd), "v": (...)}}`` in ``dtype``, zeros."""
    _check_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"dense": {k: torch.zeros(shape, dtype=dtype, device=device)
                      for k in ("k", "v")}}


def _layer_decode(lp: dict, x: torch.Tensor, cfg, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, pos: int) -> torch.Tensor:
    h = cm.apply_norm(lp["attn_norm"]["scale"], x, cfg,
                      lp["attn_norm"].get("bias"))
    x = x + cm.attention_decode(lp["attn"], h, cfg, cache_k, cache_v, pos)
    h = cm.apply_norm(lp["mlp_norm"]["scale"], x, cfg,
                      lp["mlp_norm"].get("bias"))
    return x + cm.apply_mlp(lp["mlp"], h, cfg)


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int at position ``pos`` (the
    cache's valid length) -> (fp32 logits (B, 1, padded_vocab), cache),
    each layer's k and v written into the cache at ``pos`` in place."""
    cfg = model.cfg
    _check_dense(cfg)
    if pos >= cache["dense"]["k"].shape[2]:
        raise ValueError(f"position {pos} is past the cache's "
                         f"{cache['dense']['k'].shape[2]} slots")
    x = cm.embed_tokens(model.embed.tok, tokens, cfg)
    keys, stacked = _stacked(model)
    layer_caches = zip(cache["dense"]["k"].unbind(0),
                       cache["dense"]["v"].unbind(0))
    for lp, (ck, cv) in zip(zip(*(p.unbind(0) for p in stacked)),
                            layer_caches):
        x = _layer_decode(_nest(keys, lp), x, cfg, ck, cv, pos)
    return _final(model, x), cache
