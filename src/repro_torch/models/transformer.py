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

Not ported (ROADMAP.md queue A): the MoE and MLA layers, the VLM's image
embeddings, and the decode path (``init_cache``, ``decode_step``), which
runs no kernel.  The JAX forward also returns the MoE auxiliary loss,
which is 0 for the dense family; the port's returns the logits only.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common as cm

PREFIX = "dense_layers."


def _leaf_spec(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """Every leaf of the model: ``key -> (shape, init, scale)``, the
    per-layer ones with their leading ``L``."""
    L, D = cfg.n_layers, cfg.d_model
    norm = {k: ((D,), "ones" if k == "scale" else "zeros", 0.0)
            for k in cm.init_norm(cfg, D, torch.float32)}
    layer = {f"attn_norm.{k}": v for k, v in norm.items()}
    layer.update({f"attn.{k}": v for k, v in cm.attention_leaves(cfg).items()})
    layer.update({f"mlp_norm.{k}": v for k, v in norm.items()})
    layer.update({f"mlp.{k}": v for k, v in cm.mlp_leaves(cfg).items()})
    spec = {"embed.tok": ((cfg.padded_vocab, D), "normal", 0.02)}
    spec.update({PREFIX + k: ((L, *shape), init, scale)
                 for k, (shape, init, scale) in layer.items()})
    spec.update({f"final_norm.{k}": v for k, v in norm.items()})
    if not cfg.tie_embeddings:
        spec["unembed"] = ((D, cfg.padded_vocab), "normal", D ** -0.5)
    return spec


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
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    leaves = {}
    for key, (shape, init, scale) in _leaf_spec(cfg).items():
        if init == "normal":
            t = (torch.randn(shape, generator=gen) * scale).to(dtype)
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(shape,
                                                                dtype=dtype)
        leaves[key] = t.to(device)
    return Transformer(cfg, leaves)


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
    stacked = [(k[len(PREFIX):], p) for k, p in model.named_parameters()
               if k.startswith(PREFIX)]
    keys = [k for k, _ in stacked]

    def layer(x, *leaves):
        return _layer_fwd(_nest(keys, leaves), x, cfg, positions)

    step = cm.maybe_remat(layer, cfg)
    for lp in zip(*(p.unbind(0) for _, p in stacked)):
        x = step(x, *lp)
    if last_only:
        x = x[:, -1:]
    fn = model.final_norm
    x = cm.apply_norm(fn.scale, x, cfg, getattr(fn, "bias", None))
    if hidden_only:
        return x
    return cm.logits_from_hidden(model.embed.tok,
                                 getattr(model, "unembed", None), x, cfg)


def init_cache(*_, **__):
    raise NotImplementedError(
        "the transformer's decode path (init_cache, decode_step) is not "
        "ported to repro_torch yet: it runs no kernel (ROADMAP.md queue A)")


decode_step = init_cache
