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
D, E) and ``router_bias``, fp32 in a bf16 tree and kept so), so nothing
is split or joined::

    model.load_state_dict(params_from_jax(jax_tree_as_numpy))
    state = train_state_from_jax(jax_train_state_as_numpy, cfg)

A decode cache keeps its nesting (``cache_from_jax``): the port's caches
are the JAX package's trees of the same layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import init_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.train_step import TrainState


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes) has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Flatten a parameter tree of dicts, lists and arrays into a state
    dict of CPU tensors (same values and dtypes)."""
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


def cache_from_jax(tree, *, device: torch.device | str = "cpu"):
    """A JAX decode cache (its leaves as numpy arrays) as the port's: the
    same nesting of dicts, each leaf a tensor of its own with the same
    layout and dtype (Mamba2 ``{"conv": (L, B, S-1, conv_dim), "ssm": (L,
    B, H, N, P)}``, dense ``{"dense": {"k"|"v": (L, B, Tmax, KV, hd)}}``,
    Whisper ``{"k"|"v": (L, B, Tmax, KV, hd), "cross_k"|"cross_v": (L, B,
    Te, H, hd)}``, its cross K/V filled or not; Zamba2 ``{"mamba": {"conv",
    "ssm"}, "k"|"v": (n_app, B, Tmax, KV, hd)}``; MoE ``{"dense"|"moe":
    {"k"|"v": (L_stack, B, Tmax, KV, hd)}}``), so ``decode_step`` may
    write into it."""
    if isinstance(tree, dict):
        return {k: cache_from_jax(v, device=device) for k, v in tree.items()}
    return _tensor(tree).to(device)


def train_state_from_jax(state, cfg, *,
                         device: torch.device | str = "cpu") -> TrainState:
    """The JAX ``TrainState`` (params, AdamW moments and count, step; its
    leaves as numpy arrays) as the port's, on ``device``."""
    model = init_model(cfg, device=device)
    model.load_state_dict(params_from_jax(state.params))

    def moments(tree):
        return {k: t.to(device) for k, t in params_from_jax(tree).items()}

    opt = AdamWState(m=moments(state.opt.m), v=moments(state.opt.v),
                     count=_tensor(state.opt.count).to(device, torch.int32))
    return TrainState(params=model, opt=opt,
                      step=_tensor(state.step).to(device, torch.int32))
