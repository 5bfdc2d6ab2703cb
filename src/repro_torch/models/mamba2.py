"""Mamba2 (SSD, state-space duality; Dao & Gu 2024, arXiv:2405.21060), the
attention-free language model (counterpart of ``repro/models/mamba2.py``).

The causal depthwise conv inside every block runs through the port's
depthwise kernels (``kernels.ops.depthwise_conv1d``): the forward with
bias and SiLU fused on the fp32 accumulator, and in training its
``DepthwiseConv1dFunction`` (bwd-data through the forward kernel,
``depthwise_conv1d_bwd_weight`` for the weight and bias gradients).

Sequence mixing is the chunked SSD algorithm: quadratic attention-like
products inside chunks of ``cfg.ssm.chunk`` tokens, and the state carried
across chunks by a loop (JAX's ``lax.scan``).  Decode
(``block_decode``/``decode_step``) is the O(1) recurrent update on an
(H, N, P) state, its conv the fp32 product of the (S, C) taps with a
window of the last S inputs, in plain PyTorch as the JAX package leaves
it to XLA: it runs no kernel.  The cache (``init_cache``) holds every
layer's state in real (L, B, ...) tensors that ``decode_step`` updates
in place.

Parameters are kept as the JAX package keeps them: the per-layer leaves
stacked with a leading ``L`` axis (``layers.mixer.in_proj`` is (L, D,
d_proj)), so the state-dict keys, shapes and AdamW's ``ndim >= 2`` decay
rule are the JAX tree's own, and checkpoints cross between the packages
unchanged.  The forward takes each layer's slice through one ``unbind``
per stacked leaf, whose backward stacks the L gradients once; indexing
the stacked leaf per layer instead would add a full (L, ...) gradient
per layer.

Tensor-parallel serving (the JAX launcher's ``--model-parallel``): a
model built from a rank's blocks (``models.local_model``) with ``tp``
set to its ``sharding.ModelGroup`` runs ``forward`` and ``decode_step``
on its SSM heads.  Its fused leaves are segment-aligned
(``sharding.segment_block``): ``in_proj`` gives the rank's z, x and dt
and the whole B and C, and its prefill's conv launches
``depthwise_conv1d_fwd`` on the rank's x channels and the whole B and C
(``d_inner / N + 2·G·N``).  The sizes a block runs at come from its
leaves' shapes (``_local_dims``).  Two sums a layer cross the group: the
gated RMS norm's fp32 sum of squares, whose mean JAX takes over the
whole ``d_inner`` (``gated_norm``), and ``out_proj``'s row-parallel
product; the embedding and the logits go as in
``models/transformer.py``.  Its cache (``init_cache(..., mp=)``) holds
the rank's conv channels and SSM heads.  It serves only: no gradient
crosses the group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import sharding

# the per-layer mixer leaves, in the JAX tree's order
MIXER_KEYS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
              "gate_norm", "out_proj")
# a layer's leaves as ``forward`` passes them: the norm's scale, then the
# mixer's, under their state-dict keys
LAYER_KEYS = ("layers.norm.scale", *(f"layers.mixer.{k}" for k in MIXER_KEYS))


def dims(cfg) -> tuple[int, int, int]:
    """``(d_inner, n_heads, conv_dim)``."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, d_inner + 2 * s.n_groups * s.d_state


class _Leaves(nn.Module):
    """One level of the JAX parameter tree: its leaves as parameters."""

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        for k, t in leaves.items():
            self.register_parameter(k, nn.Parameter(t))


class Mamba2(nn.Module):
    """The language model; ``forward(tokens)`` is :func:`forward`.

    Parameters (JAX's keys): ``embed.tok`` (padded_vocab, D),
    ``layers.norm.scale`` (L, D), ``layers.mixer.<MIXER_KEYS>`` (L, ...),
    ``final_norm.scale`` (D,), ``unembed`` (D, padded_vocab).  ``tp``:
    the ``sharding.ModelGroup`` of a tensor-parallel rank whose leaves
    are its blocks, or None.
    """

    tp = None
    ds = None  # an FSDP rank's sharding.DataShards (models.fsdp_model)

    def __init__(self, cfg, leaves: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.embed = _Leaves(tok=leaves["embed.tok"])
        self.layers = nn.Module()
        self.layers.norm = _Leaves(scale=leaves["layers.norm.scale"])
        self.layers.mixer = _Leaves(**{
            k: leaves[f"layers.mixer.{k}"] for k in MIXER_KEYS})
        self.final_norm = _Leaves(scale=leaves["final_norm.scale"])
        self.unembed = nn.Parameter(leaves["unembed"])

    def forward(self, tokens: torch.Tensor, *, last_only: bool = False,
                hidden_only: bool = False,
                backend: str | None = None) -> torch.Tensor:
        return forward(self, tokens, last_only=last_only,
                       hidden_only=hidden_only, backend=backend)


def normal_leaf(gen: torch.Generator, shape: tuple, scale: float,
                dtype: torch.dtype, device, *, stacked: bool = False
                ) -> torch.Tensor:
    """A leaf of ``shape`` drawn normal on the host from ``gen``, times
    ``scale``, in ``dtype`` on ``device``.  A ``stacked`` leaf (L, ...)
    is drawn and moved one layer's slab at a time, so the host never holds
    more than a slab (Zamba2's ``in_proj`` is 16.9 GB in fp32 whole).
    Where every slab's size is a multiple of 16, as at every width of
    Mamba2 and Zamba2, the slabs are the values of one draw of the whole
    leaf: PyTorch's CPU normal fill turns its uniforms into normals 16 at
    a time, in order."""
    if not stacked:
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(
            device)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = (torch.randn(shape[1:], generator=gen) * scale).to(dtype)
    return out


def leaf_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Mamba2's leaves' shapes under their keys, as ``draw_leaves``
    draws them."""
    s = cfg.ssm
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    d_inner, H, conv_dim = dims(cfg)
    d_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H  # z, xBC, dt
    mixer = {"in_proj": (D, d_proj), "conv_w": (s.conv_width, conv_dim),
             "conv_b": (conv_dim,), "dt_bias": (H,), "A_log": (H,),
             "D": (H,), "gate_norm": (d_inner,), "out_proj": (d_inner, D)}
    return {"embed.tok": (V, D), "layers.norm.scale": (L, D),
            **{f"layers.mixer.{k}": (L, *v) for k, v in mixer.items()},
            "final_norm.scale": (D,), "unembed": (D, V)}


def draw_leaves(cfg, gen: torch.Generator,
                device: torch.device | str) -> dict[str, torch.Tensor]:
    """Mamba2's leaves under their keys, drawn from ``gen`` leaf by leaf
    (``normal_leaf``) in a fixed order (dt, ``embed.tok``, ``in_proj``,
    ``conv_w``, ``out_proj``, ``unembed``) and each moved to ``device``
    as it is drawn; see :func:`init_params`."""
    s = cfg.ssm
    dtype = getattr(torch, cfg.dtype)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    d_inner, H, conv_dim = dims(cfg)
    d_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H  # z, xBC, dt

    def normal(*shape, scale, stacked=True):
        return normal_leaf(gen, shape, scale, dtype, device, stacked=stacked)

    def const(fill, *shape, dtype=dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    norm = cm.init_norm(cfg, D, dtype)["scale"].to(device)
    dt = torch.exp(torch.rand((L, H), generator=gen)
                   * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    return {
        "embed.tok": normal(V, D, scale=0.02, stacked=False),
        "layers.norm.scale": norm.repeat(L, 1),
        "layers.mixer.in_proj": normal(L, D, d_proj, scale=D ** -0.5),
        "layers.mixer.conv_w": normal(L, s.conv_width, conv_dim,
                                      scale=s.conv_width ** -0.5),
        "layers.mixer.conv_b": const(0.0, L, conv_dim),
        "layers.mixer.dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(
            device),
        "layers.mixer.A_log": torch.log(torch.arange(
            1, H + 1, dtype=torch.float32)).repeat(L, 1).to(device),
        "layers.mixer.D": const(1.0, L, H, dtype=torch.float32),
        "layers.mixer.gate_norm": const(1.0, L, d_inner),
        "layers.mixer.out_proj": normal(L, d_inner, D,
                                        scale=d_inner ** -0.5),
        "final_norm.scale": norm,
        "unembed": normal(D, V, scale=D ** -0.5, stacked=False),
    }


def init_params(cfg, *, seed: int = 0,
                device: torch.device | str = "cpu") -> Mamba2:
    """The model with weights drawn on the host from a generator seeded
    with ``seed`` (the same weights on every device), each leaf moved to
    ``device`` as it is drawn (``draw_leaves``), by the JAX package's
    distributions: normal projections scaled by fan-in ** -0.5, conv taps
    by conv_width ** -0.5, embeddings by 0.02; zero conv bias, unit norms
    and D, ``A_log = log(1..H)`` and ``dt_bias`` the inverse softplus of a
    log-uniform dt in [dt_min, dt_max].  ``dt_bias``, ``A_log`` and ``D``
    are fp32 whatever the model's dtype."""
    gen = torch.Generator().manual_seed(seed)
    return Mamba2(cfg, draw_leaves(cfg, gen, device))


def _conv(p: dict, xBC: torch.Tensor, cfg, backend) -> torch.Tensor:
    """The causal depthwise conv over time: (B, T, C) -> (B, C, T) for the
    kernel, bias + SiLU fused, fp32 out (it feeds the SSD scan without a
    cast), back to (B, T, C)."""
    y = kops.depthwise_conv1d(
        xBC.transpose(1, 2), p["conv_w"], bias=p["conv_b"],
        activation="silu", dilation=1, padding="CAUSAL", backend=backend,
        out_dtype=torch.float32)
    return y.transpose(1, 2)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(v, 0)`` (``F.softplus``
    turns linear above 20)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """SSD scan.  x: (B, T, H, P), dt: (B, T, H), A: (H,), B/C: (B, T, G, N)
    -> y (B, T, H, P), all fp32.  The products keep (b, nc, H|G) leading, as
    the JAX package's head-major layout does.

    One difference from the JAX package: the intra-chunk decay
    ``exp(cs_i - cs_j)`` is masked before the ``exp`` (``-inf`` above the
    diagonal) where JAX masks after it.  The values are the same; JAX's
    form overflows to ``inf`` above the diagonal once ``|cs|`` passes 88,
    which Mamba2-370M's chunk of 128 reaches, and its gradient is then
    ``0 * inf = nan``.
    """
    b, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if T % chunk:
        # pad to a chunk multiple: dt = 0 is inert (no decay, no input)
        pad = chunk - T % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        return ssd_chunked(x, dt, A, B, C, chunk)[:, :T]
    nc, rep = T // chunk, H // G

    xh = x.reshape(b, nc, chunk, H, P).permute(0, 1, 3, 2, 4)   # (b,nc,H,c,P)
    dth = dt.reshape(b, nc, chunk, H).permute(0, 1, 3, 2)      # (b,nc,H,c)
    Bg = B.reshape(b, nc, chunk, G, N).permute(0, 1, 3, 2, 4)  # (b,nc,G,c,N)
    Cg = C.reshape(b, nc, chunk, G, N).permute(0, 1, 3, 2, 4)
    dA_cs = torch.cumsum(dth * A[:, None], dim=3)              # (b,nc,H,c)

    # intra-chunk: y_i += C_i.B_j exp(cs_i - cs_j) dt_j x_j for j <= i;
    # C.B is per group, shared by its heads
    cb = Cg @ Bg.transpose(-1, -2)                             # (b,nc,G,c,c)
    seg = dA_cs[..., :, None] - dA_cs[..., None, :]            # (b,nc,H,c,c)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cbl = (cb.reshape(b, nc, G, 1, chunk, chunk)
           * Lmat.reshape(b, nc, G, rep, chunk, chunk)).reshape(
        b, nc, H, chunk, chunk)
    y_intra = cbl @ (dth[..., None] * xh)                      # (b,nc,H,c,P)

    # chunk states: S = sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(dA_cs[..., -1:] - dA_cs)          # (b,nc,H,c)
    wx = ((dth * decay_to_end)[..., None] * xh).reshape(
        b, nc, G, rep, chunk, P)
    S = (Bg.transpose(-1, -2)[:, :, :, None] @ wx).reshape(
        b, nc, H, N, P)

    # inter-chunk recurrence: the state *entering* each chunk
    chunk_decay = torch.exp(dA_cs[..., -1])                    # (b,nc,H)
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    h_in = []
    for i in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, i, :, None, None] + S[:, i]
    h_in = torch.stack(h_in, dim=1).reshape(b, nc, G, rep, N, P)

    y_inter = (torch.exp(dA_cs).reshape(b, nc, G, rep, chunk)[..., None]
               * (Cg[:, :, :, None] @ h_in)).reshape(b, nc, H, chunk, P)
    return (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, T, H, P)


def _local_dims(p: dict, cfg) -> tuple[int, int, int]:
    """``(d_inner, n_heads, n_groups)`` of the block ``p`` holds: the
    layer's, or a tensor-parallel rank's (its heads, and B and C whole or
    its groups), read from the leaves' shapes."""
    s = cfg.ssm
    H = p["D"].shape[-1]
    d_inner = H * s.head_dim
    return d_inner, H, (p["conv_w"].shape[-1] - d_inner) // (2 * s.d_state)


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, cfg,
               dtype: torch.dtype, tp=None) -> torch.Tensor:
    """The gated RMS norm: fp32 ``y * silu(z)`` over its mean square,
    times ``scale``, cast to ``dtype``.  On a tensor-parallel rank (``y``
    its channels) the fp32 sum of squares is summed over the group and
    divided by the whole width, JAX's mean over the whole ``d_inner``."""
    y = y * F.silu(z.float())
    if tp is None:
        ms = (y * y).mean(-1, keepdim=True)
    else:
        ms = tp.sum((y * y).sum(-1, keepdim=True)) / (y.shape[-1] * tp.size)
    y = y * torch.rsqrt(ms + cfg.norm_eps)
    return (y * scale.float()).to(dtype)


def block_fwd(p: dict, xres: torch.Tensor, cfg, *,
              backend: str | None = None, tp=None) -> torch.Tensor:
    """One Mamba2 block over the full sequence.  xres: (B, T, D), already
    normed; ``p`` holds one layer's ``MIXER_KEYS`` (with ``tp``, the
    rank's blocks: ``out_proj``'s product summed over the group)."""
    s = cfg.ssm
    d_inner, H, G = _local_dims(p, cfg)
    P, N = s.head_dim, s.d_state
    b, T, _ = xres.shape
    z, xBC, dt = torch.split(xres @ p["in_proj"],
                             [d_inner, d_inner + 2 * G * N, H], dim=-1)
    xBC = _conv(p, xBC, cfg, backend)  # fp32 (B, T, conv_dim)
    x_ssm, B, C = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    x_ssm = x_ssm.reshape(b, T, H, P)
    B = B.reshape(b, T, G, N)
    C = C.reshape(b, T, G, N)
    dt_act = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd_chunked(x_ssm, dt_act, A, B, C, s.chunk)
    y = y + p["D"][None, None, :, None] * x_ssm
    y = gated_norm(y.reshape(b, T, d_inner), z, p["gate_norm"], cfg,
                   xres.dtype, tp)
    return cm.row_parallel(y @ p["out_proj"], None, tp)


def _layers(model: Mamba2):
    """Each layer's ``(norm scale, mixer leaves)``, slices of the stacked
    leaves."""
    mixer = model.layers.mixer
    for scale, *leaves in zip(model.layers.norm.scale.unbind(0),
                              *(getattr(mixer, k).unbind(0)
                                for k in MIXER_KEYS)):
        yield scale, dict(zip(MIXER_KEYS, leaves))


def forward(model: Mamba2, tokens: torch.Tensor, *, last_only: bool = False,
            hidden_only: bool = False,
            backend: str | None = None) -> torch.Tensor:
    """tokens (B, T) int -> fp32 logits (B, T, padded_vocab), the padded
    columns at ``common.NEG_INF``; ``last_only`` keeps the last position
    only (B, 1, ...), the prefill's; with ``hidden_only`` the final-normed
    hidden state (B, T, D) instead.  ``backend`` picks the conv's
    (``None``: the kernels for CUDA tensors, the plain version for CPU
    ones).  With ``cfg.remat`` each layer's activations are recomputed in
    the backward.  A tensor-parallel rank's model (``model.tp``) runs its
    blocks; an FSDP rank's (``model.ds``) gathers each layer's leaves
    inside the layer and the tables where they are read."""
    cfg, tp, ds = model.cfg, model.tp, model.ds
    x = cm.embed_tokens(cm.gathered(model, ["embed.tok"])[0], tokens, cfg,
                        tp=tp)

    def layer(x, scale, *leaves):
        scale, *leaves = cm.gather_layer(ds, LAYER_KEYS, (scale, *leaves))
        p = dict(zip(MIXER_KEYS, leaves))
        return x + block_fwd(p, cm.apply_norm(scale, x, cfg), cfg,
                             backend=backend, tp=tp)

    step = cm.maybe_remat(layer, cfg)
    for scale, p in _layers(model):
        x = step(x, scale, *p.values())
    if last_only:
        x = x[:, -1:]
    x = cm.apply_norm(model.final_norm.scale, x, cfg)
    if hidden_only:
        return x
    return cm.logits_from_hidden(*cm.unembedding(model), x, cfg, tp=tp)


# --- decode ------------------------------------------------------------------

def init_block_state(cfg, batch: int, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cpu", mp: int = 1) -> dict:
    """One layer's decode state: ``conv`` (B, S-1, conv_dim), the last S-1
    conv inputs, in ``dtype``; ``ssm`` (B, H, N, P), the recurrent state,
    in fp32 whatever ``dtype``: the JAX package's decode returns it in
    fp32 from its first step on (h is an fp32 product), so a narrower
    leaf would round a state JAX keeps.  ``mp``: a tensor-parallel
    rank's state, its conv channels (``sharding.ssm_local_width``) and
    H/mp heads."""
    s = cfg.ssm
    _, H, _ = dims(cfg)
    conv_dim = sharding.ssm_local_width(cfg, "conv", mp)
    return {"conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H // mp, s.d_state, s.head_dim),
                               dtype=torch.float32, device=device)}


def block_decode(p: dict, xres: torch.Tensor, cfg, state: dict,
                 tp=None) -> torch.Tensor:
    """One Mamba2 block on one token.  xres: (B, 1, D), already normed;
    ``state`` as :func:`init_block_state`, updated in place (the conv
    window slides by one, the SSM state takes the token).  Returns the
    block's output (B, 1, D).  With ``tp``, the rank's blocks and state,
    as :func:`block_fwd`."""
    s = cfg.ssm
    d_inner, H, G = _local_dims(p, cfg)
    P, N = s.head_dim, s.d_state
    b = xres.shape[0]
    z, xBC, dt = torch.split(xres @ p["in_proj"],
                             [d_inner, d_inner + 2 * G * N, H], dim=-1)
    conv = state["conv"]
    window = torch.cat([conv, xBC.to(conv.dtype)], dim=1)      # (B, S, cd)
    conv_out = torch.einsum("bsc,sc->bc", window.float(),
                            p["conv_w"].float()) + p["conv_b"].float()
    conv.copy_(window[:, 1:])
    x_ssm, B, C = torch.split(F.silu(conv_out), [d_inner, G * N, G * N],
                              dim=-1)
    x_ssm = x_ssm.reshape(b, H, P)
    B = B.reshape(b, G, N).repeat_interleave(H // G, dim=1)    # (b, H, N)
    C = C.reshape(b, G, N).repeat_interleave(H // G, dim=1)
    dt_act = _softplus(dt[:, 0].float() + p["dt_bias"])       # (b, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_act * A)
    h = (state["ssm"] * decay[:, :, None, None]
         + (dt_act[:, :, None] * B)[..., None] * x_ssm[:, :, None, :])
    state["ssm"].copy_(h)
    y = (C[:, :, None, :] @ h).squeeze(2) + p["D"][None, :, None] * x_ssm
    y = gated_norm(y.reshape(b, 1, d_inner), z, p["gate_norm"], cfg,
                   xres.dtype, tp)
    return cm.row_parallel(y @ p["out_proj"], None, tp)


def init_cache(cfg, batch: int, max_len: int = 0,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cpu", mp: int = 1) -> dict:
    """The decode cache, O(1) in the sequence length (``max_len`` unused):
    ``{"conv": (L, B, S-1, conv_dim), "ssm": (L, B, H, N, P)}``, the JAX
    package's layout, each leaf a tensor of its own (not a broadcast of one
    layer's: ``decode_step`` writes every layer's slice in place).
    ``mp``: a tensor-parallel rank's (``init_block_state``)."""
    one = init_block_state(cfg, batch, dtype, device, mp)
    return {k: v[None].repeat(cfg.n_layers, *(1,) * v.dim())
            for k, v in one.items()}


def layer_decode(model, scale: torch.Tensor, p: dict, x: torch.Tensor,
                 state: dict) -> torch.Tensor:
    """One layer's block on one token (``block_decode`` of the normed
    ``x``), its leaves (``scale`` and the mixer's ``p``, a layer's slices)
    gathered over a data rank's group first (``model.ds``): the gathered
    leaves die with the call."""
    scale, *leaves = cm.gather_layer(model.ds, LAYER_KEYS,
                                     (scale, *p.values()))
    return block_decode(dict(zip(MIXER_KEYS, leaves)),
                        cm.apply_norm(scale, x, model.cfg), model.cfg, state,
                        model.tp)


def decode_step(model: Mamba2, cache: dict, tokens: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int -> (fp32 logits (B, 1,
    padded_vocab), cache), the cache updated in place.  ``pos`` is unused:
    the state holds the whole history.  A data rank's model
    (``model.ds``) gathers each layer's leaves, and the tables, where
    they are read."""
    cfg, tp = model.cfg, model.tp
    x = cm.embed_tokens(cm.gathered(model, ["embed.tok"])[0], tokens, cfg,
                        tp=tp)
    for i, (scale, p) in enumerate(_layers(model)):
        x = x + layer_decode(model, scale, p, x,
                             {k: v[i] for k, v in cache.items()})
    x = cm.apply_norm(model.final_norm.scale, x, cfg)
    return cm.logits_from_hidden(*cm.unembedding(model), x, cfg,
                                 tp=tp), cache
