"""Plain PyTorch versions of the conv kernels (counterpart of
``repro/kernels/ref.py``).

These are what the CUDA kernels are held against, on the card by
``chip_smoke.py`` and on the CPU by the tests, and what a wrapper computes
for a tensor that lies on the CPU: the fused forward (``conv1d_fwd.cu``),
the data gradient (Alg. 3, the same kernel on the flipped weights) and the
weight and bias gradients (Alg. 4, ``conv1d_bwd_weight.cu``); and the
depthwise variants (the Mamba2 causal conv: ``depthwise_conv1d_fwd.cu``,
``depthwise_conv1d_bwd_weight.cu``), whose weights are ``(S, C)``; and
flash attention's forward and backward (``flash_fwd_ref``,
``flash_bwd_ref``: ``flash_fwd.cu``, ``flash_bwd.cu``), in the JAX
kernels' layout q (B, Tq, KV, G, hd), k and v (B, Tk, KV, hd).

Conventions (the paper's layout, kept from the JAX package):
  x   : (N, C, W)   input
  w   : (S, K, C)   weights in the paper's forward layout (not torch's
                    (K, C, S))
  out : (N, K, Q)   Q = W - (S - 1) * dilation   (VALID on pre-padded input)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import epilogue as _ep


def _conv1d_f32(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The paper's Algorithm 1 in fp32 with no output cast: S GEMMs over
    width-shifted slices of the input, accumulated tap by tap."""
    S, K, C = w.shape
    N, Cx, W = x.shape
    if C != Cx:
        raise ValueError(f"weight has C={C} but input has C={Cx}")
    Q = W - (S - 1) * dilation
    if Q <= 0:
        raise ValueError(f"width {W} too small for S={S}, dilation={dilation}")
    xf, wf = x.float(), w.float()
    out = torch.zeros((N, K, Q), dtype=torch.float32, device=x.device)
    for s in range(S):
        xs = xf[:, :, s * dilation:s * dilation + Q]
        out = out + torch.einsum("kc,ncq->nkq", wf[s], xs)
    return out


def conv1d_ref(x: torch.Tensor, w: torch.Tensor, *,
               dilation: int = 1) -> torch.Tensor:
    """Eq. (2) of the paper: Out[k,q] = sum_{c,s} In[c, q+d*s] W[s,k,c]."""
    return _conv1d_f32(x, w, dilation).to(x.dtype)


def conv1d_fused_ref(x: torch.Tensor, w: torch.Tensor, *, dilation: int = 1,
                     bias: torch.Tensor | None = None,
                     activation: str | None = None,
                     residual: torch.Tensor | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The fused-epilogue forward: act(conv + bias + residual) with all the
    epilogue math on the fp32 accumulator, then one cast to ``out_dtype``
    (default ``x.dtype``)."""
    u = conv1d_preact_ref(x, w, dilation=dilation, bias=bias,
                          residual=residual)
    return _ep.ACTIVATIONS[_ep.canon(activation)](u).to(out_dtype or x.dtype)


def conv1d_preact_ref(x: torch.Tensor, w: torch.Tensor, *, dilation: int = 1,
                      bias: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None) -> torch.Tensor:
    """The fp32 pre-activation ``conv + bias + residual``: the forward
    kernel's ``save_preact`` output."""
    return _ep.apply_ref(_conv1d_f32(x, w, dilation), bias=bias,
                         residual=residual)


def conv1d_bwd_data_ref(gout: torch.Tensor, w: torch.Tensor, *,
                        dilation: int = 1) -> torch.Tensor:
    """Alg. 3: the data gradient w.r.t. the (padded) input of conv1d_ref.

    gout: (N, K, Q) -> (N, C, W) with W = Q + (S-1)*dilation, in gout's
    dtype: the forward conv on gout zero-padded by the span on both sides
    against the flipped taps with K and C swapped, the paper's (S, C, K)
    layout.
    """
    S = w.shape[0]
    span = (S - 1) * dilation
    g = F.pad(gout, (span, span))
    return conv1d_ref(g, w.flip(0).transpose(1, 2), dilation=dilation)


def conv1d_bwd_weight_ref(x: torch.Tensor, gout: torch.Tensor, *,
                          dilation: int = 1) -> torch.Tensor:
    """Alg. 4: ``dW[s,k,c] = sum_{n,q} gout[n,k,q] * x[n,c,q + s*d]``.

    x: (N, C, Q + (S-1)*d), gout: (N, K, Q) -> (S, K, C) fp32.
    """
    N, K, Q = gout.shape
    W = x.shape[-1]
    S = (W - Q) // dilation + 1
    g32, x32 = gout.float(), x.float()
    return torch.stack([
        torch.einsum("nkq,ncq->kc", g32,
                     x32[:, :, s * dilation:s * dilation + Q])
        for s in range(S)])


def conv1d_dbias_ref(gout: torch.Tensor) -> torch.Tensor:
    """The bias gradient ``dbias[k] = sum_{n,q} gout[n,k,q]`` in fp32."""
    return gout.float().sum(dim=(0, 2))


# ---------------------------------------------------------------------------
# Depthwise (grouped, C == K): the Mamba2 causal conv
# ---------------------------------------------------------------------------


def _depthwise_conv1d_f32(x: torch.Tensor, w: torch.Tensor,
                          dilation: int) -> torch.Tensor:
    """``out[n,c,q] = sum_s w[s,c] * x[n,c,q+s*d]`` in fp32, tap by tap,
    no output cast.  x: (N, C, W), w: (S, C) -> (N, C, Q)."""
    S, C = w.shape
    N, Cx, W = x.shape
    if C != Cx:
        raise ValueError(f"weight has C={C} but input has C={Cx}")
    Q = W - (S - 1) * dilation
    if Q <= 0:
        raise ValueError(f"width {W} too small for S={S}, dilation={dilation}")
    xf, wf = x.float(), w.float()
    out = torch.zeros((N, C, Q), dtype=torch.float32, device=x.device)
    for s in range(S):
        out = out + wf[s][None, :, None] * xf[:, :, s * dilation:
                                               s * dilation + Q]
    return out


def depthwise_conv1d_preact_ref(x: torch.Tensor, w: torch.Tensor, *,
                                dilation: int = 1,
                                bias: torch.Tensor | None = None,
                                residual: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """The fp32 pre-activation ``conv + bias + residual`` of the depthwise
    conv: the forward kernel's ``save_preact`` output."""
    return _ep.apply_ref(_depthwise_conv1d_f32(x, w, dilation), bias=bias,
                         residual=residual)


def depthwise_conv1d_fused_ref(x: torch.Tensor, w: torch.Tensor, *,
                               dilation: int = 1,
                               bias: torch.Tensor | None = None,
                               activation: str | None = None,
                               residual: torch.Tensor | None = None,
                               out_dtype: torch.dtype | None = None
                               ) -> torch.Tensor:
    """The depthwise fused forward ``act(conv + bias + residual)``, all
    epilogue math on the fp32 accumulator, one cast to ``out_dtype``
    (default ``x.dtype``).  x (N, C, Q + (S-1)*d), w (S, C), bias (C,),
    residual (N, C, Q)."""
    u = depthwise_conv1d_preact_ref(x, w, dilation=dilation, bias=bias,
                                    residual=residual)
    return _ep.ACTIVATIONS[_ep.canon(activation)](u).to(out_dtype or x.dtype)


def depthwise_conv1d_bwd_data_ref(gout: torch.Tensor, w: torch.Tensor, *,
                                  dilation: int = 1,
                                  out_dtype: torch.dtype | None = None
                                  ) -> torch.Tensor:
    """The depthwise data gradient: the forward on gout zero-padded by the
    span on both sides against the flipped taps ``w.flip(0)`` (no
    transpose: each channel is its own filter).  gout (N, C, Q) ->
    (N, C, Q + (S-1)*d) in ``out_dtype`` (default gout's)."""
    span = (w.shape[0] - 1) * dilation
    return depthwise_conv1d_fused_ref(F.pad(gout, (span, span)), w.flip(0),
                                      dilation=dilation,
                                      out_dtype=out_dtype or gout.dtype)


def depthwise_conv1d_bwd_weight_ref(x: torch.Tensor, gout: torch.Tensor, *,
                                    dilation: int = 1) -> torch.Tensor:
    """Depthwise Alg. 4: ``dW[s,c] = sum_{n,q} gout[n,c,q] * x[n,c,q+s*d]``.

    x: (N, C, Q + (S-1)*d), gout: (N, C, Q), each in its own dtype ->
    (S, C) fp32.  The bias gradient is ``conv1d_dbias_ref(gout)``.
    """
    Q = gout.shape[-1]
    S = (x.shape[-1] - Q) // dilation + 1
    g32, x32 = gout.float(), x.float()
    return torch.stack([
        (g32 * x32[:, :, s * dilation:s * dilation + Q]).sum(dim=(0, 2))
        for s in range(S)])


# ---------------------------------------------------------------------------
# Flash attention (repro/kernels/flash_attention.py, term by term)
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the masked score: exp(NEG_INF - m) is exactly 0


def _causal_mask(Tq: int, Tk: int, q_offset: int, device) -> torch.Tensor:
    q_pos = torch.arange(Tq, device=device) + q_offset
    return q_pos[:, None] >= torch.arange(Tk, device=device)[None, :]


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0):
    """q (B, Tq, KV, G, hd), k and v (B, Tk, KV, hd) -> (o in q's dtype,
    lse fp32 (B, Tq, KV, G)): ``_fwd_kernel`` of the JAX package for each
    (batch, KV head), all in fp32 from fp32-cast inputs.  ``q_offset``
    shifts the query positions of the causal mask."""
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    scale = hd ** -0.5
    mask = _causal_mask(Tq, Tk, q_offset, q.device)[:, None, :]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Tq, KV, G), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(KV):
            qf = q[b, :, h].float() * scale                 # (Tq, G, hd)
            s = torch.einsum("qgh,kh->qgk", qf, k[b, :, h].float())
            if causal:
                s = torch.where(mask, s, NEG_INF)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            o[b, :, h] = torch.einsum("qgk,kh->qgh", p / l,
                                      v[b, :, h].float()).to(q.dtype)
            lse[b, :, h] = (m + torch.log(l))[..., 0]
    return o, lse


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * o)`` in fp32 from the stored o in its own dtype:
    (B, Tq, KV, G, hd) -> (B, Tq, KV, G)."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True):
    """The gradient of flash attention -> (dq, dk, dv) in q's, k's and v's
    dtypes: ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` of the JAX package
    for each (batch, KV head), P recomputed from lse, dk and dv summed over
    the G heads of the group."""
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    scale = hd ** -0.5
    mask = _causal_mask(Tq, Tk, 0, q.device)[:, None, :]
    delta = flash_delta(o, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for b in range(B):
        for h in range(KV):
            qf = q[b, :, h].float() * scale
            kf, vf = k[b, :, h].float(), v[b, :, h].float()
            dof = do[b, :, h].float()
            s = torch.einsum("qgh,kh->qgk", qf, kf)
            if causal:
                s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse[b, :, h][..., None])
            dp = torch.einsum("qgh,kh->qgk", dof, vf)
            ds = p * (dp - delta[b, :, h][..., None])
            dq[b, :, h] = (torch.einsum("qgk,kh->qgh", ds, kf)
                           * scale).to(q.dtype)
            dv[b, :, h] = torch.einsum("qgk,qgh->kh", p, dof).to(v.dtype)
            dk[b, :, h] = torch.einsum("qgk,qgh->kh", ds, qf).to(k.dtype)
    return dq, dk, dv
