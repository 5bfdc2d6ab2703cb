"""Flash attention's wrappers (counterpart of
``repro/kernels/flash_attention.py``): ``flash_fwd``, ``flash_bwd``, the
``FlashAttentionFunction`` that joins them (the JAX ``custom_vjp``) and
``flash_attention``.

Layouts are the JAX kernels': q and o (B, Tq, KV, G, hd), k and v
(B, Tk, KV, hd), lse (B, Tq, KV, G) fp32, where the G query heads of a
group share one KV head (h = kv * G + g).  The kernels read q, k, v, o and
dO through their strides, so the model's (B, T, H, hd) tensors go in as
views, never transposed or copied.

Each wrapper launches its CUDA kernel (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) on a CUDA tensor and computes its plain version
(``ref.flash_fwd_ref``, ``ref.flash_bwd_ref``) on a CPU tensor; a CUDA
tensor never reaches the plain version.  On a ``meta`` tensor (a
dry-run's rank, ``launch/dryrun.py``) it returns empty outputs of the
kernel's shapes and reports the kernel's work to ``kernels.meta``
(``roofline.flops.flash_fwd_flops``, each operand read and each output
written once), launching nothing.  Each library is built from the
checkout's sources at its first launch (``build.py``).  ``flash_fwd.
launches`` and ``flash_bwd.launches`` count the launches, incremented
where the kernel is launched and nowhere else.

``bq`` is the TPU kernel's query tile, a tiling knob that the port accepts
and ignores, except that the JAX kernel floors ``q_offset`` to a multiple
of it: ``flash_fwd`` raises unless ``q_offset`` is such a multiple, where
the two meanings agree.  ``flash_bwd``, as in JAX, takes no ``q_offset``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.roofline import flops as _flops

from . import build as _build
from . import meta as _meta
from . import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 112, 128, 192)  # the kernels' templates
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_REFUSED = {-1: f"head_dim must be one of {_HEAD_DIMS}",
            -2: "batch x KV heads exceeds the grid's limit 65535"}


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    """The forward kernel's library, built at first use."""
    lib = _build.load("flash_fwd", ("flash_fwd.cu", "flash_common.cuh",
                                    "hopper.cuh"))
    lib.flash_fwd.argtypes = [_VP] * 5 + [_I] * 6 + [_VP, _I, _I, _F, _I,
                                                      _I, _VP]
    lib.flash_fwd.restype = _I
    lib.flash_fwd_error_string.argtypes = [_I]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernels' library, built at first use."""
    lib = _build.load("flash_bwd", ("flash_bwd.cu", "flash_common.cuh",
                                    "hopper.cuh"))
    lib.flash_bwd.argtypes = [_VP] * 9 + [_I] * 6 + [_VP, _I, _F, _I, _I,
                                                      _VP]
    lib.flash_bwd.restype = _I
    lib.flash_bwd_error_string.argtypes = [_I]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    """Shape, dtype and device, and a contiguous last dimension (the other
    dimensions are read through their strides)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous; "
                         f"strides {t.stride()}")


def _check_cuda(name: str, t: torch.Tensor) -> None:
    """What the kernels' 16-byte loads need (the bf16 kernels' cp.async of
    8 elements, the fp32 kernels' 4): every row 16-byte aligned, so every
    stride a multiple of 16 bytes (8 bf16, 4 fp32 elements) and the start
    16-byte aligned."""
    per = 16 // t.element_size()
    if any(s % per for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs strides that are multiples of {per} "
                         f"elements (16 bytes) and a 16-byte aligned start; "
                         f"strides {t.stride()}, address {t.data_ptr():#x}")


def _check_qkv(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"q must be (B, Tq, KV, G, hd) and k, v (B, Tk, KV,"
                         f" hd); got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention takes fp32/bf16; got {q.dtype}")
    if min(B, Tq, Tk, KV, G, hd) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    _check("q", q, q.shape, q.dtype, q.device)
    _check("k", k, (B, Tk, KV, hd), q.dtype, q.device)
    _check("v", v, (B, Tk, KV, hd), q.dtype, q.device)


def _check_on_card(fn: str, *named) -> None:
    device = named[0][1].device
    if device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda (or cpu); got {device}")
    hd = named[0][1].shape[-1]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim must be one of {_HEAD_DIMS}, got "
                         f"{hd}")
    for name, t in named:
        _check_cuda(name, t)


def _failed(fn: str, lib, rc: int) -> Exception:
    if rc in _REFUSED:
        return ValueError(f"{fn}: {_REFUSED[rc]}")
    return RuntimeError(f"{fn} launch failed: "
                        + getattr(lib, f"{fn}_error_string")(rc).decode())


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, bq: int = 256, q_offset: int = 0):
    """Softmax attention of q (B, Tq, KV, G, hd) over k, v (B, Tk, KV, hd)
    -> (o (B, Tq, KV, G, hd) in q's dtype, lse (B, Tq, KV, G) fp32, the
    per-row logsumexp of the scaled scores).  ``causal`` masks keys past
    each query's position, queries sitting at ``q_offset + t``.

    q, k and v are fp32 or bf16 of one dtype on one device, each with a
    contiguous last dimension; on the card hd is 64, 112, 128 or 192 and
    every stride a multiple of 16 bytes.  Anything else raises.  The
    scores are scaled by ``hd ** -0.5`` of q's own hd (at 112 the kernels
    run in a tile of 128 columns, the last 16 zeros; the scale stays
    112's).  At 192 (DeepSeek-V3's MLA, ``models/mla.py``) v comes padded
    with zeros from its own width, as the JAX package pads it, and the
    caller slices the output back.
    """
    _check_qkv(q, k, v)
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    bq = min(bq, Tq)
    if q_offset < 0 or q_offset % bq:
        raise ValueError(
            f"q_offset {q_offset} must be a non-negative multiple of the "
            f"query tile bq={bq}: the JAX kernel floors it to one")
    if q.device.type == "cpu":
        return _ref.flash_fwd_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type == "meta":
        o = torch.empty((B, Tq, KV, G, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, Tq, KV, G), dtype=torch.float32,
                          device=q.device)
        _meta.report("flash_fwd", _flops.flash_fwd_flops(
            B, Tq, Tk, KV * G, hd, causal), _meta.nbytes(q, k, v, o, lse))
        return o, lse
    _check_on_card("flash_fwd", ("q", q), ("k", k), ("v", v))
    o = torch.empty((B, Tq, KV, G, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Tq, KV, G), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:4], *k.stride()[:3],
                                       *v.stride()[:3])
    lib = _fwd_lib()
    rc = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Tq, Tk, KV, G, hd, strides, int(causal),
        q_offset, hd ** -0.5, _DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise _failed("flash_fwd", lib, rc)
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """The gradient of ``flash_fwd`` (``q_offset`` 0) -> (dq, dk, dv) in
    q's, k's and v's dtypes, from the forward's o and lse and the
    cotangent do (o's shape and dtype).  ``delta = rowsum(do * o)`` is
    taken in fp32 from the stored o, in its own dtype, before the kernels,
    as the JAX wrapper takes it.  dk and dv sum the G heads of each group.

    On the card the dQ kernel and the dK/dV kernel (at hd 192 a dV and
    a dK launch of it, one accumulator each) use no atomics: two calls on
    the same inputs give bitwise equal results.
    """
    _check_qkv(q, k, v)
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    _check("o", o, q.shape, q.dtype, q.device)
    _check("do", do, q.shape, q.dtype, q.device)
    _check("lse", lse, (B, Tq, KV, G), torch.float32, q.device)
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    if q.device.type == "cpu":
        return _ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal)
    if q.device.type == "meta":
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        _meta.report("flash_bwd", _flops.flash_bwd_flops(
            B, Tq, Tk, KV * G, hd, causal),
            _meta.nbytes(q, k, v, o, lse, do, dq, dk, dv))
        return dq, dk, dv
    _check_on_card("flash_bwd", ("q", q), ("k", k), ("v", v), ("do", do))
    # rowsum(dO * o) in fp32 from the stored o, in its own dtype
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = torch.empty((B, Tq, KV, G, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Tk, KV, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, KV, hd), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 14)(*q.stride()[:4], *do.stride()[:4],
                                       *k.stride()[:3], *v.stride()[:3])
    lib = _bwd_lib()
    rc = lib.flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Tq, Tk, KV, G, hd, strides, int(causal),
        hd ** -0.5, _DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise _failed("flash_bwd", lib, rc)
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` with its gradient (the JAX ``custom_vjp``): the
    forward saves q, k, v, o and lse; the backward is ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, bq: int):
        o, lse = flash_fwd(q, k, v, causal=causal, bq=bq)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. an expanded cotangent
            do = do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, bq: int = 256) -> torch.Tensor:
    """q (B, Tq, KV, G, hd), k, v (B, Tk, KV, hd) -> o (B, Tq, KV, G, hd),
    differentiable in q, k and v through ``FlashAttentionFunction``."""
    return FlashAttentionFunction.apply(q, k, v, causal, bq)
