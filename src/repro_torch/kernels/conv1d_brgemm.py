"""The BRGEMM conv1d forward kernel's wrapper (counterpart of
``repro/kernels/conv1d_brgemm.py:conv1d_fwd``).

``conv1d_fwd`` launches the CUDA kernel ``csrc/conv1d_fwd.cu`` on a CUDA
tensor and computes its plain version (``ref.conv1d_fused_ref``) on a CPU
tensor; a CUDA tensor never reaches the plain version here.  The CPU branch
is kept so the wrapper can be called, input checks included, on the CPU
where there is no card: the port's rule for every kernel wrapper, which
only the tensor's device decides.  ``ops.conv1d`` reaches the plain version
on the CPU through its own ``"ref"`` backend.  The library is built from
the checkout's sources at the first launch (``build.py``).

``conv1d_fwd.launches`` counts kernel launches — it is incremented where the
kernel is launched and nowhere else, so a run can show that its path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build
from . import epilogue as _ep
from . import ref as _ref

_SOURCES = ("conv1d_fwd.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv1d_fwd", _SOURCES)
    lib.conv1d_fwd.argtypes = [_VP] * 5 + [_I] * 10 + [_VP]
    lib.conv1d_fwd.restype = _I
    lib.conv1d_fwd_error_string.argtypes = [_I]
    lib.conv1d_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor | None, shape: tuple, dtype,
           device) -> None:
    if t is None:
        return
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def conv1d_fwd(x: torch.Tensor, w: torch.Tensor, *,
               bias: torch.Tensor | None = None,
               residual: torch.Tensor | None = None,
               activation: str | None = None, dilation: int = 1,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """BRGEMM forward: x (N, C, Q + (S-1)*d), w (S, K, C) -> (N, K, Q),
    ``act(conv + bias + residual)`` on the fp32 accumulator, stored in
    ``out_dtype`` (default ``x.dtype``).

    x and w are fp32 or bf16 of one dtype; bias (K,) has w's dtype and
    residual (N, K, Q) has x's.  Every tensor is contiguous and on x's
    device; anything else raises.
    """
    activation = _ep.canon(activation)
    out_dtype = out_dtype or x.dtype
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be (N, C, W) and w (S, K, C); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, C, Wp = x.shape
    S, K, Cw = w.shape
    if Cw != C:
        raise ValueError(f"weight has C={Cw} but input has C={C}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    Q = Wp - (S - 1) * dilation
    if Q <= 0:
        raise ValueError(f"width {Wp} too small for S={S}, dilation={dilation}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"conv1d_fwd takes fp32/bf16; got x {x.dtype}, "
                         f"out {out_dtype}")
    _check("x", x, (N, C, Wp), x.dtype, x.device)
    _check("w", w, (S, K, C), x.dtype, x.device)
    _check("bias", bias, (K,), w.dtype, x.device)
    _check("residual", residual, (N, K, Q), x.dtype, x.device)
    if x.device.type == "cpu":
        return _ref.conv1d_fused_ref(x, w, dilation=dilation, bias=bias,
                                     activation=activation, residual=residual,
                                     out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_fwd runs on cuda (or cpu); got {x.device}")
    if N > 65535:
        raise ValueError(f"batch {N} exceeds the kernel's grid limit 65535")
    out = torch.empty((N, K, Q), dtype=out_dtype, device=x.device)
    lib = _lib()
    rc = lib.conv1d_fwd(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), N, C, K, S, Wp, dilation, _ep.ACT_CODES[activation],
        _DTYPES[x.dtype], _DTYPES[out_dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc == -1:
        raise ValueError(
            f"conv1d_fwd: one channel row of the footprint (span "
            f"{(S - 1) * dilation}) does not fit in shared memory")
    if rc != 0:
        raise RuntimeError("conv1d_fwd launch failed: "
                           + lib.conv1d_fwd_error_string(rc).decode())
    conv1d_fwd.launches += 1
    return out


conv1d_fwd.launches = 0
