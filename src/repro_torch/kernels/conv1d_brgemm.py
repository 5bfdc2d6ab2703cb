"""The BRGEMM conv1d kernels' wrappers (counterpart of
``repro/kernels/conv1d_brgemm.py``: ``conv1d_fwd``, ``conv1d_bwd_weight``
and the depthwise pair ``depthwise_conv1d_fwd``,
``depthwise_conv1d_bwd_weight``).

Each wrapper launches its CUDA kernel (``csrc/<name>.cu``) on a CUDA
tensor and computes its plain
version (``ref.py``) on a CPU tensor; a CUDA tensor never reaches the plain
version here.  The CPU branch is kept so the wrapper can be called, input
checks included, on the CPU where there is no card: the port's rule for
every kernel wrapper, which only the tensor's device decides.
``ops.conv1d`` reaches the plain version on the CPU through its own
``"ref"`` backend.  On a ``meta`` tensor (a dry-run's rank,
``launch/dryrun.py``) each wrapper returns empty outputs of its kernel's
shapes and reports the kernel's work to ``kernels.meta``
(``roofline.flops.conv1d_flops``; each operand read and each output
written once), launching nothing.  Each library is built from the checkout's sources at
its first launch (``build.py``).

``conv1d_fwd`` takes a pinned register tile (``tile=``, one of
``FWD_TILES``) and ``conv1d_bwd_weight`` a pinned body (``body=``, one
of ``BWD_BODIES``), the knobs the tuner (``repro_torch.tune``) searches;
``None`` keeps the kernel's own choice.  A pin that is not one of those
raises on every device; one that may not run the shape is refused by the
kernel's own rule (``fwd_tile`` and ``bwd_weight_body`` ask it) and
raises, never replaced.  On a CPU tensor a valid pin is ignored: the
plain version has no tile.

Each wrapper's ``launches`` attribute (``conv1d_fwd.launches``, ...)
counts its kernel launches; each is incremented where its kernel is
launched and nowhere else, so a run can show that its path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.roofline import flops as _flops

from . import build as _build
from . import epilogue as _ep
from . import meta as _meta
from . import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int

# conv1d_fwd's register tiles, J * 100 + KT (J columns x KT filters a
# thread): the ones csrc/conv1d_fwd.cu instantiates, by filter count
FWD_TILES_WIDE = (616, 408, 204, 104)   # K > 1
FWD_TILES_SINGLE = (1601, 201, 101)     # K == 1
FWD_TILES = FWD_TILES_WIDE + FWD_TILES_SINGLE
# conv1d_bwd_weight's bodies, by the code csrc/conv1d_bwd_weight.cu takes
BWD_BODIES = {"unit": 1, "taps": 2}
_REFUSED_PIN = -4  # both kernels' code for a pin that may not run


def fwd_tiles(K: int) -> tuple[int, ...]:
    """The tiles ``conv1d_fwd`` instantiates for K filters."""
    return FWD_TILES_SINGLE if K == 1 else FWD_TILES_WIDE


def _tile_code(tile: int | None) -> int:
    if tile is None or tile == 0:
        return 0
    if tile not in FWD_TILES:
        raise ValueError(f"unknown conv1d_fwd tile {tile!r}; expected one "
                         f"of {FWD_TILES} (J * 100 + KT) or None")
    return int(tile)


def _body_code(body: str | None) -> int:
    if body is None:
        return 0
    if body not in BWD_BODIES:
        raise ValueError(f"unknown conv1d_bwd_weight body {body!r}; "
                         f"expected one of {tuple(BWD_BODIES)} or None")
    return BWD_BODIES[body]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The forward kernel's library, built at first use."""
    lib = _build.load("conv1d_fwd", ("conv1d_fwd.cu",))
    lib.conv1d_fwd.argtypes = [_VP] * 6 + [_I] * 11 + [_VP]
    lib.conv1d_fwd.restype = _I
    lib.conv1d_fwd_tile.argtypes = [_I] * 8
    lib.conv1d_fwd_tile.restype = _I
    lib.conv1d_fwd_error_string.argtypes = [_I]
    lib.conv1d_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The weight-gradient kernel's library, built at first use."""
    lib = _build.load("conv1d_bwd_weight", ("conv1d_bwd_weight.cu",
                                             "hopper.cuh"))
    lib.conv1d_bwd_weight_rows.argtypes = [_I] * 8
    lib.conv1d_bwd_weight_rows.restype = _I
    lib.conv1d_bwd_weight_body.argtypes = [_I] * 8
    lib.conv1d_bwd_weight_body.restype = _I
    lib.conv1d_bwd_weight.argtypes = [_VP] * 5 + [_I] * 9 + [_VP]
    lib.conv1d_bwd_weight.restype = _I
    lib.conv1d_bwd_weight_error_string.argtypes = [_I]
    lib.conv1d_bwd_weight_error_string.restype = ctypes.c_char_p
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
               activation: str | None = None, save_preact: bool = False,
               dilation: int = 1, out_dtype: torch.dtype | None = None,
               tile: int | None = None):
    """BRGEMM forward: x (N, C, Q + (S-1)*d), w (S, K, C) -> (N, K, Q),
    ``act(conv + bias + residual)`` on the fp32 accumulator, stored in
    ``out_dtype`` (default ``x.dtype``).  With ``save_preact`` returns
    ``(out, preact)``, preact being the fp32 ``conv + bias + residual``.

    x and w are fp32 or bf16 of one dtype; bias (K,) has w's dtype and
    residual (N, K, Q) has x's.  Every tensor is contiguous and on x's
    device; anything else raises.  The same call is the data gradient
    (Alg. 3) on the zero-padded cotangent and the flipped, transposed
    weights (``ops.Conv1dFunction``).  ``tile`` pins the register tile
    (one of ``fwd_tiles(K)``); every tile sums in one order, so the pin
    changes no bit of the result, only the time.
    """
    activation = _ep.canon(activation)
    out_dtype = out_dtype or x.dtype
    tile_code = _tile_code(tile)
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
        if not save_preact:
            return _ref.conv1d_fused_ref(
                x, w, dilation=dilation, bias=bias, activation=activation,
                residual=residual, out_dtype=out_dtype)
        u = _ref.conv1d_preact_ref(x, w, dilation=dilation, bias=bias,
                                   residual=residual)
        return _ep.ACTIVATIONS[activation](u).to(out_dtype), u
    if x.device.type == "meta":
        out = torch.empty((N, K, Q), dtype=out_dtype, device=x.device)
        preact = (torch.empty((N, K, Q), dtype=torch.float32,
                              device=x.device) if save_preact else None)
        _meta.report("conv1d_fwd", _flops.conv1d_flops(N, C, K, S, Q),
                     _meta.nbytes(x, w, bias, residual, out, preact))
        return (out, preact) if save_preact else out
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_fwd runs on cuda (or cpu); got {x.device}")
    if N > 65535:
        raise ValueError(f"batch {N} exceeds the kernel's grid limit 65535")
    out = torch.empty((N, K, Q), dtype=out_dtype, device=x.device)
    preact = (torch.empty((N, K, Q), dtype=torch.float32, device=x.device)
              if save_preact else None)
    lib = _lib()
    rc = lib.conv1d_fwd(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), preact.data_ptr() if save_preact else None,
        N, C, K, S, Wp, dilation, _ep.ACT_CODES[activation],
        _DTYPES[x.dtype], _DTYPES[out_dtype], tile_code, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc == -1:
        raise ValueError(
            f"conv1d_fwd: one channel row of the footprint (span "
            f"{(S - 1) * dilation}) does not fit in shared memory")
    if rc == _REFUSED_PIN:
        raise ValueError(f"conv1d_fwd: tile {tile} may not run C={C} K={K} "
                         f"S={S} dilation={dilation}")
    if rc != 0:
        raise RuntimeError("conv1d_fwd launch failed: "
                           + lib.conv1d_fwd_error_string(rc).decode())
    conv1d_fwd.launches += 1
    return (out, preact) if save_preact else out


conv1d_fwd.launches = 0


def fwd_tile(N: int, C: int, K: int, S: int, Wp: int, dilation: int, *,
             tile: int | None = None, device: int = 0) -> int | None:
    """The tile ``conv1d_fwd`` takes at this shape on GPU ``device``: its
    own choice for ``tile=None``, else the pinned tile if the kernel's rule
    lets it run here; None where the kernel refuses.  Asks the library
    (builds it at first use), so it needs the card."""
    code = _lib().conv1d_fwd_tile(N, C, K, S, Wp, dilation,
                                  _tile_code(tile), device)
    return code if code > 0 else None


# conv1d_bwd_weight's negative return codes: shapes it does not take
_BWD_REFUSED = {
    -1: "the footprint (all channels of one column tile) does not fit in "
        "shared memory",
    -2: "the shape exceeds the kernel's grid limits",
    _REFUSED_PIN: "the pinned body may not run this shape (the taps body "
                  "needs K > 1 with C > 1 and dilation % 4 == 0, or K == 1 "
                  "with S <= 64)",
}


def _bwd_failed(lib, rc: int) -> Exception:
    if rc in _BWD_REFUSED:
        return ValueError(f"conv1d_bwd_weight: {_BWD_REFUSED[rc]}")
    if rc == -3:
        return RuntimeError("conv1d_bwd_weight: the device's SM count "
                            "could not be read")
    return RuntimeError("conv1d_bwd_weight launch failed: "
                        + lib.conv1d_bwd_weight_error_string(rc).decode())


def channel_ranges(C: int, fits) -> list[tuple[int, int]]:
    """[0, C) as the fewest contiguous channel ranges of near-equal width
    that ``fits(width)`` accepts (``fits`` is monotone: a width that fits
    has every smaller one fit).  Raises if one channel does not fit."""
    if fits(C):
        return [(0, C)]
    lo, hi = 1, C - 1  # the widest range that fits, by bisection
    if not fits(lo):
        raise ValueError("conv1d_bwd_weight: " + _BWD_REFUSED[-1])
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    n = -(-C // lo)
    edges = [C * i // n for i in range(n + 1)]
    return list(zip(edges, edges[1:]))


def by_channel_ranges(x: torch.Tensor, ranges, launch, with_dbias: bool):
    """The weight gradient assembled from one ``launch(x_range,
    with_dbias)`` per channel range of x (each range copied contiguous):
    dw's channels are independent sums, so the ranges' dw concatenate
    along C; dbias, which reads the cotangent alone, comes with the first
    range."""
    parts = [launch(x[:, c0:c1].contiguous(), with_dbias and i == 0)
             for i, (c0, c1) in enumerate(ranges)]
    if not with_dbias:
        return torch.cat(parts, dim=2)
    dbias = parts[0][1]
    return torch.cat([parts[0][0]] + parts[1:], dim=2), dbias


def conv1d_bwd_weight(x: torch.Tensor, gout: torch.Tensor, *, S: int,
                      dilation: int = 1, with_dbias: bool = False,
                      body: str | None = None):
    """BRGEMM weight gradient (Alg. 4): x (N, C, Q + (S-1)*d), gout
    (N, K, Q) -> dw (S, K, C) fp32, ``dw[s,k,c] = sum_{n,q} gout[n,k,q] *
    x[n,c,q+s*d]``.  ``with_dbias`` also returns the fused bias gradient
    ``dbias[k] = sum_{n,q} gout[n,k,q]`` (K,) fp32: ``(dw, dbias)``.

    x and gout are fp32 or bf16 of one dtype, contiguous and on one
    device; anything else raises.  On the card the sums over the batch and
    the width are a split reduction in a fixed order (no atomics): two
    launches on the same inputs give bitwise equal results.  ``body`` pins
    the body (``"unit"`` or ``"taps"``); the two sum in different orders,
    so a pin may change dw within rounding.

    The kernel stages every channel of a column tile in shared memory;
    where they do not fit (fp32 beyond about 100 channels at S=3, d=1, as
    Whisper's frontend), the channels go in the fewest ranges that do
    (``channel_ranges``), one launch each, every launch reading the whole
    cotangent (``by_channel_ranges``).
    """
    body_code = _body_code(body)
    if x.dim() != 3 or gout.dim() != 3:
        raise ValueError(f"x must be (N, C, W) and gout (N, K, Q); got "
                         f"{tuple(x.shape)} and {tuple(gout.shape)}")
    N, C, Wp = x.shape
    K, Q = gout.shape[1:]
    if S < 1 or dilation < 1:
        raise ValueError(f"S and dilation must be >= 1, got {S}, {dilation}")
    if Q <= 0 or Wp != Q + (S - 1) * dilation:
        raise ValueError(f"x width {Wp} != gout width {Q} + (S-1)*d = "
                         f"{Q + (S - 1) * dilation}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv1d_bwd_weight takes fp32/bf16; got {x.dtype}")
    _check("x", x, (N, C, Wp), x.dtype, x.device)
    _check("gout", gout, (N, K, Q), x.dtype, x.device)
    if x.device.type == "cpu":
        dw = _ref.conv1d_bwd_weight_ref(x, gout, dilation=dilation)
        return (dw, _ref.conv1d_dbias_ref(gout)) if with_dbias else dw
    if x.device.type == "meta":
        dw = torch.empty((S, K, C), dtype=torch.float32, device=x.device)
        dbias = (torch.empty(K, dtype=torch.float32, device=x.device)
                 if with_dbias else None)
        _meta.report("conv1d_bwd_weight", _flops.conv1d_flops(N, C, K, S, Q)
                     + (N * K * Q if with_dbias else 0),
                     _meta.nbytes(x, gout, dw, dbias))
        return (dw, dbias) if with_dbias else dw
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_bwd_weight runs on cuda (or cpu); got "
                         f"{x.device}")
    lib = _bwd_lib()
    dev = x.device.index

    def rows_of(c: int) -> int:
        return lib.conv1d_bwd_weight_rows(N, c, K, S, Wp, dilation,
                                          body_code, dev)

    def launch(xc: torch.Tensor, dbias: bool):
        return _bwd_weight_launch(lib, xc, gout, S, dilation, dbias,
                                  body_code, rows_of(xc.shape[1]))

    rows = rows_of(C)
    if rows == -1 and C > 1:
        return by_channel_ranges(
            x, channel_ranges(C, lambda c: rows_of(c) >= 0), launch,
            with_dbias)
    return launch(x, with_dbias)


def _bwd_weight_launch(lib, x: torch.Tensor, gout: torch.Tensor, S: int,
                       dilation: int, with_dbias: bool, body_code: int,
                       rows: int):
    """One launch of the weight-gradient kernel (and its ``reduce_partials``
    pass) on checked operands; ``rows`` is the plan's partial rows."""
    N, C, Wp = x.shape
    K = gout.shape[1]
    dev = x.device.index
    if rows < 0:
        raise _bwd_failed(lib, rows)
    row_len = S * K * C + (K if with_dbias else 0)
    partial = torch.empty(rows * row_len, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((S, K, C), dtype=torch.float32, device=x.device)
    dbias = (torch.empty(K, dtype=torch.float32, device=x.device)
             if with_dbias else None)
    rc = lib.conv1d_bwd_weight(
        x.data_ptr(), gout.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        dbias.data_ptr() if with_dbias else None, N, C, K, S, Wp, dilation,
        _DTYPES[x.dtype], body_code, dev,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise _bwd_failed(lib, rc)
    conv1d_bwd_weight.launches += 1
    return (dw, dbias) if with_dbias else dw


conv1d_bwd_weight.launches = 0


def bwd_weight_body(N: int, C: int, K: int, S: int, Wp: int, dilation: int,
                    *, body: str | None = None,
                    device: int = 0) -> str | None:
    """The body ``conv1d_bwd_weight`` takes at this shape on GPU
    ``device``: its own choice for ``body=None``, else the pinned body if
    the kernel's rule lets it run here; None where the kernel refuses.
    Asks the library (builds it at first use), so it needs the card."""
    code = _bwd_lib().conv1d_bwd_weight_body(N, C, K, S, Wp, dilation,
                                             _body_code(body), device)
    return next((b for b, c in BWD_BODIES.items() if c == code), None)


# --- depthwise (C == K): the Mamba2 causal conv ---------------------------

# the most taps the depthwise kernels take (they keep the taps in registers)
DW_MAX_TAPS = 8
# the depthwise kernels' negative return codes: shapes they do not take
_DW_REFUSED = {
    -2: f"more than {DW_MAX_TAPS} taps (the kernels keep the taps in "
        "registers)",
    -3: "the batch exceeds the kernel's grid limit 65535",
}


@functools.cache
def _dw_lib() -> ctypes.CDLL:
    """The depthwise forward kernel's library, built at first use."""
    lib = _build.load("depthwise_conv1d_fwd", ("depthwise_conv1d_fwd.cu",))
    lib.depthwise_conv1d_fwd.argtypes = [_VP] * 6 + [_I] * 9 + [_VP]
    lib.depthwise_conv1d_fwd.restype = _I
    lib.depthwise_conv1d_fwd_error_string.argtypes = [_I]
    lib.depthwise_conv1d_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _dw_bwd_lib() -> ctypes.CDLL:
    """The depthwise weight-gradient kernel's library, built at first use."""
    lib = _build.load("depthwise_conv1d_bwd_weight",
                      ("depthwise_conv1d_bwd_weight.cu",))
    lib.depthwise_conv1d_bwd_weight_rows.argtypes = [_I] * 2
    lib.depthwise_conv1d_bwd_weight_rows.restype = _I
    lib.depthwise_conv1d_bwd_weight.argtypes = [_VP] * 5 + [_I] * 8 + [_VP]
    lib.depthwise_conv1d_bwd_weight.restype = _I
    lib.depthwise_conv1d_bwd_weight_error_string.argtypes = [_I]
    lib.depthwise_conv1d_bwd_weight_error_string.restype = ctypes.c_char_p
    return lib


def _dw_failed(name: str, lib, rc: int) -> Exception:
    if rc in _DW_REFUSED:
        return ValueError(f"{name}: {_DW_REFUSED[rc]}")
    return RuntimeError(f"{name} launch failed: "
                        + getattr(lib, f"{name}_error_string")(rc).decode())


def depthwise_conv1d_fwd(x: torch.Tensor, w: torch.Tensor, *,
                         bias: torch.Tensor | None = None,
                         residual: torch.Tensor | None = None,
                         activation: str | None = None,
                         save_preact: bool = False, dilation: int = 1,
                         out_dtype: torch.dtype | None = None):
    """Depthwise forward: x (N, C, Q + (S-1)*d), w (S, C) -> (N, C, Q),
    ``act(conv + bias + residual)`` on the fp32 accumulator, stored in
    ``out_dtype`` (default ``x.dtype``).  With ``save_preact`` returns
    ``(out, preact)``, preact being the fp32 ``conv + bias + residual``.

    x and w are fp32 or bf16 of one dtype; bias (C,) has w's dtype and
    residual (N, C, Q) has x's.  Every tensor is contiguous and on x's
    device; anything else raises, as do more than 8 taps on the card.  The
    same call is the data gradient on the zero-padded cotangent and the
    flipped taps ``w.flip(0)`` (``ops.DepthwiseConv1dFunction``).
    """
    activation = _ep.canon(activation)
    out_dtype = out_dtype or x.dtype
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"x must be (N, C, W) and w (S, C); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, C, Wp = x.shape
    S, Cw = w.shape
    if Cw != C:
        raise ValueError(f"weight has C={Cw} but input has C={C}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    Q = Wp - (S - 1) * dilation
    if Q <= 0:
        raise ValueError(f"width {Wp} too small for S={S}, "
                         f"dilation={dilation}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"depthwise_conv1d_fwd takes fp32/bf16; got x "
                         f"{x.dtype}, out {out_dtype}")
    _check("x", x, (N, C, Wp), x.dtype, x.device)
    _check("w", w, (S, C), x.dtype, x.device)
    _check("bias", bias, (C,), w.dtype, x.device)
    _check("residual", residual, (N, C, Q), x.dtype, x.device)
    if x.device.type == "cpu":
        u = _ref.depthwise_conv1d_preact_ref(x, w, dilation=dilation,
                                             bias=bias, residual=residual)
        y = _ep.ACTIVATIONS[activation](u).to(out_dtype)
        return (y, u) if save_preact else y
    if x.device.type == "meta":
        out = torch.empty((N, C, Q), dtype=out_dtype, device=x.device)
        preact = (torch.empty((N, C, Q), dtype=torch.float32,
                              device=x.device) if save_preact else None)
        _meta.report("depthwise_conv1d_fwd",
                     _flops.conv1d_flops(N, C, 1, S, Q),
                     _meta.nbytes(x, w, bias, residual, out, preact))
        return (out, preact) if save_preact else out
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d_fwd runs on cuda (or cpu); got "
                         f"{x.device}")
    out = torch.empty((N, C, Q), dtype=out_dtype, device=x.device)
    preact = (torch.empty((N, C, Q), dtype=torch.float32, device=x.device)
              if save_preact else None)
    lib = _dw_lib()
    rc = lib.depthwise_conv1d_fwd(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), preact.data_ptr() if save_preact else None,
        N, C, S, Wp, dilation, _ep.ACT_CODES[activation], _DTYPES[x.dtype],
        _DTYPES[out_dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise _dw_failed("depthwise_conv1d_fwd", lib, rc)
    depthwise_conv1d_fwd.launches += 1
    return (out, preact) if save_preact else out


depthwise_conv1d_fwd.launches = 0


def depthwise_conv1d_bwd_weight(x: torch.Tensor, gout: torch.Tensor, *,
                                S: int, dilation: int = 1,
                                with_dbias: bool = False):
    """Depthwise weight gradient: x (N, C, Q + (S-1)*d), gout (N, C, Q) ->
    dw (S, C) fp32, ``dw[s,c] = sum_{n,q} gout[n,c,q] * x[n,c,q+s*d]``.
    ``with_dbias`` also returns the fused bias gradient ``dbias[c] =
    sum_{n,q} gout[n,c,q]`` (C,) fp32: ``(dw, dbias)``.

    x and gout are fp32 or bf16, each in its own dtype (the kernel widens
    each as it reads it), contiguous and on one device; anything else
    raises, as do more than 8 taps on the card.  On the card the sums are a
    split reduction in a fixed order (no atomics): two launches on the
    same inputs give bitwise equal results.
    """
    if x.dim() != 3 or gout.dim() != 3:
        raise ValueError(f"x must be (N, C, W) and gout (N, C, Q); got "
                         f"{tuple(x.shape)} and {tuple(gout.shape)}")
    N, C, Wp = x.shape
    Q = gout.shape[-1]
    if S < 1 or dilation < 1:
        raise ValueError(f"S and dilation must be >= 1, got {S}, {dilation}")
    if Q <= 0 or Wp != Q + (S - 1) * dilation:
        raise ValueError(f"x width {Wp} != gout width {Q} + (S-1)*d = "
                         f"{Q + (S - 1) * dilation}")
    for name, t in (("x", x), ("gout", gout)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"depthwise_conv1d_bwd_weight takes fp32/bf16; "
                             f"got {name} {t.dtype}")
    _check("x", x, (N, C, Wp), x.dtype, x.device)
    _check("gout", gout, (N, C, Q), gout.dtype, x.device)
    if x.device.type == "cpu":
        dw = _ref.depthwise_conv1d_bwd_weight_ref(x, gout, dilation=dilation)
        return (dw, _ref.conv1d_dbias_ref(gout)) if with_dbias else dw
    if x.device.type == "meta":
        dw = torch.empty((S, C), dtype=torch.float32, device=x.device)
        dbias = (torch.empty(C, dtype=torch.float32, device=x.device)
                 if with_dbias else None)
        _meta.report("depthwise_conv1d_bwd_weight",
                     _flops.conv1d_flops(N, C, 1, S, Q)
                     + (N * C * Q if with_dbias else 0),
                     _meta.nbytes(x, gout, dw, dbias))
        return (dw, dbias) if with_dbias else dw
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d_bwd_weight runs on cuda (or "
                         f"cpu); got {x.device}")
    lib = _dw_bwd_lib()
    rows = lib.depthwise_conv1d_bwd_weight_rows(N, Q)
    row_len = S * C + (C if with_dbias else 0)
    partial = torch.empty(rows * row_len, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((S, C), dtype=torch.float32, device=x.device)
    dbias = (torch.empty(C, dtype=torch.float32, device=x.device)
             if with_dbias else None)
    rc = lib.depthwise_conv1d_bwd_weight(
        x.data_ptr(), gout.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        dbias.data_ptr() if with_dbias else None, N, C, S, Wp, dilation,
        _DTYPES[x.dtype], _DTYPES[gout.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise _dw_failed("depthwise_conv1d_bwd_weight", lib, rc)
    depthwise_conv1d_bwd_weight.launches += 1
    return (dw, dbias) if with_dbias else dw


depthwise_conv1d_bwd_weight.launches = 0
