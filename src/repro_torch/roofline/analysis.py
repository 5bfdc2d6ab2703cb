"""The card's peaks and the least time a call could take (counterpart of
the peak part of ``repro/roofline/analysis.py``; its compiled-module
parsers wait for ``launch/dryrun.py``).

Peaks of an NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): 67 TFLOP/s fp32 outside the tensor cores, 495 TFLOP/s TF32
and 989 TFLOP/s bf16 in them, 3.35 TB/s of HBM3.  A card set below 700 W
runs slower under load; a share of these peaks is stated with the card's
power limit beside it.

``bound`` is the least time of a call: the larger of its bytes (each
input read once, each output written once) over the memory rate and its
operations over the peak of their type.
"""
from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    float32: float       # FLOP/s, fp32 FMA (no tensor cores)
    tf32: float          # FLOP/s, TF32 tensor cores
    bfloat16: float      # FLOP/s, bf16 tensor cores
    bytes_per_s: float   # device memory

    def flops_per_s(self, kind: str = "float32") -> float:
        """The peak for one type of operation: ``"float32"``, ``"tf32"``
        or ``"bfloat16"``."""
        return getattr(self, kind)


# matched by substring of the lower-cased device name
# (torch.cuda.get_device_name()); the host has no entry
DEVICE_PEAKS = {
    "h100": Peaks(67e12, 495e12, 989e12, 3.35e12),
}
H100 = DEVICE_PEAKS["h100"]


def peaks_for(device_kind: str) -> Peaks:
    """The peaks of a card by its name; raises for the host and for a card
    this table does not know (a share of the wrong peak would be off by
    orders of magnitude with no sign of it)."""
    dk = device_kind.lower()
    for sub, p in DEVICE_PEAKS.items():
        if sub in dk:
            return p
    raise ValueError(f"no peaks known for device {device_kind!r}; known "
                     f"cards: {sorted(DEVICE_PEAKS)}")


def is_gpu(device_kind: str) -> bool:
    """Whether a device kind names a card (anything but the host)."""
    return device_kind.lower() != "cpu"


def achieved_fraction_of_peak(flops: float, sec: float, device_kind: str,
                              kind: str = "float32") -> float:
    """The paper's efficiency: achieved FLOP/s over the peak of the
    operations' type on this card (Figs 4-6); raises for a device
    ``peaks_for`` does not know."""
    return (flops / max(sec, 1e-30)) / peaks_for(device_kind).flops_per_s(
        kind)


def bound(flops: float, nbytes: float, kind: str,
          peaks: Peaks = H100) -> tuple[float, str]:
    """Least time in ms, and what sets it ("operations" or "bytes")."""
    t_mem = nbytes / peaks.bytes_per_s * 1e3
    t_ops = flops / peaks.flops_per_s(kind) * 1e3
    return max(t_mem, t_ops), ("operations" if t_ops >= t_mem else "bytes")


def conv1d_fwd_bound(N: int, C: int, K: int, S: int, Wp: int, Q: int,
                     dtype: str, has_bias: bool, has_res: bool,
                     out_bytes: int, peaks: Peaks = H100) -> tuple[float, str]:
    """Least time of one fused forward layer on an input of padded width
    Wp: x, w, bias and residual read, the output written."""
    es = 4 if dtype == "float32" else 2
    nbytes = (N * C * Wp + S * K * C + K * has_bias + N * K * Q * has_res) * es
    nbytes += N * K * Q * out_bytes
    return bound(2.0 * N * K * C * S * Q, nbytes, dtype, peaks)


def tf32_flops(N: int, C: int, K: int, S: int, Q: int) -> float:
    """The operations of ``conv1d_bwd_weight`` in three TF32 terms: three
    products of the (S*C, K) GEMM over the N*Q columns, counted from the
    function's own work (no padding to the tensor cores' tiles)."""
    return 3 * 2.0 * S * C * K * N * Q
