"""Analytic ranking of tuner candidates on an H100 (counterpart of
``repro/tune/cost.py``, re-derived for this card; the TPU's matrix-unit
and VMEM terms do not come across).

One pass of one candidate costs

    max(flops / peak(body), bytes / HBM rate) / eff + launches x LAUNCH_SEC

  * ``flops`` is the work the body does, padding included: the register
    tile pads the filters to a multiple of KT and the columns to its
    column tile TQ (``conv1d_fwd``); the bwd-weight bodies pad their
    (tap, channel) rows to wgmma's 64 and their filters to 16 (``taps``
    also puts 13 taps, or 64 for one filter, in wgmma's N).  The grid's
    last wave is charged whole: blocks over 132 SMs at the kernel's
    blocks an SM.
  * ``peak(body)``: ``conv1d_fwd`` runs fp32 FMAs for both dtypes (bf16 is
    widened as it is staged), 67 TFLOP/s; ``conv1d_bwd_weight`` runs TF32
    wgmma, three terms for fp32 and one for bf16, 495 TFLOP/s; cuDNN
    (``library``) runs fp32 on FMAs (TF32 off) for both dtypes, bf16
    widened first, as the JAX package's ``xla`` computes.
  * ``eff`` is the share of that peak each body reached on the card, each
    constant naming its PERF.md row; it only has to rank candidates.

Off the card (device kind "cpu") the host runs ``ref`` and ``library``,
ranked by coarse host shares of a nominal host rate so the library
(oneDNN) comes first, as the JAX package's ``xla`` does there.

On the card ``tune`` times every legal candidate (at most five a pass),
so the model decides alone only where nothing is measured
(``python -m repro_torch.tune`` without ``--measure``, or ``top_k``);
the sweep (``tune.sweep``) reports how often its first pick is the
measured winner.
"""
from __future__ import annotations

import math

from repro_torch.kernels import epilogue as _ep
from repro_torch.roofline.analysis import is_gpu, peaks_for
from repro_torch.roofline.flops import conv1d_flops

from .problem import PASS_BWD_DATA, PASS_BWD_WEIGHT, PASS_FWD, ConvProblem
from .space import Candidate

SMS = 132                 # H100 SXM
LAUNCH_SEC = 3e-6         # a launch's floor in a replayed graph (coarse)

# Shares measured by chip_smoke.py on an H100 80GB HBM3 at 700 W.
# conv1d_fwd, J=6 KT=16 at 15->15 (batch 8 x 60,000): 0.323 ms against its
# 0.164 ms FMA bound, 51% (PERF.md §6 row 1); the share is of the padded
# work (K 15 -> 16), so 51% x 16/15
EFF_FWD = 0.51 * 16 / 15
# conv1d_bwd_weight's taps body at 15->15: 52% of its three-term TF32
# bound (PERF.md §6 row 2), 1.16x padded work
EFF_BWD_W_TAPS = 0.52 * 1.16
# the unit body at fig5 S=51 Q=20,000 (C=K=64, d=1, batch 4): 1.1744 ms
# (the sweep's bwd_weight-unit row in chip_smoke.py's phase 13) against
# the 0.2065 ms this model gives its padded TF32 work
EFF_BWD_W_UNIT = 0.2065 / 1.1744
# cuDNN in fp32, TF32 off, per pass: the median over the 27 cells of
# Figs 4-6 of its FLOP/s over 67 TFLOP/s (the sweep's fwdbwd-library rows,
# ms_fwd / ms_bwd_data / ms_bwd_weight, in phase 13).  The cells spread
# from 0.001 to 0.41, so this ranks only coarsely.
EFF_LIB = {PASS_FWD: 0.1449, PASS_BWD_DATA: 0.089, PASS_BWD_WEIGHT: 0.046}
# the depthwise pair at the Mamba2 layer, against its byte bound: forward
# 80%, bwd-data 86%, bwd-weight 61%; cuDNN 29%, 16%, 31% (PERF.md §6 rows
# 3-4)
EFF_DW = {PASS_FWD: 0.80, PASS_BWD_DATA: 0.86, PASS_BWD_WEIGHT: 0.61}
EFF_DW_LIB = {PASS_FWD: 0.1127 / 0.383, PASS_BWD_DATA: 0.0677 / 0.431,
              PASS_BWD_WEIGHT: 0.0677 / 0.218}
# the host: a nominal rate and the plain version's tap loop against
# oneDNN (ranking only; no share of it is reported)
HOST_FLOPS = 1e11
EFF_REF_HOST, EFF_LIB_HOST = 0.05, 0.5


def fwd_column_tile(J: int, d: int) -> int:
    """Output columns a ``conv1d_fwd`` block covers (``geometry`` in
    csrc/conv1d_fwd.cu: 128 threads in groups of d)."""
    return 128 if J == 1 else (128 // d) * J * d


def register_share(J: int, KT: int) -> float:
    """FMAs among the instructions of one (tap, channel) step of the
    register tile: J*KT FMAs, one load of x and KT/4 float4 loads of w.
    Smaller tiles spend more of the loop on loads."""
    return J * KT / (J * KT + 1 + math.ceil(KT / 4))


def _waves(blocks: int, per_sm: int) -> float:
    """Share of the card's slots the grid keeps busy, last wave whole."""
    slots = SMS * per_sm
    return blocks / (math.ceil(blocks / slots) * slots)


def _fwd_cuda(prob: ConvProblem, tile: int, peaks) -> float:
    J, KT = divmod(tile, 100)
    d = prob.dilation
    q, nf, ctr = prob.q_out, prob.n_filters, prob.contraction
    TQ = fwd_column_tile(J, d)
    qt, kt = math.ceil(q / TQ), math.ceil(nf / KT)
    flops = 2.0 * prob.N * ctr * kt * KT * prob.S * qt * TQ
    blocks = qt * kt * prob.N
    eff = EFF_FWD * register_share(J, KT) / register_share(6, 16)
    t_ops = flops / peaks.flops_per_s("float32") / (eff * _waves(blocks, 2))
    es = prob.dtype_bytes
    nbytes = es * (prob.N * kt * ctr * (q + prob.span) + prob.S * nf * ctr
                   + prob.N * nf * q)
    return max(t_ops, nbytes / peaks.bytes_per_s) + LAUNCH_SEC


def _bwd_weight_cuda(prob: ConvProblem, body: str, peaks) -> float:
    N, C, K, S = prob.N, prob.C, prob.K, prob.S
    if body == "taps":
        rows = C + 1 if K == 1 else C * math.ceil(S / 13) + 1
        cols = 64 if K == 1 else math.ceil(K / 16) * 16 * 13
        eff = EFF_BWD_W_TAPS
    else:
        rows, cols = (C * math.ceil(S / 3) + 1) * 3, math.ceil(K / 16) * 16
        eff = EFF_BWD_W_UNIT
    terms = 3 if prob.dtype == "float32" else 1
    flops = terms * 2.0 * math.ceil(rows / 64) * 64 * cols * N * prob.Q
    tiles = N * math.ceil(prob.Q / 384)
    t_ops = flops / peaks.flops_per_s("tf32") / (
        eff * _waves(min(tiles, SMS), 1))
    parts = min(tiles, SMS)
    nbytes = (prob.dtype_bytes * N * (C * (prob.Q + prob.span) + K * prob.Q)
              + 4 * (2 * parts + 1) * S * K * C)
    return max(t_ops, nbytes / peaks.bytes_per_s) + 2 * LAUNCH_SEC


def _depthwise(prob: ConvProblem, eff: float, peaks) -> float:
    es = prob.dtype_bytes
    x = prob.N * prob.C * (prob.Q + prob.span)
    nbytes = es * (x + prob.N * prob.C * prob.Q) + 4 * prob.S * prob.C
    return nbytes / peaks.bytes_per_s / eff + LAUNCH_SEC


def estimate_seconds(cand: Candidate, prob: ConvProblem, *,
                     device_kind: str) -> float:
    flops = conv1d_flops(prob.N, prob.C, 1 if prob.depthwise else prob.K,
                         prob.S, prob.Q)
    if not is_gpu(device_kind):
        eff = EFF_LIB_HOST if cand.backend == "library" else EFF_REF_HOST
        return flops / HOST_FLOPS / eff
    peaks = peaks_for(device_kind)
    if prob.depthwise:
        table = EFF_DW if cand.backend == "cuda" else EFF_DW_LIB
        return _depthwise(prob, table[prob.pass_], peaks)
    if cand.backend == "cuda":
        if prob.pass_ == PASS_BWD_WEIGHT:
            return _bwd_weight_cuda(prob, cand.body, peaks)
        return _fwd_cuda(prob, cand.tile, peaks)
    # library: cuDNN in fp32, plus one elementwise launch per epilogue
    # operation and, for bf16, the widening of two operands and the
    # rounding of the result
    has_bias, act, has_res = _ep.parse(prob.pass_epilogue)
    launches = (1 + has_bias + has_res + (act != "none")
                + 3 * (prob.dtype != "float32"))
    return (flops / peaks.flops_per_s("float32") / EFF_LIB[prob.pass_]
            + launches * LAUNCH_SEC)


def rank(cands: list[Candidate], prob: ConvProblem, *,
         device_kind: str) -> list[Candidate]:
    """Candidates sorted cheapest-first under the model."""
    return sorted(cands, key=lambda c: estimate_seconds(
        c, prob, device_kind=device_kind))
