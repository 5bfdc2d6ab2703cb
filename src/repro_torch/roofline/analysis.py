"""The card's peaks, the least time a call could take, and the dry-run's
counting (counterpart of ``repro/roofline/analysis.py``).

Peaks of an NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): 67 TFLOP/s fp32 outside the tensor cores, 495 TFLOP/s TF32
and 989 TFLOP/s bf16 in them, 3.35 TB/s of HBM3, 80 GB of it.  A card
set below 700 W runs slower under load; a share of these peaks is stated
with the card's power limit beside it.  Links (NVIDIA's H100 SXM and
DGX H100 data sheets): NVLink 4 moves 450 GB/s each way between the 8
cards of a node; between nodes each card has one 400 Gb/s NIC, 50 GB/s.

``bound`` is the least time of a call: the larger of its bytes (each
input read once, each output written once) over the memory rate and its
operations over the peak of their type.

The counting half (``launch/dryrun.py``).  JAX's dry-run compiles each
cell for 256 or 512 placeholder devices and reads the per-device module:
``cost_analysis`` for FLOPs, the HLO text for traffic
(``hlo_traffic_bytes``) and collectives (``collective_bytes``),
``memory_analysis`` for memory.  The port has no compiler and no HLO:
it builds ONE rank of a cell on the ``meta`` device (no memory, no
values) and runs its step under :class:`Counter`, a
``TorchDispatchMode`` that sees every ATen operation the rank runs:

  * ``flops`` as ``HloCostAnalysis`` counts them: 2·M·N·K a product
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``, a convolution), one an
    output element of an elementwise operation, one an input element of
    a reduction (softmax, sort and scan included); ``dot_flops`` the
    products alone.  A kernel wrapper reports its kernel's work from
    its ``meta`` branch (``kernels/meta.py``): added to both, and kept
    by kernel in ``kernels`` with its calls;
  * ``bytes``: the operand and output bytes of every operation that
    runs (views and ``empty`` move nothing), the wrappers' kernels'
    bytes, and the step's arguments once, as ``hlo_traffic_bytes`` adds
    the entry parameters.  Eager PyTorch fuses nothing, so this is the
    port's own traffic, not an upper bound;
  * the collectives, from the ``sharding.CountingGroup`` stand-ins the
    rank was placed over: bytes by kind and by mesh axis.  The port's
    collectives are its explicit ones (``ModelGroup.sum``/``gather``,
    ``DataShards``' gathers); GSPMD picks its own, so the two agree in
    kind, not to the byte;
  * memory: ``arg_bytes`` the rank's parameters, cache and batch
    (exact, from their shapes), and ``peak_bytes`` the most bytes alive
    at once beyond them (:class:`Counter` adds a new storage's bytes
    when an operation makes it and takes them off when it is freed, a
    ``weakref`` finalizer on the storage), JAX's
    ``memory_analysis().temp_size_in_bytes``; ``fits`` their sum
    against the card's 80 GB.

Eager PyTorch has no ``lax.scan``: a layer loop, the chunked attention's
q-chunks and the SSD's inter-chunk recurrence are Python loops, each
step counted.  So the probes' premise (a scan's body counted once) does
not hold, and nothing needs re-adding: :func:`ssd_scan_correction` and
:func:`flash_correction` keep JAX's formulas for comparison only (the
flash kernels' work is reported by their wrappers).  :func:`probe_plan`
and :func:`extrapolate` stay as a way to save time: a probe of one or
two layers counts exactly what a layer adds, and ``extrapolate``
reproduces the full depth's count exactly
(``tests/test_torch_dryrun.py``).

There is no placement compiler either: nothing runs the other 255 or 511
ranks, and the count is one rank's (``launch/specs.py`` takes the rank
at the mesh's origin).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta as _kmeta


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


# --- the links and the card's memory --------------------------------------

NVLINK_BW = 450e9       # bytes/s each way, between the 8 cards of a node
NIC_BW = 50e9           # bytes/s, one 400 Gb/s NIC a card, between nodes
GPUS_PER_NODE = 8
HBM_PER_CARD = 80e9     # bytes, an H100 SXM's


def axis_rate(mesh, axes, gpus_per_node: int = GPUS_PER_NODE) -> float:
    """The slowest link a group over ``axes`` (a name, or names joined by
    commas or in a tuple) of ``mesh`` crosses, ranks laid out row-major
    over the mesh, ``gpus_per_node`` a node: NVLink where the group's
    ranks span one node, else the NIC.  On (16, 16) the model axis spans
    two nodes and the data axis 16."""
    if isinstance(axes, str):
        axes = tuple(a for a in axes.split(",") if a)
    names = list(mesh.axis_names)
    span = 1
    for a in axes:
        stride = math.prod(mesh.shape[b] for b in names[names.index(a) + 1:])
        span += (mesh.shape[a] - 1) * stride
    return NVLINK_BW if span <= gpus_per_node else NIC_BW


# --- counting one rank's step ----------------------------------------------

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
             _aten.convolution}
_REDUCTIONS = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max,
               _aten.min, _aten.prod, _aten.var, _aten.std,
               _aten.var_mean, _aten.argmax, _aten.argmin,
               _aten.logsumexp, _aten.norm, _aten.linalg_vector_norm,
               _aten._softmax, _aten._log_softmax, _aten.cumsum,
               _aten.topk, _aten.sort, _aten.argsort, _aten.any,
               _aten.all, _aten.searchsorted}
# operations that move no bytes: metadata, and memory handed out unwritten
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
             _aten.detach, _aten.alias, _aten.lift_fresh}
_CIA = torch._C.DispatchKey.CompositeImplicitAutograd


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()


def tensor_bytes(tree) -> int:
    """The bytes of the tensors of ``tree`` (a tensor, a module, or
    nested lists, tuples and dicts of them), each storage once."""
    seen, n = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def _product_flops(func, args, out) -> float:
    packet = func.overloadpacket
    if packet is _aten.convolution:
        w = args[1]
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    a, b = (args[1], args[2]) if packet in (_aten.addmm,
                                            _aten.baddbmm) else args[:2]
    return 2.0 * a.numel() * b.shape[-1]


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class Counter(TorchDispatchMode):
    """Counts what one rank's step runs (module docstring): ``flops``,
    ``dot_flops``, ``bytes`` (the operations' and the kernels', not yet
    the arguments'), ``kernels`` (name -> calls, flops, bytes) and the
    live-bytes ``peak`` of the storages made inside (``live`` now).
    Storages of ``known`` tensors (the arguments) are never counted as
    made.  A composite operation is decomposed, as ``FakeTensorMode``
    does, so a product inside ``matmul`` or ``einsum`` is counted as
    one.  Operations under ``kernels.meta.quiet`` make memory but no
    work."""

    def __init__(self, known=()):
        super().__init__()
        self.flops = self.dot_flops = self.bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.ops = 0
        self.live = self.peak = 0
        self._depth = 0
        self._known = {t.untyped_storage()._cdata for t in _tensors(known)}
        self._mine: dict[int, int] = {}

    # kernels.meta listener
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, dict(calls=0, flops=0.0,
                                               bytes=0.0))
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.dot_flops += flops
        self.bytes += nbytes

    def __enter__(self):
        # re-entered by each decomposition: listen once, at the outermost
        if self._depth == 0:
            _kmeta._listeners.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                _kmeta._listeners.remove(self)

    def _free(self, key: int) -> None:
        self.live -= self._mine.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._mine:
                continue
            n = st.nbytes()
            self._mine[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _CIA):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._track(out)
        if _kmeta.is_quiet():
            return out
        self.ops += 1
        packet = func.overloadpacket
        if packet in _PRODUCTS:
            f = _product_flops(func, args, out)
            self.flops += f
            self.dot_flops += f
        elif packet in _REDUCTIONS:
            self.flops += sum(t.numel() for t in _tensors(args[:1]))
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in _tensors(out))
        if packet in _NO_BYTES or _is_view(func):
            return out
        self.bytes += sum(t.numel() * t.element_size() for t in
                          _tensors((args, kwargs, out)))
        return out


def collective_counts(calls) -> dict:
    """Bytes of ``calls`` (``CountingGroup.calls`` entries, ``(kind, axis,
    bytes)``): ``by_kind`` (JAX's kinds), ``by_axis``, ``count`` and
    ``total``."""
    by_kind = {k: 0 for k in ("all-gather", "all-reduce", "reduce-scatter")}
    by_axis: dict[str, int] = {}
    count = 0
    for kind, axis, n in calls:
        by_kind[kind] += n
        by_axis[axis] = by_axis.get(axis, 0) + n
        count += 1
    return dict(by_kind=by_kind, by_axis=by_axis, count=count,
                total=sum(by_kind.values()))


def count_step(fn, args, groups=(), arg_bytes: int | None = None) -> dict:
    """Run ``fn(*args)`` (one rank's step, on ``meta`` or a real device)
    under a :class:`Counter` and count it: ``flops``, ``dot_flops``,
    ``bytes`` (the arguments' bytes added once), ``coll_bytes`` and
    ``coll_by_kind``/``coll_by_axis`` from ``groups``' calls made during
    the step, ``kernels``, ``arg_bytes`` (``tensor_bytes(args)`` unless
    given), ``peak_bytes`` (beyond the arguments) and ``ops``."""
    groups = [g for g in groups if g is not None]
    marks = [len(g.calls) for g in groups]
    counter = Counter(known=args)
    with counter:
        fn(*args)
    coll = collective_counts(c for g, m in zip(groups, marks)
                             for c in g.calls[m:])
    n_args = tensor_bytes(args) if arg_bytes is None else arg_bytes
    return dict(flops=counter.flops, dot_flops=counter.dot_flops,
                bytes=counter.bytes + n_args, coll_bytes=float(coll["total"]),
                coll_by_kind=coll["by_kind"], coll_by_axis=coll["by_axis"],
                coll_count=coll["count"], kernels=counter.kernels,
                arg_bytes=n_args, peak_bytes=counter.peak, ops=counter.ops)


def fits(arg_bytes: float, peak_bytes: float,
         capacity: float = HBM_PER_CARD) -> bool:
    """Whether a rank's arguments and the most bytes alive beyond them fit
    on one card."""
    return arg_bytes + peak_bytes <= capacity


# --- probe plans (JAX's, by name) -------------------------------------------

class Probe(NamedTuple):
    cfg: Any        # reduced depth
    shape: Any      # possibly reduced-batch ShapeConfig
    accum: int      # grad-accum steps (train probes; 1 otherwise)


def _probe_cfg(cfg, **depth):
    return dataclasses.replace(cfg, **depth)


def probe_plan(cfg, shape, accum_full: int):
    """Returns (probes, rows, full_row), JAX's plan: counting each probe
    and solving ``rows @ coef = metrics`` gives per-layer-type costs; the
    true cell's metric is ``full_row @ coef``.  The port's probes are the
    config at reduced depth (eager PyTorch unrolls every loop already)."""
    r = dataclasses.replace
    train = shape.kind == "train"
    if cfg.family == "conv":
        return [Probe(cfg, shape, accum_full)], [[1.0]], [1.0]

    mb = shape.global_batch // accum_full if train else shape.global_batch
    A = accum_full

    def probe(accum=1, **depth):
        sh = r(shape, global_batch=accum * mb) if train else shape
        return Probe(_probe_cfg(cfg, **depth), sh, accum if train else 1)

    if cfg.family == "moe" and cfg.moe.first_dense_layers > 0:
        nd, nm = (cfg.moe.first_dense_layers,
                  cfg.n_layers - cfg.moe.first_dense_layers)
        m = cfg.moe

        def dep(d, L):
            return dict(n_layers=L, moe=r(m, first_dense_layers=d))
        probes = [probe(1, **dep(1, 2)), probe(1, **dep(1, 3)),
                  probe(1, **dep(2, 3))]
        rows = [[1, 1, 1, 1], [1, 1, 1, 2], [1, 1, 2, 1]]
        if train:
            probes.append(probe(2, **dep(1, 2)))
            rows.append([1, 2, 2, 2])
        else:
            rows = [row[:1] + row[2:] for row in rows]
        full = [1, A, A * nd, A * nm] if train else [1, nd, nm]
        return probes, rows, full

    if cfg.family == "encdec":
        def dep(e, d):
            return dict(n_encoder_layers=e, n_layers=d)
        probes = [probe(1, **dep(1, 1)), probe(1, **dep(2, 1)),
                  probe(1, **dep(1, 2))]
        rows = [[1, 1, 1, 1], [1, 1, 2, 1], [1, 1, 1, 2]]
        if train:
            probes.append(probe(2, **dep(1, 1)))
            rows.append([1, 2, 2, 2])
        else:
            rows = [row[:1] + row[2:] for row in rows]
        full = ([1, A, A * cfg.n_encoder_layers, A * cfg.n_layers] if train
                else [1, cfg.n_encoder_layers, cfg.n_layers])
        return probes, rows, full

    if cfg.family == "hybrid":
        a = cfg.attn_every
        napp_full = len([i for i in range(cfg.n_layers) if i % a == a - 1])
        probes = [probe(1, n_layers=a), probe(1, n_layers=a + 1),
                  probe(1, n_layers=2 * a)]
        rows = [[1, 1, a, 1], [1, 1, a + 1, 1], [1, 1, 2 * a, 2]]
        if train:
            probes.append(probe(2, n_layers=a))
            rows.append([1, 2, 2 * a, 2])
        else:
            rows = [row[:1] + row[2:] for row in rows]
        full = ([1, A, A * cfg.n_layers, A * napp_full] if train
                else [1, cfg.n_layers, napp_full])
        return probes, rows, full

    probes = [probe(1, n_layers=1), probe(1, n_layers=2)]
    rows = [[1, 1, 1], [1, 1, 2]]
    if train:
        probes.append(probe(2, n_layers=1))
        rows.append([1, 2, 2])
    else:
        rows = [row[:1] + row[2:] for row in rows]
    full = [1, A, A * cfg.n_layers] if train else [1, cfg.n_layers]
    return probes, rows, full


EXTRAPOLATED = ("flops", "dot_flops", "bytes", "bytes_raw", "coll_bytes")


def extrapolate(probe_metrics: list[dict], rows: list[list[float]],
                full_row: list[float], keys=None) -> dict[str, float]:
    """Linear solve per metric; returns full-depth metrics: each of
    ``keys`` (default: those of :data:`EXTRAPOLATED` every probe has)."""
    if keys is None:
        keys = [k for k in EXTRAPOLATED if all(k in m for m in probe_metrics)]
    A = np.asarray(rows, np.float64)
    f = np.asarray(full_row, np.float64)
    out = {}
    for k in keys:
        b = np.asarray([m[k] for m in probe_metrics], np.float64)
        coef, *_ = np.linalg.lstsq(A, b, rcond=None)
        out[k] = float(max(0.0, f @ coef))
    return out


def flash_correction(cfg, shape, n_chips: int) -> dict[str, float]:
    """JAX's analytic term for ``attn_impl='flash'`` cells (its probe
    lowers flash as a traffic surrogate and re-adds the kernel's
    products): the same formula.  The port's flash wrappers report their
    kernels' work from their ``meta`` branches, so the dry-run adds
    nothing; this is the term those reports are held against."""
    from repro_torch.roofline import flops as rf
    if getattr(cfg, "attn_impl", "chunked") != "flash" \
            or shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0}
    B, T = shape.global_batch, shape.seq_len
    fwd = rf._attn_seq_flops(cfg, B, T, causal=True)
    if shape.kind == "train":
        mult = 4.0 if cfg.remat else 3.0
        qkv_bytes = 2 * B * T * (cfg.n_heads * cfg.head_dim
                                 + 2 * cfg.n_kv_heads * cfg.head_dim) \
            * cfg.n_layers
        extra_bytes = 2.0 * qkv_bytes
    else:
        mult, extra_bytes = 1.0, 0.0
    return {"flops": fwd * mult / n_chips,
            "bytes": extra_bytes / n_chips, "coll_bytes": 0.0}


def ssd_scan_correction(cfg, shape, n_chips: int) -> dict[str, float]:
    """JAX's re-added traffic of the SSD inter-chunk recurrence, which
    its cost analysis sees once but runs T/chunk times: the same formula.
    The port's recurrence is a Python loop whose every step the counter
    sees, so the dry-run adds nothing; this is JAX's term, for
    comparison."""
    if cfg.family not in ("ssm", "hybrid") or shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0}
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    nc = shape.seq_len // s.chunk
    state_elems = shape.global_batch * H * s.d_state * s.head_dim / n_chips
    passes = 3 if shape.kind == "train" else 1
    extra = cfg.n_layers * max(0, nc - 1) * 3 * state_elems * 4 * passes
    return {"flops": cfg.n_layers * nc * 3 * state_elems * passes,
            "bytes": extra, "coll_bytes": 0.0}


# --- terms -----------------------------------------------------------------

def roofline_terms(metrics: dict[str, float], n_chips: int,
                   model_flops: float, model_bytes: float = 0.0, *,
                   peak_flops: float = H100.bfloat16,
                   hbm_bw: float = H100.bytes_per_s,
                   link_bw: float = NIC_BW, mesh=None) -> dict[str, float]:
    """JAX's terms: metrics are PER-DEVICE, model_flops/model_bytes
    GLOBAL useful work per step; ``roofline_fraction`` = (the ideal
    time, the larger of the compute and memory floors) / (the time the
    dominant term forces).  The peaks default to the H100's (bf16 tensor
    cores, HBM3); the collective term is ``coll_bytes`` over ``link_bw``
    (default the NIC's), or with a ``mesh`` and ``coll_by_axis`` in the
    metrics each axis's bytes over the slowest link it crosses
    (:func:`axis_rate`), summed.  JAX's constants passed in give JAX's
    numbers."""
    compute_s = metrics["flops"] / peak_flops
    memory_s = metrics["bytes"] / hbm_bw
    if mesh is not None and "coll_by_axis" in metrics:
        coll_s = sum(n / axis_rate(mesh, axis)
                     for axis, n in metrics["coll_by_axis"].items())
    else:
        coll_s = metrics["coll_bytes"] / link_bw
    dominant_s = max(compute_s, memory_s, coll_s)
    names = {coll_s: "collective", memory_s: "memory", compute_s: "compute"}
    ideal_compute_s = model_flops / (n_chips * peak_flops)
    ideal_memory_s = model_bytes / (n_chips * hbm_bw)
    ideal_s = max(ideal_compute_s, ideal_memory_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": names[dominant_s],
        "dominant_s": dominant_s,
        "model_flops": model_flops,
        "ideal_compute_s": ideal_compute_s,
        "ideal_memory_s": ideal_memory_s,
        "hlo_flops_global": metrics["flops"] * n_chips,
        "useful_ratio": model_flops / max(metrics["flops"] * n_chips, 1.0),
        "roofline_fraction": ideal_s / max(dominant_s, 1e-30),
    }
