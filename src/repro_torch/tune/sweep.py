"""The paper's Figures 4-6 on the card: one conv1d layer across C, K, S,
dilation, width and precision, the hand kernels against the vendor
library (counterpart of ``benchmarks/bench_conv1d_sweep.py``).

    PYTHONPATH=src python -m repro_torch.tune.sweep [--figset fig5]
        [--full] [--grad] [--tuned] [--algs] [--check] [--out rows.json]

Per cell (``presets.figset_shapes``: fig4 fp32 C=K=15 d=8, fig5 fp32
C=K=64 d=1, fig6 bf16 C=K=32 d=4; S x Q; batch ``presets.N``; SAME
padding, no epilogue) the forward and the forward + backward of
``ops.conv1d`` run on the hand kernels (``"cuda"``, their own tiles),
on cuDNN (``"library"``: TF32 off, deterministic) and, with ``--tuned``,
on ``"auto"`` after a measured ``tune`` of all three passes into the
cache in use.  Each row gives the device time (graph replay), GFLOP/s,
``efficiency`` (``roofline.flops.conv1d_flops`` per second over the
dtype's peak: 67 TFLOP/s fp32, 989 bf16; forward + backward counts three
times the forward's flops), ``speedup_vs_library``, ``tuned_vs_default``
(the kernels' own tiles over ``"auto"``) and how each pass resolved.
``--grad`` adds each backward pass's own time; ``--algs`` races
``conv1d_bwd_weight``'s two bodies.

Each forward row also gives ``bound_ms``, the least time of the call
(its flops over the dtype's peak or ``conv1d_min_bytes`` over the memory
rate, the larger), and a ``fwd-cudnn`` row times ``F.conv1d`` alone in
the cell's dtype: for bf16 that is cuDNN on its tensor cores, rounding
the sum to bf16, where ``"library"`` computes in fp32 as the JAX
package's ``xla`` does.  With ``--tuned`` every legal candidate of each
pass is timed, and the summary counts the cells where the cost model's
first pick (``cost.rank``) is the measured winner.

``--check`` holds every result against the plain version (outputs at
``TOL``, element by element; gradients at ``BWD_TOL`` of the largest
plain value): the kernels with their own tiles, ``"library"`` and
``"auto"``.  It launches every tile and body the kernels instantiate (a
tile changes no forward bit; a body's dw is bitwise equal on two
launches) unless the kernel's own rule refuses it, and holds each
``"auto"`` result bitwise equal to the same call with its plan pinned.
A failed check raises.

Like the launchers it runs on the card unless asked for the CPU
(``--device cpu``).  There the plain version stands in for the kernels,
times are the host clock and no efficiency or bound is given: a
rehearsal of the control flow, not a measurement.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics

import torch

import torch.nn.functional as F

from repro_torch.kernels import conv1d_brgemm as _k
from repro_torch.kernels import ops
from repro_torch.roofline.analysis import (achieved_fraction_of_peak, bound,
                                           is_gpu, peaks_for)
from repro_torch.roofline.flops import conv1d_flops, conv1d_min_bytes

from . import (PASSES, ConvProblem, as_device, device_kind, get_plan,
               reset_default_cache, tune)
from . import cost as _cost
from . import measure as _measure
from . import space as _space
from .cache import ENV_CACHE_PATH
from .presets import FIGSETS, figset_shapes

# outputs: |kernel - plain| <= atol + rtol * |plain| element by element.
# fp32: sums of up to 3,264 products (the sweep) or 765 (AtacWorks) taken
# in another order; bf16: one rounding of the output (2^-8 relative).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# backward passes: max|kernel - plain| <= BWD_TOL * max|plain|.  fp32: a
# weight-gradient element sums up to 480,000 products (AtacWorks, batch 8
# x 60,000) in another order; bf16: dx is rounded to bf16 at its store.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def cells(figsets=None, *, full: bool = False):
    """(figure, problem dict) of every cell of the named figures."""
    for fig in figsets or FIGSETS:
        for p in figset_shapes(fig, full=full):
            yield fig, p


def _close(label, got, want, tol):
    """max|got - want| <= tol * max|want|; returns max|got - want|."""
    scale = max(want.float().abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{label}: max abs diff {err} > {tol} x "
                             f"max|plain| {scale}")
    return err


def _elementwise(label, got, want, atol, rtol):
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{label}: max abs diff {diff.max().item()} "
                             f"over atol {atol} + rtol {rtol} x |plain|")
    return diff.max().item()


def _same(label, a, b):
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{label}: not bitwise equal")


class _Cell:
    """One cell's operands and calls."""

    def __init__(self, p: dict, device: torch.device, seed: int):
        self.p, self.device = p, device
        N, C, K, S, Q = p["N"], p["C"], p["K"], p["S"], p["Q"]
        dtype = getattr(torch, p["dtype"])
        gen = torch.Generator().manual_seed(seed)
        self.x = torch.randn((N, C, Q), generator=gen).to(device, dtype)
        self.w = (torch.randn((S, K, C), generator=gen)
                  * (C * S) ** -0.5).to(device, dtype)
        self.g = torch.randn((N, K, Q), generator=gen).to(device, dtype)
        self.layer = dict(dilation=p["dilation"], padding=p["padding"])
        self.flops = conv1d_flops(N, C, K, S, Q)

    def fwd(self, call: dict):
        with torch.no_grad():
            return ops.conv1d(self.x, self.w, **self.layer, **call)

    def grads(self, call: dict):
        """(y, dx, dw) of one forward + backward."""
        xg = self.x.detach().requires_grad_()
        wg = self.w.detach().requires_grad_()
        y = ops.conv1d(xg, wg, **self.layer, **call)
        dx, dw = torch.autograd.grad(y, (xg, wg), self.g)
        return y.detach(), dx, dw

    def pass_sec(self, pass_: str, call: dict, iters: int) -> float:
        return _measure.time_pass(ops.conv1d, self.x, self.w, pass_,
                                  device=self.device, layer=self.layer,
                                  call=call, iters=iters)

    def fwdbwd_sec(self, call: dict, iters: int) -> float:
        return _measure.median_time(lambda: self.grads(call),
                                    device=self.device, iters=iters)


def _problem(p: dict, pass_: str) -> ConvProblem:
    return ConvProblem(**{k: p[k] for k in ("N", "C", "K", "S", "dilation",
                                            "Q", "dtype", "padding")},
                       pass_=pass_)


def _knob(pass_: str, cfg) -> str:
    """'cuda/408', 'cuda/taps', 'library', ..."""
    knob = cfg.body if pass_ == "bwd_weight" else cfg.tile
    return cfg.backend + (f"/{knob}" if knob is not None else "")


def _own_choice(p: dict, device: torch.device) -> dict:
    """The kernels' own tile (forward, bwd-data) and body at this cell."""
    if device.type != "cuda":
        return {}
    out = {}
    for pass_ in PASSES:
        shape = _space.kernel_shape(_problem(p, pass_))
        out[pass_] = (_k.bwd_weight_body(*shape, device=device.index)
                      if pass_ == "bwd_weight"
                      else _k.fwd_tile(*shape, device=device.index))
    return out


def _check_grads(label: str, got, plain, dtype: str) -> list[float]:
    """(y, dx, dw) against the plain version's at TOL / BWD_TOL; returns
    the three largest absolute differences."""
    atol, rtol = TOL[dtype]
    return [_elementwise(f"{label} y", got[0], plain[0], atol, rtol),
            _close(f"{label} dx", got[1], plain[1], BWD_TOL[dtype]),
            _close(f"{label} dw", got[2], plain[2], BWD_TOL[dtype])]


def _check_cell(cell: _Cell, kernel: str, plain) -> dict:
    """The kernels (own tiles) and the library against the plain version,
    then every tile and body the kernels instantiate."""
    dt = cell.p["dtype"]
    own = cell.grads(dict(backend=kernel))
    y_err, dx_err, dw_err = _check_grads(kernel, own, plain, dt)
    out = dict(y_err=y_err, dx_err=dx_err, dw_err=dw_err)
    _same("forward without autograd", (cell.fwd(dict(backend=kernel)),),
          own[:1])
    out["library_errs"] = _check_grads(
        "library", cell.grads(dict(backend="library")), plain, dt)
    if cell.device.type != "cuda":
        return out
    tried, refused = [], []
    for pass_ in PASSES:
        prob = _problem(cell.p, pass_)
        for cand in _space.cuda_candidates(prob):
            name = _knob(pass_, cand)
            if not _space.kernel_allows(prob, cand, cell.device.index):
                refused.append(f"{pass_}:{name}")
                continue
            if pass_ == "fwd":
                y = cell.fwd(dict(backend="cuda", tile=cand.tile))
                _same(f"fwd tile {cand.tile} vs own", (y,), own[:1])
            elif pass_ == "bwd_data":
                pin = ops.PassConfig("cuda", cand.tile)
                got = cell.grads(dict(backend="cuda", bwd_data_cfg=pin))
                _same(f"bwd_data tile {cand.tile} vs own", got[1:2],
                      own[1:2])
            else:
                pin = ops.PassConfig("cuda", body=cand.body)
                got = cell.grads(dict(backend="cuda", bwd_weight_cfg=pin))
                again = cell.grads(dict(backend="cuda", bwd_weight_cfg=pin))
                _close(f"dw body {cand.body}", got[2], plain[2],
                       BWD_TOL[dt])
                _same(f"dw body {cand.body} twice", got[2:], again[2:])
            tried.append(f"{pass_}:{name}")
    out.update(candidates_launched=tried, candidates_refused=refused)
    return out


def _cost_pick(prob: ConvProblem, device, kind: str) -> str:
    """The cost model's first pick among the pass's legal candidates."""
    cands = _space.enumerate_candidates(
        prob, device_kind=kind,
        allowed=lambda p, c: _space.kernel_allows(p, c, device.index or 0))
    return _knob(prob.pass_, _cost.rank(cands, prob, device_kind=kind)[0])


def _tune_cell(cell: _Cell, p: dict, *, device, kind, iters, top_k, plain,
               checks) -> tuple[dict, dict]:
    """Tune the cell's three passes (every legal candidate timed, or the
    cost model's top ``top_k``); with ``plain``, hold ``"auto"`` to the
    plain version and bitwise to the same call with its plan pinned.
    Returns how each pass resolved and the cost model's first picks."""
    won = {pass_: tune(**p, pass_=pass_, device=device, measure=True,
                       top_k=top_k, iters=iters) for pass_ in PASSES}
    plan = get_plan(**p, device=device, allow_measure=False)
    sources = {pass_: f"{_knob(pass_, c)} [{c.source}]"
               for pass_, c in plan.items()}
    picks = {pass_: _cost_pick(_problem(p, pass_), device, kind)
             for pass_ in PASSES}
    if plain is not None:
        pinned = dict(backend=won["fwd"].backend, tile=won["fwd"].tile,
                      bwd_data_cfg=ops.PassConfig(won["bwd_data"].backend,
                                                  won["bwd_data"].tile),
                      bwd_weight_cfg=ops.PassConfig(
                          won["bwd_weight"].backend,
                          body=won["bwd_weight"].body))
        auto = cell.grads(dict(backend="auto"))
        _same("auto vs pinned winners (forward)",
              (cell.fwd(dict(backend="auto")),), (cell.fwd(pinned),))
        _same("auto vs pinned winners (gradients)", auto,
              cell.grads(pinned))
        checks["auto_errs"] = _check_grads("auto", auto, plain,
                                           p["dtype"])
        checks["auto_bitwise_to_pinned"] = True
    return sources, picks


def _cell_rows(fig: str, p: dict, *, device, kind, grad, tuned, algs,
               check, iters, top_k, seed):
    cell = _Cell(p, device, seed)
    kernel = "cuda" if device.type == "cuda" else "ref"
    gpu = is_gpu(kind)
    dtype = "float32" if p["dtype"] == "float32" else "bfloat16"
    base = dict(fig=fig, dtype=p["dtype"], N=p["N"], C=p["C"], K=p["K"],
                S=p["S"], d=p["dilation"], Q=p["Q"])
    plain = cell.grads(dict(backend="ref")) if check else None
    checks = _check_cell(cell, kernel, plain) if check else {}
    arms = {kernel: dict(backend=kernel), "library": dict(backend="library")}
    sources = picks = {}
    if tuned:
        sources, picks = _tune_cell(cell, p, device=device, kind=kind,
                                    iters=iters, top_k=top_k, plain=plain,
                                    checks=checks)
        arms["auto"] = dict(backend="auto")
    secs = {}
    for arm, call in arms.items():
        secs[arm] = dict(fwd=cell.pass_sec("fwd", call, iters),
                         fwdbwd=cell.fwdbwd_sec(call, iters))
        if grad:
            for pass_ in ("bwd_data", "bwd_weight"):
                secs[arm][pass_] = cell.pass_sec(pass_, call, iters)
    # F.conv1d alone in the cell's dtype on the padded input
    lo, hi = ops._pad_amounts(p["S"], p["dilation"], p["padding"])
    xpad, wk = F.pad(cell.x, (lo, hi)), cell.w.permute(1, 2, 0).contiguous()

    def cudnn():
        with ops.library_flags():
            return F.conv1d(xpad, wk, dilation=p["dilation"])

    secs["cudnn"] = dict(fwd=_measure.median_time(cudnn, device=device,
                                                  iters=iters))
    es = 4 if dtype == "float32" else 2
    fwd_bound = (bound(cell.flops, conv1d_min_bytes(
        p["N"], p["C"], p["K"], p["S"], p["Q"], p["dilation"], es), dtype,
        peaks_for(kind))[0] if gpu else None)
    own = _own_choice(p, device)
    rows = []
    for mode, mult in (("fwd", 1), ("fwdbwd", 3)):
        for arm in arms if mode == "fwdbwd" else [*arms, "cudnn"]:
            sec = secs[arm][mode]
            row = dict(base, mode=f"{mode}-{arm}", ms=sec * 1e3,
                       gflops=mult * cell.flops / sec / 1e9,
                       efficiency=achieved_fraction_of_peak(
                           mult * cell.flops, sec, kind, dtype)
                       if gpu else None,
                       speedup_vs_library=secs["library"][mode] / sec)
            if mode == "fwd":
                row["bound_ms"] = fwd_bound
            if tuned:
                row["tuned_vs_default"] = (secs[kernel][mode]
                                           / secs["auto"][mode])
            if arm == kernel:
                row["source"] = "default"
                row["own"] = own if mode == "fwdbwd" else own.get("fwd")
            elif arm == "auto":
                row["source"] = sources if mode == "fwdbwd" \
                    else sources["fwd"]
                row["cost_pick"] = picks if mode == "fwdbwd" \
                    else picks["fwd"]
            if grad and mode == "fwdbwd":
                row.update({f"ms_{q}": secs[arm][q] * 1e3 for q in
                            ("fwd", "bwd_data", "bwd_weight")})
            rows.append(row)
    if algs and device.type == "cuda":
        prob = _problem(p, "bwd_weight")
        for cand in _space.cuda_candidates(prob):
            if not _space.kernel_allows(prob, cand, device.index):
                continue
            sec = cell.pass_sec("bwd_weight", dict(
                backend="cuda", bwd_weight_cfg=ops.PassConfig(
                    "cuda", body=cand.body)), iters)
            rows.append(dict(base, mode=f"bwd_weight-{cand.body}",
                             ms=sec * 1e3,
                             speedup_vs_library=secs["library"].get(
                                 "bwd_weight", float("nan")) / sec))
    return rows, checks


def _median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def summarize(rows: list[dict]) -> dict:
    """Per figure: the median efficiency of the kernels, of ``"library"``
    and (forward) of ``F.conv1d`` alone, the cells the kernels win, the
    worst cell, ``"auto"``'s winners, and the cells where the cost
    model's first pick was the measured winner."""
    out = {}
    for fig in dict.fromkeys(r["fig"] for r in rows):
        fr = [r for r in rows if r["fig"] == fig]
        s = {}
        for mode in ("fwd", "fwdbwd"):
            kern = [r for r in fr if r["mode"] in (f"{mode}-cuda",
                                                   f"{mode}-ref")]
            lib = [r for r in fr if r["mode"] == f"{mode}-library"]
            if not kern:
                continue
            worst = min(kern, key=lambda r: r["speedup_vs_library"])
            s[mode] = dict(
                cells=len(kern),
                kernel_efficiency_median=_median(
                    r["efficiency"] for r in kern),
                library_efficiency_median=_median(
                    r["efficiency"] for r in lib),
                kernel_wins=sum(r["speedup_vs_library"] > 1 for r in kern),
                worst=dict(S=worst["S"], Q=worst["Q"],
                           speedup_vs_library=worst["speedup_vs_library"]))
        native = [r for r in fr if r["mode"] == "fwd-cudnn"]
        if native and "fwd" in s:
            s["fwd"]["cudnn_efficiency_median"] = _median(
                r["efficiency"] for r in native)
        auto = [r for r in fr if r["mode"] == "fwdbwd-auto"]
        if auto:
            won = {pass_: [r["source"][pass_].split(" [")[0] for r in auto]
                   for pass_ in PASSES}
            s["auto_winners"] = {pass_: dict(collections.Counter(w))
                                 for pass_, w in won.items()}
            s["cost_pick_is_winner"] = {
                pass_: sum(w == r["cost_pick"][pass_]
                           for w, r in zip(won[pass_], auto))
                for pass_ in PASSES}
            s["auto_vs_default_median"] = statistics.median(
                r["tuned_vs_default"] for r in auto)
        out[fig] = s
    return out


def run(figsets=None, *, full: bool = False, grad: bool = True,
        tuned: bool = True, algs: bool = False, check: bool = True,
        device="cuda", cache: str | None = None, iters: int = 5,
        top_k: int | None = None, seed: int = 0, log=None) -> dict:
    """Sweep the cells on ``device`` (the card unless ``"cpu"`` is asked
    for); ``cache`` is the tuning cache ``"auto"`` reads and ``tuned``
    writes (``REPRO_TUNE_CACHE`` for the run; default: the cache in use).
    Returns ``{"rows", "checks", "summary", "device"}``; ``log`` gets each
    row as it is made."""
    device = as_device(device)
    kind = device_kind(device)
    old = os.environ.get(ENV_CACHE_PATH)
    if cache:
        os.environ[ENV_CACHE_PATH] = cache
    reset_default_cache()
    rows, checks = [], []
    try:
        for fig, p in cells(figsets, full=full):
            got, chk = _cell_rows(
                fig, p, device=device, kind=kind, grad=grad, tuned=tuned,
                algs=algs, check=check, iters=iters, top_k=top_k, seed=seed)
            rows += got
            checks.append(dict(fig=fig, S=p["S"], Q=p["Q"], **chk))
            for r in got:
                if log:
                    log(r)
    finally:
        if cache:
            if old is None:
                os.environ.pop(ENV_CACHE_PATH, None)
            else:
                os.environ[ENV_CACHE_PATH] = old
        reset_default_cache()
    return dict(rows=rows, checks=checks, summary=summarize(rows),
                device=kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune.sweep",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--figset", default="all", choices=[*FIGSETS, "all"])
    ap.add_argument("--full", action="store_true",
                    help="the full S/Q grid instead of the short one")
    ap.add_argument("--grad", action="store_true",
                    help="each backward pass's own time")
    ap.add_argument("--tuned", action="store_true",
                    help="tune every cell's three passes, then run 'auto'")
    ap.add_argument("--algs", action="store_true",
                    help="race conv1d_bwd_weight's taps and unit bodies")
    ap.add_argument("--check", action="store_true",
                    help="hold every result against the plain version")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "for a rehearsal with the plain version")
    ap.add_argument("--cache", default=None,
                    help="tuning cache for --tuned (default: the one in "
                         "use)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top-k", type=int, default=None,
                    help="time only the cost model's top k candidates a "
                         "pass (default: every legal one)")
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args(argv)
    res = run(None if args.figset == "all" else [args.figset],
              full=args.full, grad=args.grad, tuned=args.tuned,
              algs=args.algs, check=args.check, device=args.device,
              cache=args.cache, iters=args.iters, top_k=args.top_k,
              log=lambda r: print("sweep " + json.dumps(r), flush=True))
    for fig, s in res["summary"].items():
        print(f"sweep-summary {fig} " + json.dumps(s))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
