"""The dry-run (counterpart of ``repro/launch/dryrun.py``): is the
distribution coherent at production scale, does one rank fit on an H100,
and which roofline term bounds it?

For every (architecture x input shape) cell on JAX's production meshes
(``launch/mesh.make_production_mesh``: single ``(data 16, model 16)``,
256 cards; multi ``(pod 2, data 16, model 16)``, 512) this builds ONE
rank of the cell on the ``meta`` device (``launch/specs.py build_cell``,
the mesh's origin: no memory, no values, no card) and counts what its
step runs (``roofline/analysis.py``): FLOPs, bytes, collective bytes by
kind and axis, the rank's argument bytes and the most bytes alive beyond
them, and whether they fit on one card's 80 GB.  The roofline terms come
from an H100 SXM's data-sheet peaks at 700 W (989 TFLOP/s bf16, 3.35
TB/s) and its links (``analysis.axis_rate``): a prediction, not a
measurement.

By default the counts come from the probe plan (``analysis.probe_plan``:
one or two layers of each kind, ``extrapolate`` to the full depth, on
both meshes), and the memory from the probe with the most layers of
each kind: a served rank keeps no activation across layers, so the
bytes alive beyond the arguments do not grow with depth, and the
argument bytes come exactly from the full depth's shapes.  JAX probes
the single mesh only, for its terms; the port's probes are cheap, and
give every record its terms.  ``--no-probes`` runs the full depth
instead (``per_device`` then holds the full count and the full step's
peak).

Records keep JAX's keys and statuses: ``ok``; ``skip`` (JAX's
``applicable``, and a ``train_4k`` cell, which names ``ROADMAP.md``
queue A item 9: ``launch/specs.py`` says why none is built); ``error``.

Usage (on the host, no card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --no-probes
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (TRAIN_ITEM, applicable, build_cell,
                                     conv_train_refusal)
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import flops as rf

ARCHS = [
    "moonshot-v1-16b-a3b", "deepseek-v3-671b", "internvl2-2b", "qwen2-7b",
    "qwen3-8b", "starcoder2-3b", "qwen3-14b", "zamba2-7b",
    "whisper-large-v3", "mamba2-370m",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
DEFAULT_OUT = "experiments/dryrun_torch.json"


def count_cell(cfg, shape, mesh, coords=None) -> tuple[dict, dict]:
    """``(metrics, meta)`` of one rank's step of the cell, counted
    (``analysis.count_step``) on ``meta``."""
    cell = build_cell(cfg, shape, mesh, coords)
    g = cell.groups
    m = ra.count_step(cell.fn, cell.args,
                      groups=[g["model"], g["data"], *g["groups"].values()])
    m["param_bytes"] = ra.tensor_bytes(cell.args[0])
    return m, cell.meta


def cell_arg_bytes(cfg, shape, mesh, coords=None) -> tuple[int, int]:
    """The rank's argument bytes at the full depth (parameters, cache,
    batch) and its parameters' alone, from their shapes."""
    args = build_cell(cfg, shape, mesh, coords).args
    return ra.tensor_bytes(args), ra.tensor_bytes(args[0])


def probed(cfg, shape, mesh, coords=None) -> tuple[dict, dict, list]:
    """The cell's counts at full depth from the probe plan: ``(metrics,
    meta, probe metrics)``; ``arg_bytes`` is the full depth's, exact, and
    ``peak_bytes`` the largest probe's."""
    plan, rows, full_row = ra.probe_plan(cfg, shape, 1)
    pm, meta = [], None
    for p in plan:
        m, meta_p = count_cell(p.cfg, p.shape, mesh, coords)
        pm.append(m)
        meta = meta or meta_p
    # the counts are whole numbers; the solve leaves rounding residue
    full = {k: float(round(v)) for k, v in
            ra.extrapolate(pm, rows, full_row).items()}
    coll = ra.extrapolate(
        [m["coll_by_axis"] for m in pm], rows, full_row,
        keys=sorted({a for m in pm for a in m["coll_by_axis"]}))
    kinds = ra.extrapolate(
        [m["coll_by_kind"] for m in pm], rows, full_row,
        keys=list(pm[0]["coll_by_kind"]))
    kernels = {}
    for name in sorted({k for m in pm for k in m["kernels"]}):
        per = [m["kernels"].get(name, dict(calls=0, flops=0.0, bytes=0.0))
               for m in pm]
        kernels[name] = {k: round(v) if k == "calls" else v for k, v in
                         ra.extrapolate(per, rows, full_row,
                                        keys=("calls", "flops", "bytes")
                                        ).items()}
    full.update(coll_by_axis=coll, coll_by_kind=kinds, kernels=kernels,
                peak_bytes=max(m["peak_bytes"] for m in pm))
    full["arg_bytes"], full["param_bytes"] = cell_arg_bytes(cfg, shape,
                                                            mesh, coords)
    meta = dict(meta, arch=cfg.name)
    return full, meta, pm


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             probes: bool) -> dict:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    ok, why = applicable(cfg, shape)
    if ok and shape.kind == "train" and cfg.family != "conv":
        ok, why = False, f"language-model train_4k cell: {TRAIN_ITEM}"
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    if ok and shape.kind == "train":
        ok, why = False, conv_train_refusal(cfg, mesh)
    if not ok:
        rec.update(status="skip", why=why)
        return rec
    n_chips = mesh.size
    t0 = time.time()
    try:
        if probes:
            metrics, meta, _ = probed(cfg, shape, mesh)
        else:
            metrics, meta = count_cell(cfg, shape, mesh)
    except Exception as e:
        rec.update(status="error", error=repr(e),
                   trace=traceback.format_exc(limit=8))
        return rec
    meta["count_s"] = round(time.time() - t0, 2)
    meta["probes"] = probes
    mem = {"argument_size_in_bytes": metrics["arg_bytes"],
           "temp_size_in_bytes": metrics["peak_bytes"],
           "fits": ra.fits(metrics["arg_bytes"], metrics["peak_bytes"]),
           "capacity_bytes": ra.HBM_PER_CARD}
    terms = ra.roofline_terms(metrics, n_chips, rf.model_flops(cfg, shape),
                              rf.model_bytes(cfg, shape), mesh=mesh)
    rec.update(status="ok", n_chips=n_chips, meta=meta, memory=mem,
               per_device=metrics, terms=terms,
               jax_corrections={
                   "flash": ra.flash_correction(cfg, shape, n_chips),
                   "ssd_scan": ra.ssd_scan_correction(cfg, shape, n_chips)})
    print(f"--- {arch} x {shape_name} x {mesh_kind} ({n_chips} cards, "
          f"rank {meta['coords']}, counted in {meta['count_s']}s)")
    print("memory: args %.3e B, peak beyond %.3e B, fits %s"
          % (mem["argument_size_in_bytes"], mem["temp_size_in_bytes"],
             mem["fits"]))
    print("per rank: flops=%.3e bytes=%.3e coll_bytes=%.3e"
          % (metrics["flops"], metrics["bytes"], metrics["coll_bytes"]))
    print("roofline: compute=%.3es memory=%.3es collective=%.3es "
          "dominant=%s frac=%.3f useful=%.3f"
          % (terms["compute_s"], terms["memory_s"], terms["collective_s"],
             terms["dominant"], terms["roofline_fraction"],
             terms["useful_ratio"]))
    return rec


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _save(path: str, db: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(db, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS + ["atacworks"], default=None)
    ap.add_argument("--shape", choices=SHAPE_NAMES, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true", help="all 40 cells")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = SHAPE_NAMES if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    t0 = time.time()
    db = _load(args.out)
    n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = f"{arch}|{shape}|{mesh_kind}"
                if key in db and db[key].get("status") in ("ok", "skip") \
                        and not args.force:
                    continue
                rec = run_cell(arch, shape, mesh_kind,
                               probes=not args.no_probes)
                db[key] = rec
                _save(args.out, db)
                if rec["status"] == "error":
                    n_err += 1
                    print(f"!!! {key}: {rec['error']}")
    print(f"done: {len(db)} records, {n_err} new errors in "
          f"{time.time() - t0:.1f}s")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
