"""Aggregate a telemetry JSONL log into an efficiency scoreboard
(counterpart of ``repro/obs/report.py``; the same sections, text and
gates, so both packages' reports read one log alike).

The paper argues in *achieved fraction of roofline peak*, and so does
this report: conv1d pass spans carry measured efficiency, tuner counters
give the cache hit rate, candidate search events give the cost-model
error distribution, and train-step spans give the end-to-end breakdown.
``python -m repro_torch.obs.report LOG [--check]`` is the CLI; tests
import ``aggregate`` directly.

In the port every conv pass runs eagerly, so each call logs its own
``conv.psum.model`` event (one per dx sum over the model group, each
column range its own), where the JAX package logs one per trace: the
``model_psum`` counts are per call.  The port's tuner cache holds only
its own entries and never logs ``tune.cache.legacy_upgrade``; the field
stays, at 0.  The port has no pipelined kernels, so every conv span
carries ``pipe_depth`` 0 and the pipelining gate is vacuous.

Sections (keys of ``aggregate``'s result):
  provenance  the log's identity block
  spans       per-name count / p50 / p99 / total seconds
  conv_cells  per (cell, pass): count, p50 ms, median efficiency, plus
              the pipelining axis (max pipe depth dispatched, median
              model-derived overlap fraction — DESIGN.md §15)
  tuner       cache hits / misses / legacy upgrades / hit rate
  cost_model  predicted-vs-measured ratio distribution over search traces
  steps       train.step count + latency percentiles + phase breakdown
  serving     streaming conv serving latency (``serve.conv.chunk`` /
              ``serve.conv.prefill`` request spans): per-chunk p50/p99
              plus streams/s and samples/s throughput (DESIGN.md §16)
  shards      per-shard step-time stats + straggler verdicts (the gauges
              drive ``runtime/straggler.py`` detection offline)
  mesh        the (dp, mp) mesh shape of the run (``train.mesh`` event)
  model_psum  per-cell model-axis bwd-data all-reduce records
              (``conv.psum.model`` events: mp, chunk count, bytes —
              tensor parallelism, DESIGN.md §17)
  elastic     fault-tolerance drill records (``elastic.fault`` events +
              ``elastic.detect``/``elastic.recover`` spans): fault counts
              by kind, time-to-detect stats, one record per recovery
              (dp_from → dp_to, restore step, time-to-restore), and how
              many train steps ran after the last recovery (DESIGN.md §18)
  counters    raw counter totals
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Iterable

from .schema import read_events

PHASES = ("forward", "backward", "optimizer", "psum")


def _pct(vals: list[float], q: float) -> float:
    if not vals:
        return float("nan")
    s = sorted(vals)
    i = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
    return s[i]


def _span_stats(durs: list[float]) -> dict[str, float]:
    return {"count": len(durs), "p50_s": _pct(durs, 0.5),
            "p99_s": _pct(durs, 0.99), "total_s": sum(durs)}


def _conv_cell_key(a: dict) -> str:
    kind = "dw" if a.get("depthwise") else "dense"
    return (f"{kind}|{a.get('dtype')}|N{a.get('N')}|C{a.get('C')}"
            f"|K{a.get('K')}|S{a.get('S')}|d{a.get('dilation')}"
            f"|Q{a.get('Q')}")


def aggregate(events: Iterable[dict[str, Any]]) -> dict[str, Any]:
    events = list(events)
    provenance = next((r["attrs"] for r in events
                       if r["kind"] == "meta" and r["name"] == "provenance"),
                      {})
    spans: dict[str, list[float]] = defaultdict(list)
    cells: dict[tuple[str, str], dict[str, list[float]]] = defaultdict(
        lambda: {"dur": [], "eff": [], "gflops": [], "pipe": [], "ovl": []})
    counters: dict[str, float] = defaultdict(float)
    searches: list[dict] = []
    phase_durs: dict[str, list[float]] = defaultdict(list)
    shard_steps: dict[int, list[tuple[int, float]]] = defaultdict(list)
    serve_spans: dict[str, list[tuple[float, dict]]] = defaultdict(list)
    mesh: dict[str, Any] = {}
    model_psums: dict[str, dict[str, Any]] = defaultdict(
        lambda: {"count": 0, "chunks": [], "mp": [], "bytes": 0})
    faults: dict[str, int] = defaultdict(int)
    detects: dict[str, list[float]] = defaultdict(list)
    recoveries: list[dict] = []
    step_ts: list[float] = []

    for r in events:
        kind, name, attrs = r["kind"], r["name"], r.get("attrs", {})
        if kind == "span":
            spans[name].append(r["dur"])
            if name == "train.step":
                step_ts.append(float(r.get("ts", 0.0)))
            if name == "elastic.detect":
                detects[str(attrs.get("kind", "?"))].append(r["dur"])
            if name == "elastic.recover":
                recoveries.append({
                    "kind": attrs.get("kind"),
                    "fault_step": attrs.get("step"),
                    "restore_step": attrs.get("restore_step"),
                    "dp_from": attrs.get("dp_from"),
                    "dp_to": attrs.get("dp_to"), "mp": attrs.get("mp"),
                    "time_to_restore_s": r["dur"],
                    "ts": float(r.get("ts", 0.0)) + r["dur"]})
            if name.startswith("conv1d."):
                c = cells[(_conv_cell_key(attrs), name[len("conv1d."):])]
                c["dur"].append(r["dur"])
                if "efficiency" in attrs:
                    c["eff"].append(attrs["efficiency"])
                if "gflops_per_s" in attrs:
                    c["gflops"].append(attrs["gflops_per_s"])
                if "pipe_depth" in attrs:  # pipelining axis (DESIGN.md §15)
                    c["pipe"].append(int(attrs["pipe_depth"]))
                    c["ovl"].append(float(attrs.get("overlap_frac", 0.0)))
            if name.startswith("train.phase."):
                phase_durs[name[len("train.phase."):]].append(r["dur"])
            if name.startswith("serve.conv."):
                serve_spans[name[len("serve.conv."):]].append((r["dur"], attrs))
        elif kind == "counter":
            counters[name] += r["value"]
        elif kind == "gauge" and name == "train.shard.step_time":
            shard_steps[int(attrs.get("shard", r["pid"]))].append(
                (int(attrs.get("step", -1)), r["value"]))
        elif kind == "event" and name == "tune.search.candidate":
            searches.append(attrs)
        elif kind == "event" and name == "train.mesh":
            mesh = dict(attrs)
        elif kind == "event" and name == "elastic.fault":
            faults[str(attrs.get("kind", "?"))] += 1
        elif kind == "event" and name == "conv.psum.model":
            # one record per dx sum over the model group (per call in the
            # port, per trace in the JAX package): shard count, chunking,
            # moved bytes
            m = model_psums[_conv_cell_key(attrs)]
            m["count"] += 1
            m["chunks"].append(int(attrs.get("chunks", 1)))
            m["mp"].append(int(attrs.get("mp", 0)))
            m["bytes"] += int(attrs.get("bytes", 0))
        elif (kind == "event" and name.startswith("conv1d.")
                and name.endswith(".trace")):
            # passes that cannot be timed (traced, or inside a CUDA graph
            # capture) emit zero-duration trace events instead of spans —
            # still the record of which pipeline depth ran
            if "pipe_depth" in attrs:
                c = cells[(_conv_cell_key(attrs),
                           name[len("conv1d."):-len(".trace")])]
                c["pipe"].append(int(attrs["pipe_depth"]))
                c["ovl"].append(float(attrs.get("overlap_frac", 0.0)))

    hits = counters.get("tune.cache.hit", 0)
    misses = counters.get("tune.cache.miss", 0)
    tuner = {
        "hits": int(hits), "misses": int(misses),
        "legacy_upgrades": int(counters.get("tune.cache.legacy_upgrade", 0)),
        "hit_rate": hits / (hits + misses) if hits + misses else float("nan"),
    }

    ratios = [s["measured_s"] / s["predicted_s"] for s in searches
              if s.get("predicted_s") and s.get("measured_s")]
    import math
    logerr = [abs(math.log2(x)) for x in ratios]
    cost_model = {"n": len(ratios), "ratio_p50": _pct(ratios, 0.5),
                  "abs_log2_err_p50": _pct(logerr, 0.5),
                  "abs_log2_err_p90": _pct(logerr, 0.9)}

    steps = dict(_span_stats(spans.get("train.step", [])))
    steps["phases"] = {p: _span_stats(phase_durs[p])
                       for p in PHASES if p in phase_durs}

    serving: dict[str, Any] = {}
    for phase, recs in sorted(serve_spans.items()):
        durs = [d for d, _ in recs]
        s = dict(_span_stats(durs))
        # with_request_spans stamps batch/chunk as static span attrs
        s["batch"] = max((int(a.get("batch", 1)) for _, a in recs), default=1)
        chunk = max((int(a.get("chunk", 0)) for _, a in recs), default=0)
        if chunk:
            s["chunk"] = chunk
        total = s["total_s"]
        # stream-chunks (batch slots) retired per second of serving wall time
        s["streams_per_s"] = (len(durs) * s["batch"] / total
                              if total > 0 else float("nan"))
        if chunk:
            s["samples_per_s"] = (len(durs) * s["batch"] * chunk / total
                                  if total > 0 else float("nan"))
        serving[phase] = s

    shards: dict[str, Any] = {}
    stragglers: list[int] = []
    if shard_steps:
        from repro_torch.runtime.straggler import ShardStragglerMonitor
        mon = ShardStragglerMonitor()
        for shard, samples in sorted(shard_steps.items()):
            verdicts = defaultdict(int)
            for step, dt in sorted(samples):
                verdicts[mon.record(shard, step, dt)] += 1
            shards[str(shard)] = {
                "steps": len(samples),
                "p50_s": _pct([dt for _, dt in samples], 0.5),
                "verdicts": dict(verdicts),
            }
        stragglers = sorted(mon.stragglers())

    # train steps whose start timestamp is later than the last recovery's
    # completion — the observable proof that training actually resumed
    last_recover_ts = max((rec["ts"] for rec in recoveries), default=None)
    post_recovery_steps = (sum(1 for t in step_ts if t > last_recover_ts)
                           if last_recover_ts is not None else 0)
    elastic = {
        "faults": dict(faults),
        "detect": {k: {"count": len(d), "p50_s": _pct(d, 0.5),
                       "max_s": max(d)} for k, d in sorted(detects.items())},
        "recoveries": [{k: v for k, v in rec.items() if k != "ts"}
                       for rec in recoveries],
        "post_recovery_steps": post_recovery_steps,
    }

    return {
        "provenance": provenance,
        "spans": {n: _span_stats(d) for n, d in sorted(spans.items())},
        "conv_cells": {
            f"{cell}|{pass_}": {
                "count": len(c["dur"]), "p50_ms": _pct(c["dur"], 0.5) * 1e3,
                "efficiency_p50": _pct(c["eff"], 0.5),
                "gflops_per_s_p50": _pct(c["gflops"], 0.5),
                "pipe_depth_max": max(c["pipe"], default=0),
                # overlap over pipelined dispatches only — mixing in the
                # synchronous spans' zeros would hide a broken estimate
                "overlap_frac_p50": _pct(
                    [o for p, o in zip(c["pipe"], c["ovl"]) if p >= 2], 0.5),
            } for (cell, pass_), c in sorted(cells.items())},
        "tuner": tuner,
        "cost_model": cost_model,
        "steps": steps,
        "serving": serving,
        "shards": {"per_shard": shards, "stragglers": stragglers},
        "mesh": mesh,
        "model_psum": {
            cell: {"count": m["count"],
                   "chunks_max": max(m["chunks"], default=0),
                   "mp": max(m["mp"], default=0),
                   "bytes_total": m["bytes"]}
            for cell, m in sorted(model_psums.items())},
        "elastic": elastic,
        "counters": dict(counters),
    }


def aggregate_path(path: str) -> dict[str, Any]:
    return aggregate(read_events(path))


def _fmt(x: float, unit: str = "") -> str:
    if x != x:  # nan
        return "-"
    return f"{x:.4g}{unit}"


def render_text(agg: dict[str, Any]) -> str:
    p = agg["provenance"]
    out = [
        "== telemetry scoreboard",
        f"provenance: git {str(p.get('git_sha', '?'))[:12]} "
        f"torch {p.get('torch_version', '?')} cuda "
        f"{p.get('cuda_version', '?')} device {p.get('device_kind', '?')} "
        f"pid {p.get('process_index', '?')}",
        "", "-- spans (p50 / p99 / total)"]
    for name, s in agg["spans"].items():
        out.append(f"  {name:32s} n={s['count']:<5d} "
                   f"{_fmt(s['p50_s'] * 1e3, 'ms'):>10s} "
                   f"{_fmt(s['p99_s'] * 1e3, 'ms'):>10s} "
                   f"{_fmt(s['total_s'], 's'):>9s}")
    out += ["", "-- conv1d efficiency (achieved fraction of roofline peak)"]
    for cell, c in agg["conv_cells"].items():
        pipe = (f" pipe={c['pipe_depth_max']} "
                f"ovl={_fmt(c['overlap_frac_p50'])}"
                if c.get("pipe_depth_max", 0) >= 2 else "")
        out.append(f"  {cell:54s} n={c['count']:<4d} "
                   f"{_fmt(c['p50_ms'], 'ms'):>9s} "
                   f"eff={_fmt(c['efficiency_p50'])} "
                   f"({_fmt(c['gflops_per_s_p50'])} GFLOP/s){pipe}")
    t = agg["tuner"]
    out += ["", f"-- tuner cache: hits {t['hits']} misses {t['misses']} "
                f"legacy-upgrades {t['legacy_upgrades']} "
                f"hit-rate {_fmt(t['hit_rate'])}"]
    cm = agg["cost_model"]
    out += [f"-- cost model: n={cm['n']} measured/predicted "
            f"p50 {_fmt(cm['ratio_p50'])} "
            f"|log2 err| p50 {_fmt(cm['abs_log2_err_p50'])} "
            f"p90 {_fmt(cm['abs_log2_err_p90'])}"]
    st = agg["steps"]
    mesh = agg.get("mesh") or {}
    mesh_note = (f" mesh dp={mesh.get('dp')} mp={mesh.get('mp')} "
                 f"[{mesh.get('axes', '')}]" if mesh else "")
    out += [f"-- train steps: n={st['count']} "
            f"p50 {_fmt(st['p50_s'] * 1e3, 'ms')} "
            f"p99 {_fmt(st['p99_s'] * 1e3, 'ms')}{mesh_note}"]
    for ph, s in st.get("phases", {}).items():
        out.append(f"     phase {ph:10s} p50 {_fmt(s['p50_s'] * 1e3, 'ms')}")
    if agg.get("serving"):
        out.append("-- serving (streaming conv request latency)")
        for phase, s in agg["serving"].items():
            thr = (f" {_fmt(s['samples_per_s'])} samples/s"
                   if "samples_per_s" in s else "")
            out.append(f"     {phase:8s} n={s['count']:<5d} "
                       f"p50 {_fmt(s['p50_s'] * 1e3, 'ms')} "
                       f"p99 {_fmt(s['p99_s'] * 1e3, 'ms')} "
                       f"batch={s['batch']} "
                       f"{_fmt(s['streams_per_s'])} stream-chunks/s{thr}")
    if agg.get("model_psum"):
        out.append("-- model-axis psums (tensor parallelism, DESIGN.md §17)")
        for cell, m in agg["model_psum"].items():
            out.append(f"     {cell:54s} n={m['count']:<4d} "
                       f"mp={m['mp']} chunks={m['chunks_max']} "
                       f"{m['bytes_total'] / 1e6:.3g}MB staged")
    el = agg.get("elastic") or {}
    if el.get("faults"):
        out.append("-- elastic drills (fault tolerance, DESIGN.md §18)")
        out.append(f"     faults: {el['faults']}")
        for k, d in el.get("detect", {}).items():
            out.append(f"     detect {k:12s} n={d['count']} "
                       f"p50 {_fmt(d['p50_s'], 's')} "
                       f"max {_fmt(d['max_s'], 's')}")
        for rec in el.get("recoveries", []):
            out.append(f"     recover {rec.get('kind')}: "
                       f"dp {rec.get('dp_from')} -> {rec.get('dp_to')} "
                       f"(mp {rec.get('mp')}), fault step "
                       f"{rec.get('fault_step')} restored to "
                       f"{rec.get('restore_step')} in "
                       f"{_fmt(rec.get('time_to_restore_s', float('nan')), 's')}")
        out.append(f"     post-recovery steps: "
                   f"{el.get('post_recovery_steps', 0)}")
    sh = agg["shards"]
    if sh["per_shard"]:
        out.append("-- shards")
        for shard, s in sh["per_shard"].items():
            out.append(f"     shard {shard}: n={s['steps']} "
                       f"p50 {_fmt(s['p50_s'] * 1e3, 'ms')} "
                       f"verdicts {s['verdicts']}")
        out.append(f"     stragglers: {sh['stragglers'] or 'none'}")
    return "\n".join(out)


def check(agg: dict[str, Any]) -> list[str]:
    """The CI smoke gate: names of the required sections that are missing
    from an instrumented training run's log (empty list = pass)."""
    missing = []
    if not any(c["count"] and c["efficiency_p50"] == c["efficiency_p50"]
               for c in agg["conv_cells"].values()):
        missing.append("conv_cells (no measured conv1d pass efficiency)")
    if not agg["steps"]["count"]:
        missing.append("steps (no train.step spans)")
    if not agg["steps"].get("phases"):
        missing.append("steps.phases (no train.phase.* breakdown)")
    if not (agg["tuner"]["hits"] or agg["tuner"]["misses"]):
        missing.append("tuner (no cache hit/miss counters)")
    missing += _zero_overlap_cells(agg)
    return missing


def _zero_overlap_cells(agg: dict[str, Any]) -> list[str]:
    """Pipelined conv cells whose model-derived overlap fraction is zero
    (or missing) — a pipelined dispatch that hides nothing is either a
    broken cost estimate or a degenerate single-tile pipeline the space
    pruning should have rejected.  Vacuous when nothing pipelined ran."""
    bad = [cell for cell, c in agg["conv_cells"].items()
           if c.get("pipe_depth_max", 0) >= 2
           and not (c.get("overlap_frac_p50", 0.0) > 0.0)]
    return [f"pipelining (pipelined cell reports zero overlap_frac: {c})"
            for c in bad]


def check_model_parallel(agg: dict[str, Any]) -> list[str]:
    """The model-parallel CI gate: a run launched with a model axis must
    have recorded its 2D mesh (``train.mesh`` with mp > 1) and traced at
    least one bwd-data model-axis all-reduce (``conv.psum.model`` with
    nonzero staged bytes) — a log without them means the K-sharded layers
    never differentiated through the model psum (DESIGN.md §17)."""
    missing = []
    mesh = agg.get("mesh") or {}
    if int(mesh.get("mp", 0) or 0) < 2:
        missing.append("mesh (no train.mesh event with mp > 1)")
    psums = agg.get("model_psum", {})
    if not any(m["count"] and m["bytes_total"] > 0 for m in psums.values()):
        missing.append(
            "model_psum (no conv.psum.model events with nonzero bytes)")
    return missing


def check_serving(agg: dict[str, Any]) -> list[str]:
    """The serve-smoke CI gate: an instrumented streaming-serve run must
    have produced per-chunk request spans (``serve.conv.chunk``) with a
    measurable throughput — a log without them means the serving loop
    never timed its step through ``with_request_spans``."""
    s = agg.get("serving", {}).get("chunk")
    if not s or not s["count"]:
        return ["serving (no serve.conv.chunk request spans in the log)"]
    if not (s.get("streams_per_s", 0.0) > 0.0):
        return ["serving (serve.conv.chunk spans report zero throughput)"]
    return []


def check_elastic(agg: dict[str, Any]) -> list[str]:
    """The elastic-drill CI gate: an instrumented drill run must show the
    WHOLE recovery loop — a fault was injected (``elastic.fault``), its
    detection was timed (``elastic.detect``), at least one recovery
    re-planned the mesh to a SMALLER data axis at an UNCHANGED model axis
    and restored a checkpoint (``elastic.recover``), and training visibly
    resumed afterwards (train.step spans later than the recovery).  A log
    missing any of these means the supervisor never exercised the elastic
    path end to end (DESIGN.md §18)."""
    el = agg.get("elastic") or {}
    missing = []
    if not el.get("faults"):
        missing.append("elastic.faults (no elastic.fault events in the log)")
    if not el.get("detect"):
        missing.append("elastic.detect (no timed fault-detection spans)")
    recs = el.get("recoveries", [])
    if not recs:
        missing.append("elastic.recoveries (no elastic.recover spans)")
    else:
        if not any((rec.get("dp_to") or 0) < (rec.get("dp_from") or 0)
                   for rec in recs):
            missing.append(
                "elastic.recoveries (no recovery shrank the data axis: "
                "dp_to < dp_from never holds)")
        if not all((rec.get("time_to_restore_s") or 0) > 0
                   and rec.get("restore_step") is not None for rec in recs):
            missing.append(
                "elastic.recoveries (a recovery lacks a positive "
                "time_to_restore_s or a restore_step)")
        if not el.get("post_recovery_steps"):
            missing.append(
                "elastic.post_recovery_steps (no train.step spans after "
                "the last recovery — training never resumed)")
    return missing


def check_pipelining(agg: dict[str, Any]) -> list[str]:
    """The bench-smoke pipelining gate: unlike :func:`check` (a training
    log's sections), this requires that pipelined conv passes actually ran
    — a sweep log with zero pipelined cells means the ``|pipe:``
    candidates never dispatched — and that each reports a nonzero
    model-derived overlap fraction."""
    if not any(c.get("pipe_depth_max", 0) >= 2
               for c in agg["conv_cells"].values()):
        return ["pipelining (no pipelined conv1d pass spans in the log)"]
    return _zero_overlap_cells(agg)


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Aggregate a repro_torch telemetry JSONL log into a "
                    "scoreboard (text or JSON).")
    ap.add_argument("log", help="telemetry JSONL path")
    ap.add_argument("--json", action="store_true", help="emit JSON")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless conv efficiency, step breakdown "
                         "and tuner sections are all present (CI gate)")
    ap.add_argument("--check-pipelining", action="store_true",
                    help="exit 1 unless pipelined conv passes ran and "
                         "every pipelined cell reports a nonzero overlap "
                         "fraction (bench-smoke CI gate)")
    ap.add_argument("--check-serving", action="store_true",
                    help="exit 1 unless streaming-serve per-chunk request "
                         "spans with nonzero throughput are present "
                         "(serve-smoke CI gate)")
    ap.add_argument("--check-model-parallel", action="store_true",
                    help="exit 1 unless a 2D (data, model) mesh was "
                         "recorded and the K-sharded layers traced their "
                         "bwd-data model-axis all-reduces "
                         "(model-parallel CI gate, DESIGN.md §17)")
    ap.add_argument("--check-elastic", action="store_true",
                    help="exit 1 unless the full elastic-recovery loop is "
                         "in the log: injected fault, timed detection, a "
                         "data-axis-shrinking recovery with a checkpoint "
                         "restore, and train steps after it "
                         "(elastic-drill CI gate, DESIGN.md §18)")
    args = ap.parse_args(argv)
    events = read_events(args.log)
    if not events:
        print(f"{args.log}: empty log")
        return 1
    agg = aggregate(events)
    print(json.dumps(agg, indent=1, default=str) if args.json
          else render_text(agg))
    missing = (check(agg) if args.check else []) + (
        check_pipelining(agg) if args.check_pipelining else []) + (
        check_serving(agg) if args.check_serving else []) + (
        check_model_parallel(agg) if args.check_model_parallel else []) + (
        check_elastic(agg) if args.check_elastic else [])
    if (args.check or args.check_pipelining or args.check_serving
            or args.check_model_parallel or args.check_elastic):
        if missing:
            print("\nSMOKE GATE FAILED — missing sections:")
            for m in missing:
                print(f"  * {m}")
            return 1
        print("\nsmoke gate OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
