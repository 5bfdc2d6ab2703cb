"""Parity of the port's telemetry (``repro_torch.obs``) with the JAX
package's (``repro.obs``), on the CPU.

  * schema: each package's ``validate`` accepts the other's records;
  * bus: the JAX package's doctest sequence gives the same records
    (kind, name, parent structure, attrs; ts, dur, pid and the provenance
    block aside) through both buses; disabled hooks write nothing and
    cost under a microsecond (min of repeats, as ``tests/test_obs.py``);
  * report: one log (``tests/test_obs.py``'s ``_write_full_log``
    sequence, written by each bus) aggregates to equal sections under
    both reports, renders the same text apart from the provenance line,
    and every gate and ``main`` answer alike; trace export gives the same
    events apart from the process label;
  * pass spans: at ``tests/test_obs.py``'s shapes the port's
    ``conv1d.bwd_data`` / ``conv1d.bwd_weight`` spans carry JAX's cell
    keys and flops (JAX's Pallas passes in interpret mode); the port also
    logs the forward of a differentiated call, where JAX's ``jax.vjp``
    trace logs none;
  * tuner: hit and miss counters, and search events with positive
    predicted and measured seconds;
  * environment: ``REPRO_TORCH_TELEMETRY=1`` opens the port's default path
    and no other.

On the CPU a port span carries no ``efficiency``: the host has no peak in
``repro_torch.roofline`` (the card phase of ``chip_smoke.py`` checks it).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import timeit

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import obs as jobs
from repro.kernels import ops as jops
from repro.obs import report as jreport
from repro.obs import trace_export as jtrace
from repro_torch import obs, tune
from repro_torch.kernels import ops
from repro_torch.obs import report, trace_export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_off():
    """Both buses are process-wide singletons: every test starts and ends
    with both closed."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _same_json(a, b):
    """Equal as JSON (NaN equal to NaN)."""
    return (json.dumps(a, sort_keys=True, default=str)
            == json.dumps(b, sort_keys=True, default=str))


# --- the record sequences, one per bus ---------------------------------------

def _all_kinds(bus, path):
    bus.enable(path)
    with bus.span("a.span", note="x"):
        pass
    bus.counter("a.counter", 3)
    bus.gauge("a.gauge", 1.5)
    bus.event("a.event", k="v")
    bus.span_event("a.derived", 0.25, step=3)
    bus.disable()
    return bus.read_events(path)


def _doctest_sequence(bus, path):
    """The JAX package's ``obs/__init__.py`` doctest."""
    bus.enable(path)
    with bus.span("demo.outer", note="hi"):
        with bus.span("demo.inner"):
            pass
    bus.counter("demo.count", 2)
    bus.disable()
    return bus.read_events(path)


def _shape(recs):
    """Each record's kind, name, attrs, counter value/total and parent's
    name, in order; the provenance block aside."""
    names = {r["id"]: r["name"] for r in recs if r["kind"] == "span"}
    return [(r["kind"], r["name"], r["attrs"], r.get("value"),
             r.get("total"), names.get(r.get("parent")))
            for r in recs if r["kind"] != "meta"]


def _jax_passes():
    x, w = jnp.ones((2, 8, 64)), jnp.ones((3, 4, 8))
    y, pull = jax.vjp(
        lambda w: jops.conv1d(x, w, dilation=2, backend="pallas"), w)
    pull(jnp.ones_like(y))


def _port_passes():
    """The same layer through the port's Function (each pass its plain
    version on CPU tensors): x padded SAME, gradients to x and w."""
    x = torch.ones(2, 8, 64, requires_grad=True)
    w = torch.ones(3, 4, 8, requires_grad=True)
    y = ops.fused_conv1d(F.pad(x, (2, 2)), w, dilation=2)
    torch.autograd.grad(y, (x, w), torch.ones_like(y))


def _full_log(bus, path, passes):
    """``tests/test_obs.py``'s ``_write_full_log`` through ``bus``."""
    bus.enable(path)
    passes()
    bus.counter("tune.cache.hit")
    bus.span_event("train.step", 0.02, step=0)
    bus.span_event("train.phase.forward", 0.005, step=0)
    bus.span_event("train.phase.backward", 0.012, step=0)
    bus.gauge("train.shard.step_time", 0.02, shard=0, step=0)
    bus.disable()
    return path


@pytest.fixture
def logs(tmp_path):
    """The full log written by each bus: {"jax": path, "port": path}."""
    return {"jax": _full_log(jobs, str(tmp_path / "jax.jsonl"), _jax_passes),
            "port": _full_log(obs, str(tmp_path / "port.jsonl"),
                              _port_passes)}


# --- schema ------------------------------------------------------------------

def test_each_package_validates_the_others_records(tmp_path):
    jrecs = _all_kinds(jobs, str(tmp_path / "j.jsonl"))
    precs = _all_kinds(obs, str(tmp_path / "p.jsonl"))
    assert [r["kind"] for r in precs] == ["meta", "span", "counter",
                                          "gauge", "event", "span"]
    for r in jrecs:
        obs.validate(r)
    for r in precs:
        jobs.validate(r)
    # and each reads the other's log strictly
    assert len(obs.read_events(str(tmp_path / "j.jsonl"))) == len(jrecs)
    assert len(jobs.read_events(str(tmp_path / "p.jsonl"))) == len(precs)
    assert _shape(jrecs) == _shape(precs)
    prov = precs[0]["attrs"]
    for key in ("git_sha", "torch_version", "cuda_version", "device_kind",
                "n_devices", "process_index", "wall_epoch"):
        assert key in prov
    assert prov["device_kind"] == "cpu" and prov["process_index"] == 0


@pytest.mark.parametrize("bad", [
    {"kind": "bogus"}, {"value": None}, {"ts": -1.0},
    {"kind": "span", "dur": -0.1, "id": 1, "parent": None}])
def test_both_validates_reject_the_same_records(bad):
    ok = {"kind": "gauge", "name": "g", "ts": 0.0, "attrs": {}, "pid": 0,
          "value": 1.0}
    rec = {k: v for k, v in {**ok, **bad}.items() if v is not None}
    for validate in (obs.validate, jobs.validate):
        with pytest.raises(ValueError):
            validate(dict(rec))


def test_read_events_rejects_non_json(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text("not json\n")
    with pytest.raises(ValueError, match="not JSON"):
        obs.read_events(str(p))


# --- bus ---------------------------------------------------------------------

def test_doctest_sequence_matches_jax_bus(tmp_path):
    jrecs = _doctest_sequence(jobs, str(tmp_path / "j.jsonl"))
    precs = _doctest_sequence(obs, str(tmp_path / "p.jsonl"))
    assert _shape(precs) == _shape(jrecs)
    assert [r["name"] for r in precs] == ["provenance", "demo.inner",
                                          "demo.outer", "demo.count"]
    spans = {r["name"]: r for r in precs if r["kind"] == "span"}
    assert spans["demo.outer"]["parent"] is None
    assert spans["demo.inner"]["parent"] == spans["demo.outer"]["id"]


def test_disabled_hooks_write_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not obs.enabled()
    with obs.span("x", a=1) as s:
        with obs.device_span("y", torch.device("cpu")) as d:
            obs.counter("c")
            obs.gauge("g", 1.0)
            obs.event("e")
            obs.span_event("se", 0.1)
            obs.flush()
    assert s.dur is None and d is s  # the one shared no-op span
    assert obs.counters() == {} and obs.log_path() is None
    x = torch.ones(2, 8, 64, requires_grad=True)
    y = ops.fused_conv1d(x, torch.ones(3, 4, 8), dilation=2)
    torch.autograd.grad(y.sum(), x)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("hook", ["counter", "gauge", "span",
                                  "device_span"])
def test_disabled_hook_under_one_microsecond(hook):
    dev = torch.device("cpu")
    fn = {"counter": lambda: obs.counter("c"),
          "gauge": lambda: obs.gauge("g", 1.0),
          "span": lambda: obs.span("s"),
          "device_span": lambda: obs.device_span("s", dev)}[hook]
    n = 20_000
    sec = min(timeit.repeat(fn, number=n, repeat=5)) / n
    assert sec < 1e-6, f"disabled {hook} cost {sec * 1e9:.0f} ns"


def test_reenable_same_path_appends_and_flush_is_a_noop(tmp_path):
    path = obs.enable(str(tmp_path / "t.jsonl"))
    obs.event("one")
    assert obs.enable(path) == path
    obs.flush()  # no device span pending: nothing to write
    obs.event("two")
    obs.disable()
    assert [r["name"] for r in obs.read_events(path)] == ["provenance",
                                                          "one", "two"]


def test_close_attrs_and_device_span_on_cpu(tmp_path):
    """On a CPU device ``device_span`` is a host-clock span: written at
    exit, parented, ``close_attrs`` seeing its duration, no clock attr."""
    path = obs.enable(str(tmp_path / "t.jsonl"))
    with obs.span("outer"):
        with obs.device_span("inner", torch.device("cpu"),
                             lambda dur: {"twice": 2 * dur}, k=1):
            pass
    obs.disable()
    spans = {r["name"]: r for r in obs.read_events(path)
             if r["kind"] == "span"}
    inner = spans["inner"]
    assert inner["parent"] == spans["outer"]["id"]
    assert inner["attrs"]["twice"] == pytest.approx(2 * inner["dur"])
    assert "clock" not in inner["attrs"] and inner["attrs"]["k"] == 1


# --- report and trace export -------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reports_aggregate_one_log_alike(logs, writer):
    path = logs[writer]
    events = obs.read_events(path)
    agg, jagg = report.aggregate(events), jreport.aggregate(events)
    assert _same_json({**agg, "provenance": None},
                      {**jagg, "provenance": None})
    text, jtext = report.render_text(agg), jreport.render_text(jagg)
    drop = [i for i, ln in enumerate(text.splitlines())
            if ln.startswith("provenance:")]
    assert drop == [1]
    assert ([ln for i, ln in enumerate(text.splitlines()) if i not in drop]
            == [ln for i, ln in enumerate(jtext.splitlines())
                if i not in drop])
    for name in ("check", "check_serving", "check_model_parallel",
                 "check_elastic", "check_pipelining"):
        assert getattr(report, name)(agg) == getattr(jreport, name)(jagg)
    assert agg["steps"]["count"] == 1 and agg["tuner"]["hits"] == 1
    bwd = [k for k in agg["conv_cells"] if k.endswith("|bwd_weight")]
    assert bwd == ["dense|float32|N2|C8|K4|S3|d2|Q64|bwd_weight"]


def test_port_log_on_the_cpu_lacks_only_efficiency(logs):
    """No host peak: the port's CPU log misses the conv-efficiency line of
    the gate and nothing else; the JAX log (JAX's host peak) passes."""
    agg = report.aggregate_path(logs["port"])
    assert report.check(agg) == [
        "conv_cells (no measured conv1d pass efficiency)"]
    assert report.check(report.aggregate_path(logs["jax"])) == []


@pytest.mark.parametrize("flags", [[], ["--json"], ["--check"],
                                   ["--check-serving"],
                                   ["--check-model-parallel"],
                                   ["--check-elastic"],
                                   ["--check-pipelining"]])
def test_report_main_exit_codes_match(logs, flags, capsys):
    for path in logs.values():
        assert report.main([path, *flags]) == jreport.main([path, *flags])
    capsys.readouterr()


def test_report_cli_module(logs):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", logs["jax"],
         "--check"], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    assert "smoke gate OK" in out.stdout


def test_trace_export_matches(logs, tmp_path):
    for path in logs.values():
        events = obs.read_events(path)
        got, want = (trace_export.to_chrome_trace(events),
                     jtrace.to_chrome_trace(events))
        for t in (got, want):
            for e in t["traceEvents"]:
                if e["ph"] == "M":
                    e["args"]["name"] = e["args"]["name"].split(" ", 1)[1]
        assert _same_json(got, want)
    out = str(tmp_path / "trace.json")
    n = trace_export.export(logs["port"], out)
    with open(out) as f:
        trace = json.load(f)
    spans = [r for r in obs.read_events(logs["port"]) if r["kind"] == "span"]
    complete = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(trace["traceEvents"]) == n and len(complete) == len(spans)
    assert trace["metadata"]["provenance"]["torch_version"]
    assert trace_export.main([logs["port"], out]) == 0


# --- pass spans --------------------------------------------------------------

def _cells(recs):
    """{pass: set of (cell key, flops)} of the conv pass spans."""
    out: dict = {}
    for r in recs:
        if r["kind"] == "span" and r["name"].startswith("conv1d."):
            out.setdefault(r["name"][len("conv1d."):], set()).add(
                (report._conv_cell_key(r["attrs"]), r["attrs"]["flops"]))
    return out


def test_dense_pass_spans_have_jax_cells(tmp_path):
    jpath = jobs.enable(str(tmp_path / "j.jsonl"))
    _jax_passes()
    jops.conv1d(jnp.ones((2, 8, 64)), jnp.ones((3, 4, 8)), dilation=2,
                backend="pallas")
    jobs.disable()
    path = obs.enable(str(tmp_path / "p.jsonl"))
    _port_passes()
    ops.conv1d(torch.ones(2, 8, 64), torch.ones(3, 4, 8), dilation=2)
    obs.disable()
    port, jax_ = _cells(obs.read_events(path)), _cells(
        jobs.read_events(jpath))
    for p in ("fwd", "bwd_data", "bwd_weight"):
        assert port[p] == jax_[p], p
    spans = [r for r in obs.read_events(path) if r["kind"] == "span"]
    # the port's Function logs its forward too; JAX's vjp trace does not
    # (its one fwd span is the eager call's), so the port has two
    assert [r["attrs"]["backend"] for r in spans
            if r["name"] == "conv1d.fwd"] == ["cuda", "ref"]
    assert sum(r["name"] == "conv1d.fwd" for r in jobs.read_events(jpath)
               if r["kind"] == "span") == 1
    for r in spans:
        a = r["attrs"]
        assert a["gflops_per_s"] > 0 and "efficiency" not in a
        assert a["pipe_depth"] == 0 and a["dtype"] == "float32"


def test_depthwise_pass_spans_have_jax_cells(tmp_path):
    jpath = jobs.enable(str(tmp_path / "j.jsonl"))
    x, w = jnp.ones((2, 16, 64)), jnp.ones((4, 16))
    y, pull = jax.vjp(lambda w: jops.depthwise_conv1d(x, w,
                                                      backend="pallas"), w)
    pull(jnp.ones_like(y))
    jobs.disable()
    path = obs.enable(str(tmp_path / "p.jsonl"))
    xt = torch.ones(2, 16, 64, requires_grad=True)
    wt = torch.ones(4, 16, requires_grad=True)
    yt = ops.fused_depthwise_conv1d(F.pad(xt, (3, 0)), wt)
    torch.autograd.grad(yt, (xt, wt), torch.ones_like(yt))
    obs.disable()
    port, jax_ = _cells(obs.read_events(path)), _cells(
        jobs.read_events(jpath))
    assert set(jax_) == {"bwd_data", "bwd_weight"}
    assert set(port) == {"fwd", "bwd_data", "bwd_weight"}
    for p in ("bwd_data", "bwd_weight"):
        assert port[p] == jax_[p], p
    assert all(k.startswith("dw|") for cells in port.values()
               for k, _ in cells)


def test_bf16_cell_dtype_is_jax_name(tmp_path):
    path = obs.enable(str(tmp_path / "p.jsonl"))
    ops.conv1d(torch.ones(2, 8, 64, dtype=torch.bfloat16),
               torch.ones(3, 4, 8, dtype=torch.bfloat16), dilation=2)
    obs.disable()
    [span] = [r for r in obs.read_events(path) if r["kind"] == "span"]
    assert span["attrs"]["dtype"] == "bfloat16"


# --- tuner -------------------------------------------------------------------

def test_tuner_hit_miss_counters(tmp_path):
    cache = tune.TuneCache(str(tmp_path / "cache.json"))
    shape = dict(N=2, C=8, K=8, S=3, dilation=2, Q=128, dtype="float32",
                 device="cpu")
    tune.tune(**shape, cache=cache, measure=False)  # pre-populate
    path = obs.enable(str(tmp_path / "t.jsonl"))
    tune.get_config(**shape, cache=cache)                    # hit
    tune.get_config(**shape, cache=cache)                    # hit
    tune.get_config(**{**shape, "Q": 256}, cache=cache)      # miss
    obs.disable()
    totals = {r["name"]: r["total"]
              for r in obs.read_events(path) if r["kind"] == "counter"}
    assert totals == {"tune.cache.hit": 2, "tune.cache.miss": 1}


def test_tuner_search_events(tmp_path):
    cache = tune.TuneCache(str(tmp_path / "cache.json"))
    path = obs.enable(str(tmp_path / "t.jsonl"))
    tune.tune(N=2, C=8, K=8, S=3, dilation=2, Q=128, dtype="float32",
              device="cpu", cache=cache, measure=True, top_k=2, iters=2,
              warmup=1)
    obs.disable()
    recs = obs.read_events(path)
    cands = [r for r in recs if r["name"] == "tune.search.candidate"]
    assert len(cands) == 2
    for c in cands:
        assert c["attrs"]["predicted_s"] > 0 and c["attrs"]["measured_s"] > 0
    [search] = [r for r in recs
                if r["kind"] == "span" and r["name"] == "tune.search"]
    assert search["attrs"]["candidates"] >= 2
    agg = report.aggregate(recs)
    assert agg["cost_model"]["n"] == 2


# --- environment -------------------------------------------------------------

def test_env_opens_the_ports_default_path_only(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("REPRO_TELEMETRY", "REPRO_TORCH_TELEMETRY"))}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_TELEMETRY="1")
    code = ("import repro.obs, repro_torch.obs as o; o.event('x'); "
            "print(o.log_path(), repro.obs.enabled())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["repro_torch_telemetry.jsonl", "False"]
    assert sorted(os.listdir(tmp_path)) == ["repro_torch_telemetry.jsonl"]
    recs = obs.read_events(str(tmp_path / "repro_torch_telemetry.jsonl"))
    assert [r["name"] for r in recs] == ["provenance", "x"]


def test_docstring_example_runs():
    import doctest

    import repro_torch.obs
    res = doctest.testmod(repro_torch.obs)
    assert res.attempted > 0 and res.failed == 0


def test_device_span_inside_a_graph_capture_logs_a_trace_event(
        tmp_path, monkeypatch):
    """While the current stream captures a CUDA graph nothing may be
    recorded: a CUDA device span logs ``<name>.trace`` with its attrs and
    leaves nothing pending (the capture is stood in for on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    path = obs.enable(str(tmp_path / "t.jsonl"))
    with obs.device_span("conv1d.fwd", torch.device("cuda", 0), N=2) as sp:
        pass
    assert sp.dur is not None and sp.id is None
    obs.disable()
    recs = obs.read_events(path)
    assert [(r["kind"], r["name"], r["attrs"]) for r in recs[1:]] == [
        ("event", "conv1d.fwd.trace", {"N": 2})]
