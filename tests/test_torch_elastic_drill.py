"""Elastic-recovery drills of the port's trainer on 4 gloo ranks (the
counterpart of ``tests/test_elastic_drill.py``, which runs JAX's on 8
virtual devices).

One spawn of 4 ranks (``torch_dp_ranks.job_drills``, a file store a
drill, the Function path) runs the real supervisor
(``repro_torch.launch.train.run``) through the whole matrix at
``--smoke --steps 10 --batch 8 --seq 512``:

  A  an uninterrupted run, dp 4, its final checkpoint kept;
  B  ``device_loss@5:2``: launch ranks 2 and 3 drop out at step 5; the
     survivors re-plan dp 4 -> 2 at mp 1 with accumulation 1 -> 2 (the
     global batch preserved exactly), regroup, restore step 4 and replay
     on step-keyed batches; with telemetry, which ``check_elastic`` of
     both packages passes;
  C  ``preempt@5`` drains: a checkpoint of step 6, then a stop;
  D  ``--resume`` from C's checkpoint: the same layout, so the same
     program on the same data: bitwise A;
  E  ``straggle@5:1x6`` over 14 steps: shard 1 sleeps 5 x the fleet's
     clean time a step until the monitor votes REPLACE; launch rank 1 is
     rotated out, the 3 healthy ranks plan dp 2 and launch rank 3 sits
     out (``idle``);
  F  ``atacworks-bf16 --model-parallel 2``: (2, 2) -> (1, 2) on
     ``device_loss@5:2``, the model axis kept;
  X  B again, from a step-0 checkpoint written by the JAX package (its
     initial weights, random non-zero biases), beside JAX's own
     supervisor on 4 virtual devices (a child process) from the same
     checkpoint: the same recoveries and layouts, losses and final
     parameters within the JAX drill's bounds.

Bounds (``tests/test_elastic_drill.py``'s): the steps before the restore
point are generation 0's records, the same program as A's: bitwise.  From
the restore point on, dp 2 x accum 2 sums the same fp32 gradients in
another order: losses within rtol 1e-3 and atol 1e-4, the final
checkpoint within 1e-4 of each leaf's largest value.  Across the
packages (X) the same bounds hold from step 0, the final parameters held
to 1e-4 of each leaf's largest value.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
from repro.configs.base import reduced as jreduced
from repro.models import get_model
from repro.obs import report as jreport
from repro.train.train_step import init_state as jinit_state
from repro_torch import obs
from repro_torch.obs import report

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
COMMON = ["--arch", "atacworks", "--smoke", "--steps", "10", "--batch", "8",
          "--seq", "512"]
CROSS = COMMON + ["--ckpt-every", "2", "--resume",
                  "--faults", "device_loss@5:2"]
RTOL, ATOL, PARAM_TOL = 1e-3, 1e-4, 1e-4
RECOVERY_KEYS = ("kind", "fault_step", "restore_step", "dp_from", "dp_to",
                 "mp", "accum")
HISTORY_KEYS = ("dp", "mp", "accum", "from_step")

_JAX_CHILD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("REPRO_TELEMETRY", None)
from repro.launch.train import run
out = run(json.loads(sys.argv[1]))
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def _drills(base: str) -> list:
    port = COMMON + ["--device", "cpu"]
    return [
        ("A", port + ["--ckpt-dir", f"{base}/ckA", "--ckpt-every", "100"]),
        ("B", port + ["--ckpt-dir", f"{base}/ckB", "--ckpt-every", "2",
                      "--faults", "device_loss@5:2",
                      "--telemetry", f"{base}/elastic.jsonl"]),
        ("C", port + ["--ckpt-dir", f"{base}/ckC", "--ckpt-every", "4",
                      "--faults", "preempt@5"]),
        ("D", port + ["--ckpt-dir", f"{base}/ckC", "--resume"]),
        ("E", ["--arch", "atacworks", "--smoke", "--device", "cpu",
               "--steps", "14", "--batch", "8", "--seq", "512",
               "--ckpt-dir", f"{base}/ckE", "--ckpt-every", "2",
               "--faults", "straggle@5:1x6"]),
        ("F", ["--arch", "atacworks-bf16", "--smoke", "--device", "cpu",
               "--steps", "10", "--batch", "8", "--seq", "512",
               "--model-parallel", "2", "--ckpt-dir", f"{base}/ckF",
               "--ckpt-every", "2", "--faults", "device_loss@5:2"]),
        ("X", CROSS + ["--device", "cpu", "--ckpt-dir", f"{base}/ckX"]),
    ]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """Every rank's summary and printed lines of each drill, JAX's summary
    of X, and the drills' directory."""
    base = str(tmp_path_factory.mktemp("drill"))
    jcfg = jreduced(jconfigs.get("atacworks"))
    params = get_model(jcfg).init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(3)
    # random non-zero biases: at a zero bias a window of zero counts gives
    # a pre-activation of exactly 0, where JAX's xla backend passes half
    # the relu gradient and its Pallas VJP (as the port) none
    # (test_relu_gradient_at_a_tie_follows_the_pallas_vjp)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (0.1 * rng.standard_normal(p.shape)).astype(
            np.float32) if path[-1].key == "b" else p, params)
    JCheckpointer(f"{base}/ck0").save(jinit_state(params), 0)
    for d in ("ckX", "ckXjax"):
        shutil.copytree(f"{base}/ck0", f"{base}/{d}")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    child = subprocess.Popen(
        [sys.executable, "-c", _JAX_CHILD,
         json.dumps(CROSS + ["--ckpt-dir", f"{base}/ckXjax"]),
         f"{base}/jax.json"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        res = ranks.spawn(WORLD, "job_drills", f"{base}/ranks",
                          drills=_drills(base))
    finally:
        _, err = child.communicate(timeout=560)
    assert child.returncode == 0, err[-3000:]
    with open(f"{base}/jax.json") as f:
        jax_x = json.load(f)
    return dict(ranks=res, jax=jax_x, base=base)


def _lead(drill, name):
    return drill["ranks"][0][name]["summary"]


def _maxdiff(path_a, path_b, prefix=""):
    """The largest |a - b| over each leaf's largest |b|, over the leaves of
    two checkpoints' arrays whose keys start with ``prefix``."""
    d = 0.0
    with np.load(path_a) as a, np.load(path_b) as b:
        assert set(a.files) == set(b.files)
        for k in (k for k in a.files if k.startswith(prefix)):
            x = np.asarray(a[k], np.float64)
            y = np.asarray(b[k], np.float64)
            d = max(d, float(np.abs(x - y).max() / (np.abs(y).max() + 1e-9)))
    return d


def _final(drill, ck, step=10):
    return f"{drill['base']}/{ck}/step_{step:08d}/arrays.npz"


def _global_batch_preserved(summary):
    for gen in summary["mesh_history"]:
        # accum microbatches of (batch / accum) samples over dp whole shards
        assert summary["global_batch"] % gen["accum"] == 0
        assert (summary["global_batch"] // gen["accum"]) % gen["dp"] == 0


def _statuses(drill, name):
    return [r[name]["summary"]["status"] for r in drill["ranks"]]


def test_uninterrupted_run(drill):
    a = _lead(drill, "A")
    assert _statuses(drill, "A") == ["done"] * WORLD
    assert a["first_step"] == 0 and len(a["losses"]) == 10
    assert np.isfinite(a["losses"]).all() and a["recoveries"] == []
    assert [(g["dp"], g["accum"]) for g in a["mesh_history"]] == [(4, 1)]
    for r in drill["ranks"]:
        assert r["A"]["summary"]["losses"] == a["losses"]
    assert "dp=4 path=data_parallel" in drill["ranks"][0]["A"]["out"]


def test_device_loss_recovery(drill):
    b = _lead(drill, "B")
    assert _statuses(drill, "B") == ["done", "done", "lost", "lost"]
    assert b["status"] == "done" and len(b["recoveries"]) == 1
    rec = b["recoveries"][0]
    assert {k: rec[k] for k in RECOVERY_KEYS} == dict(
        kind="device_loss", fault_step=5, restore_step=4, dp_from=4, dp_to=2,
        mp=1, accum=2)
    assert rec["time_to_detect_s"] > 0 and rec["time_to_restore_s"] > 0
    assert [(g["dp"], g["mp"], g["accum"], g["from_step"])
            for g in b["mesh_history"]] == [(4, 1, 1, 0), (2, 1, 2, 4)]
    _global_batch_preserved(b)
    # the victims stopped after their last clean step
    for r in drill["ranks"][2:]:
        lost = r["B"]["summary"]
        assert lost["last_step"] == 4 and lost["recoveries"] == []
    assert drill["ranks"][1]["B"]["summary"]["losses"] == b["losses"]
    out = drill["ranks"][0]["B"]["out"]
    assert "elastic: device loss at step 5 (launch ranks [2, 3])" in out
    assert "accum=2 dp=2 path=data_parallel generation=1" in out


def test_post_recovery_trajectory_matches_uninterrupted(drill):
    a, b = _lead(drill, "A"), _lead(drill, "B")
    r = b["recoveries"][0]["restore_step"]
    assert len(a["losses"]) == len(b["losses"]) == 10
    assert b["losses"][:r] == a["losses"][:r]
    np.testing.assert_allclose(b["losses"][r:], a["losses"][r:], rtol=RTOL,
                               atol=ATOL)
    assert _maxdiff(_final(drill, "ckB"), _final(drill, "ckA")) < PARAM_TOL


def test_elastic_telemetry_gate(drill):
    """Both packages' reports pass ``check_elastic`` on B's log: one fault,
    one detection, one recovery that shrank the data axis, and steps after
    it; the events are rank 0's alone."""
    recs = obs.read_events(f"{drill['base']}/elastic.jsonl")
    agg = report.aggregate(recs)
    assert report.check_elastic(agg) == []
    assert jreport.check_elastic(jreport.aggregate(recs)) == []
    el = agg["elastic"]
    assert el["faults"] == {"device_loss": 1}
    assert el["detect"]["device_loss"]["count"] == 1
    assert el["post_recovery_steps"] >= 5  # steps 4..9 re-ran after
    rec = el["recoveries"][0]
    assert (rec["dp_from"], rec["dp_to"], rec["restore_step"]) == (4, 2, 4)
    assert {r["pid"] for r in recs if r["name"].startswith("elastic.")} \
        == {0}
    rollups = [r for r in recs if r["name"] == "train.straggler.rollup"
               and "generation" in r.get("attrs", {})]
    assert [r["attrs"]["generation"] for r in rollups] == [0]


def test_preempt_drains_and_resume_is_exact(drill):
    c, d, a = _lead(drill, "C"), _lead(drill, "D"), _lead(drill, "A")
    assert _statuses(drill, "C") == ["preempted"] * WORLD
    assert c["last_step"] == 5  # drained after step 5
    assert _statuses(drill, "D") == ["done"] * WORLD
    assert d["first_step"] == 6  # resumed from the drain
    assert c["losses"] == a["losses"][:6]
    assert d["losses"] == a["losses"][6:]
    assert _maxdiff(_final(drill, "ckC"), _final(drill, "ckA")) == 0.0
    _global_batch_preserved(c)
    _global_batch_preserved(d)


def test_straggler_rotation(drill):
    e = _lead(drill, "E")
    assert _statuses(drill, "E") == ["done", "lost", "done", "idle"]
    assert len(e["recoveries"]) == 1
    rec = e["recoveries"][0]
    assert rec["kind"] == "straggle" and rec["dp_from"] == 4
    assert rec["dp_to"] < 4 and rec["mp"] == 1
    assert rec["fault_step"] >= 5 + 2  # trip: 3 slow steps in a row
    assert rec["time_to_detect_s"] > 0
    assert len(e["losses"]) == 14 and np.isfinite(e["losses"]).all()
    _global_batch_preserved(e)
    out = drill["ranks"][0]["E"]["out"]
    assert "elastic: straggler shard 1 voted REPLACE" in out
    assert "(launch ranks [1])" in out


def test_model_axis_kept_on_device_loss(drill):
    f = _lead(drill, "F")
    assert _statuses(drill, "F") == ["done", "done", "lost", "lost"]
    rec = f["recoveries"][0]
    assert {k: rec[k] for k in RECOVERY_KEYS} == dict(
        kind="device_loss", fault_step=5, restore_step=4, dp_from=2, dp_to=1,
        mp=2, accum=2)
    assert [(g["dp"], g["mp"]) for g in f["mesh_history"]] == [(2, 2),
                                                                (1, 2)]
    assert len(f["losses"]) == 10 and np.isfinite(f["losses"]).all()
    assert "dp=1 mp=2 path=model_parallel" in drill["ranks"][0]["F"]["out"]
    _global_batch_preserved(f)


def test_drill_efficiency_metrics(drill):
    """Every recovery carries the measured drill metrics."""
    for name in ("B", "E", "F"):
        for rec in _lead(drill, name)["recoveries"]:
            assert rec["pre_fault_step_s"] > 0
            assert rec["post_recovery_step_s"] > 0
            assert rec["post_shrink_efficiency"] > 0
        for gen in _lead(drill, name)["mesh_history"]:
            assert gen["steps_run"] > 0 and gen["median_step_s"] > 0


def test_recovery_matches_jax(drill):
    """X: the port's supervisor and JAX's, from the same step-0
    checkpoint written by JAX, re-plan and restore alike."""
    port, jx = _lead(drill, "X"), drill["jax"]
    assert port["status"] == jx["status"] == "done"
    assert [{k: r[k] for k in RECOVERY_KEYS} for r in port["recoveries"]] \
        == [{k: r[k] for k in RECOVERY_KEYS} for r in jx["recoveries"]]
    assert [{k: g[k] for k in HISTORY_KEYS} for g in port["mesh_history"]] \
        == [{k: g[k] for k in HISTORY_KEYS} for g in jx["mesh_history"]]
    assert (port["first_step"], port["last_step"]) == (0, 9)


def test_trajectory_matches_jax(drill):
    port, jx = _lead(drill, "X"), drill["jax"]
    np.testing.assert_allclose(port["losses"], jx["losses"], rtol=RTOL,
                               atol=ATOL)
    # the parameters: the optimizer's moments, sums of squared gradients
    # of another fp32 order, are not held (4.2e-4 of their largest value
    # at res.2.conv1 on the CPU)
    assert _maxdiff(_final(drill, "ckX"), _final(drill, "ckXjax"),
                    ".params/") < PARAM_TOL
