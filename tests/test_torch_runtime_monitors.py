"""The port's step monitors (``repro_torch.runtime``) against the JAX
package's (``repro.runtime``), and the launchers' telemetry, on the CPU.

  * ``HealthMonitor`` and ``ShardStragglerMonitor`` against JAX's on one
    seeded sequence of step times and losses (skipped steps, loss spikes,
    a straggling shard): the same verdicts, ``feed_gauges`` result and
    rollups;
  * the trainer (``--smoke --device cpu --steps 4``) for ``atacworks``
    and ``mamba2-370m``: losses and gradient norms bitwise equal with and
    without ``--telemetry``; the log holds the step spans, the probe
    step's three phases, a gauge a step and both rollups;
  * health ``restore`` and ``PreemptionGuard`` in the trainer;
  * serving (conv streams and LM decode) bitwise equal with telemetry on
    and off, with its request spans;
  * 2 gloo ranks as (1, 2) (``tests/torch_mp_ranks.py``) sharing one log:
    both packages' ``check_model_parallel`` pass on it, and both ranks'
    records are there, every line whole.
"""
from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.obs import report as jreport
from repro.runtime.health import HealthMonitor as JHealth
from repro.runtime.straggler import ShardStragglerMonitor as JShard
from repro_torch import configs, obs
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.launch import serve, train
from repro_torch.models import init_model
from repro_torch.obs import report
from repro_torch.runtime.health import HealthMonitor, PreemptionGuard
from repro_torch.runtime.straggler import ShardStragglerMonitor
from repro_torch.train.train_step import init_state

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    obs.disable()
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    yield
    obs.disable()


# --- the monitors ------------------------------------------------------------

def _sequence(seed=0, steps=40, shards=3):
    """Per step: a loss (a spike at 17, non-finite streaks at 8-9 and from
    30), whether the step was skipped, and each shard's step time (shard
    2 three times slower from step 24)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        loss = float(2.0 + rng.normal(0, 0.05))
        if i == 17:
            loss *= 30
        skipped = i in (8, 9) or i >= 30
        times = [float(0.1 + rng.normal(0, 0.002)) for _ in range(shards)]
        if i >= 24:
            times[2] *= 3
        out.append((i, loss, skipped, times))
    return out


def test_health_monitor_matches_jax():
    seq = _sequence()
    port, jax_ = HealthMonitor(), JHealth()
    got = [port.record(i, loss, sk) for i, loss, sk, _ in seq]
    want = [jax_.record(i, loss, sk) for i, loss, sk, _ in seq]
    assert got == want
    assert {"ok", "warn", "restore"} <= set(got)
    assert port.rollup() == jax_.rollup() and port.events == jax_.events


def test_shard_straggler_monitor_matches_jax():
    seq = _sequence()
    port, jax_ = ShardStragglerMonitor(trip=3), JShard(trip=3)
    got = [[port.record(s, i, t) for s, t in enumerate(ts)]
           for i, _, _, ts in seq]
    want = [[jax_.record(s, i, t) for s, t in enumerate(ts)]
            for i, _, _, ts in seq]
    assert got == want and got[-1][2] == "replace"
    assert port.stragglers() == jax_.stragglers() == {2}
    assert port.rollup() == jax_.rollup()
    gauges = [{"kind": "gauge", "name": "train.shard.step_time",
               "ts": float(i), "pid": 0, "value": t,
               "attrs": {"shard": s, "step": i}}
              for i, _, _, ts in seq for s, t in enumerate(ts)]
    fed, jfed = ShardStragglerMonitor(), JShard()
    assert fed.feed_gauges(gauges) == jfed.feed_gauges(gauges)
    assert fed.rollup() == jfed.rollup()


def test_preemption_guard_restores_the_previous_handler():
    import signal
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    assert signal.getsignal(signal.SIGTERM) == guard._handler
    assert not guard.preempted()
    guard.request()
    assert guard.preempted()
    guard.close()
    assert signal.getsignal(signal.SIGTERM) == before


# --- the trainer -------------------------------------------------------------

ATAC = ["--arch", "atacworks", "--smoke", "--device", "cpu", "--steps", "4",
        "--batch", "2", "--seq", "512"]
M2 = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--steps", "4",
      "--batch", "2", "--seq", "40"]


@pytest.mark.parametrize("argv", [ATAC, M2], ids=["atacworks", "mamba2"])
def test_trainer_telemetry_moves_no_value(argv, tmp_path, capsys):
    plain = train.run(argv)
    path = str(tmp_path / "t.jsonl")
    told = train.run(argv + ["--telemetry", path])
    assert not obs.enabled()  # the run closed the sink it opened
    for k in ("losses", "grad_norms", "skipped_steps"):
        assert told[k] == plain[k], k
    assert told["status"] == "done" and told["health"]["events"] == 0
    recs = obs.read_events(path)
    names = [r["name"] for r in recs]
    for name in ("train.step", "train.step.data", "train.shard.step_time"):
        assert names.count(name) == 4, name
    for phase in ("forward", "backward", "optimizer"):
        assert names.count(f"train.phase.{phase}") == 1, phase
    assert "train.phase.psum" not in names  # dp == 1
    assert {"train.health.rollup", "train.straggler.rollup"} <= set(names)
    steps = [r for r in recs if r["name"] == "train.step"]
    assert [r["attrs"]["loss"] for r in steps] == plain["losses"]
    agg = report.aggregate(recs)
    assert agg["shards"]["per_shard"]["0"]["verdicts"] == {"ok": 4}
    assert "[ok/ok]" in capsys.readouterr().out
    if argv is ATAC:
        # the probe step's conv cell through "auto": tuner counters and
        # its three passes at batch 1 x 512; no host peak on the CPU
        assert report.check(agg) == [
            "conv_cells (no measured conv1d pass efficiency)"]
        probe = [k for k in agg["conv_cells"] if "|N1|" in k]
        assert sorted(k.rsplit("|", 1)[1] for k in probe) == [
            "bwd_data", "bwd_weight", "fwd"]
    else:
        assert all(k.startswith("dw|") for k in agg["conv_cells"])


def test_trainer_health_restore(tmp_path, monkeypatch, capsys):
    """A ``restore`` verdict at step 3 restores the step-2 checkpoint: the
    run ends 2 optimizer steps behind its step count."""
    class Restore(HealthMonitor):
        def record(self, step, loss, skipped):
            verdict = super().record(step, loss, skipped)
            return "restore" if step == 3 else verdict

    monkeypatch.setattr(train, "HealthMonitor", Restore)
    ckpt = str(tmp_path / "ckpt")
    out = train.run(ATAC[:5] + ["--steps", "5", "--batch", "2", "--seq",
                                "256", "--ckpt-dir", ckpt,
                                "--ckpt-every", "2"])
    assert out["status"] == "done"
    assert "health: restoring the newest checkpoint" in capsys.readouterr().out
    state = Checkpointer(ckpt).restore(
        init_state(init_model(reduced(configs.get("atacworks")))))
    assert int(state.step) == 3  # 5 steps run, 2 of them undone


def test_trainer_preemption_saves_and_stops(tmp_path, monkeypatch, capsys):
    class Preempted(PreemptionGuard):
        polls = 0

        def preempted(self):
            Preempted.polls += 1
            if Preempted.polls == 2:
                self.request()
            return super().preempted()

    monkeypatch.setattr(train, "PreemptionGuard", Preempted)
    ckpt = str(tmp_path / "ckpt")
    out = train.run(ATAC + ["--ckpt-dir", ckpt])
    assert out["status"] == "preempted" and len(out["losses"]) == 2
    assert "preemption: saving a checkpoint" in capsys.readouterr().out
    assert Checkpointer(ckpt).all_steps() == [2]


# --- serving -----------------------------------------------------------------

def _serve_conv(cfg, model):
    rng = np.random.default_rng(0)
    server = serve.ConvStreamServer(model, cfg, batch=2, chunk=128,
                                    prompt_len=64, device="cpu")
    for rid in range(3):
        server.submit(serve.StreamRequest(
            rid, rng.normal(size=300 + 40 * rid).astype(np.float32),
            history=rng.normal(size=64).astype(np.float32)))
    return server, [np.stack(r.result()) for r in server.run()]


def test_conv_serving_telemetry_moves_no_value(tmp_path):
    cfg = reduced(configs.get("atacworks"))
    model = blocks.init_params(cfg, seed=1)
    _, plain = _serve_conv(cfg, model)
    path = obs.enable(str(tmp_path / "s.jsonl"))
    server, told = _serve_conv(cfg, model)
    obs.disable()
    assert all(np.array_equal(a, b) for a, b in zip(told, plain))
    recs = obs.read_events(path)
    chunks = [r for r in recs if r["name"] == "serve.conv.chunk"]
    assert len(chunks) == server.chunks_run
    assert chunks[0]["attrs"] == {"arch": cfg.name, "batch": 2,
                                  "chunk": 128}
    assert sum(r["name"] == "serve.conv.prefill" for r in recs) == 3
    agg = report.aggregate(recs)
    assert report.check_serving(agg) == jreport.check_serving(agg) == []
    # every stream step's 25 conv layers ran under its chunk span
    fwd = [r for r in recs if r["name"] == "conv1d.fwd"]
    chunk_ids = {r["id"] for r in chunks}
    assert sum(r["parent"] in chunk_ids for r in fwd) == (
        server.chunks_run * (3 + 2 * blocks.N_RES_BLOCKS))


def test_lm_serving_telemetry_moves_no_value(tmp_path):
    cfg = reduced(configs.get("mamba2-370m"))
    model = init_model(cfg, seed=0)
    args = SimpleNamespace(model_parallel=1, prompt_len=6, gen=5, batch=2,
                           device="cpu", seed=0, smoke=False)
    plain = serve.serve_lm(args, cfg, model)
    path = obs.enable(str(tmp_path / "s.jsonl"))
    told = serve.serve_lm(args, cfg, model)
    obs.disable()
    assert np.array_equal(told["tokens"], plain["tokens"])
    names = [r["name"] for r in obs.read_events(path)]
    # 6 prompt steps and 4 generated: one decode span each
    assert names.count("serve.decode_step") == 10
    assert names.count("serve.prefill") == 1


# --- two ranks, one log ------------------------------------------------------

def test_model_parallel_ranks_share_one_log(tmp_path):
    path = str(tmp_path / "mp.jsonl")
    argv = ATAC[:5] + ["--batch", "2", "--seq", "256", "--steps", "3",
                       "--model-parallel", "2", "--telemetry", path,
                       "--ckpt-dir", str(tmp_path / "ckpt")]
    res = ranks.spawn(2, 2, "job_launcher", tmp_path, argv=argv)
    assert res[0]["summary"]["losses"] == res[1]["summary"]["losses"]
    with open(path) as f:
        lines = f.read().splitlines()
    recs = [obs.validate(__import__("json").loads(ln)) for ln in lines]
    assert {r["pid"] for r in recs} == {0, 1}
    provs = [r for r in recs if r["kind"] == "meta"]
    assert sorted(r["attrs"]["process_index"] for r in provs) == [0, 1]
    agg = report.aggregate(recs)
    assert report.check_model_parallel(agg) == []
    assert jreport.check_model_parallel(jreport.aggregate(recs)) == []
    assert agg["mesh"] == {"dp": 1, "mp": 2, "axes": "data,model"}
    assert sorted(agg["shards"]["per_shard"]) == ["0", "1"]
    # the launcher's one dx sum a K-sharded layer a step, per rank
    psums = sum(m["count"] for m in agg["model_psum"].values())
    assert psums > 0 and psums % 2 == 0
