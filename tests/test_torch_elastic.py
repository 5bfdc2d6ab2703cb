"""The port's elastic plans, fault injector and async checkpoints
(``repro_torch.runtime.elastic``, ``runtime.faults``,
``checkpoint.Checkpointer.save_async``) against the JAX package's, on the
CPU.

  * ``plan_mesh``, ``plan_batch`` and ``make_plan`` over a sweep of rank
    counts, model widths, pod sizes, global batches and microbatch caps:
    the same plan from both packages, or a refusal from both (JAX
    asserts; the port raises ``ValueError``); the modules' doctests;
  * ``parse_faults`` on the grammar's examples and on malformed specs
    (the same faults, or the same ``ValueError`` text), and one scripted
    sequence of ``poll``, ``commit_loss``, ``mark_lost``, ``healthy`` and
    the straggle calls giving the same results in both;
  * ``save_async``: the snapshot is taken before it returns, so an
    in-place update of the state afterwards does not reach the file; a
    writer that dies mid-write leaves no visible checkpoint; an async
    checkpoint crosses between the packages both ways;
  * the launcher's refusals: a drill without ``--ckpt-dir``, and a device
    loss that leaves fewer ranks than the model axis, with JAX's
    messages; ``regroup`` without the store ``init_data_group`` keeps.
"""
from __future__ import annotations

import dataclasses
import doctest
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import reduced as jreduced
from repro.core import blocks as jblocks
from repro.launch import train as jtrain
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.launch import mesh, train
from repro_torch.runtime import elastic, faults
from repro_torch.train.train_step import init_state


def _outcome(fn, *args, **kw):
    """``("ok", result)`` or ``("refused", None)``: the JAX package refuses
    with an ``AssertionError``, the port with a ``ValueError``."""
    try:
        out = fn(*args, **kw)
    except (AssertionError, ValueError):
        return ("refused", None)
    if dataclasses.is_dataclass(out):
        out = dataclasses.astuple(out)
    return ("ok", out)


# --- plans -------------------------------------------------------------------

@pytest.mark.parametrize("mp", [1, 2, 4])
def test_make_plan_matches_jax(mp):
    """Every (n_devices 1..16, pod_size, global batch, cap) at this model
    width: the same plan or a refusal from both packages."""
    seen = {"ok": 0, "refused": 0}
    for n in range(1, 17):
        for pod in (None, 2, 4):
            for gb in (4, 6, 8, 12, 24):
                for cap in range(1, 5):
                    kw = dict(model_parallel=mp, global_batch=gb,
                              pod_size=pod, max_microbatch_per_shard=cap)
                    got = _outcome(elastic.make_plan, n, **kw)
                    want = _outcome(jelastic.make_plan, n, **kw)
                    assert got == want, (n, kw)
                    seen[got[0]] += 1
                    if got[0] == "ok":
                        plan = elastic.make_plan(n, **kw)
                        accum, micro = plan.accum_steps, plan.microbatch
                        assert accum * micro == gb  # the global batch
    assert seen["ok"] and (mp == 1 or seen["refused"])


def test_plan_mesh_matches_jax():
    for n in range(0, 17):
        for mp in (1, 2, 4):
            for pod in (None, 2, 4):
                kw = dict(model_parallel=mp, pod_size=pod)
                assert _outcome(elastic.plan_mesh, n, **kw) == _outcome(
                    jelastic.plan_mesh, n, **kw), (n, kw)
    assert _outcome(elastic.plan_mesh, 1, model_parallel=2)[0] == "refused"


def test_plan_batch_matches_jax():
    for gb in (4, 6, 8, 12, 24):
        for dp in range(1, 17):
            for cap in range(1, 5):
                kw = dict(max_microbatch_per_shard=cap)
                assert _outcome(elastic.plan_batch, gb, dp, **kw) == \
                    _outcome(jelastic.plan_batch, gb, dp, **kw), (gb, dp, cap)
    # 4 does not divide the 6 a shard holds: walk down to 3, accum 2
    assert elastic.plan_batch(24, 4, max_microbatch_per_shard=4) == (2, 12)


@pytest.mark.parametrize("module", [elastic, faults])
def test_doctests(module):
    """The modules' examples, which are the JAX package's."""
    res = doctest.testmod(module)
    assert res.attempted >= 2 and res.failed == 0


def test_build_groups_refuses_a_plan_larger_than_the_survivors():
    plan = elastic.make_plan(4, model_parallel=1, global_batch=8)
    with pytest.raises(ValueError, match="needs 4 ranks, only 3 healthy"):
        elastic.build_groups(plan, [0, 1, 2], 1)


def test_regroup_needs_the_kept_rendezvous():
    mesh.destroy()
    with pytest.raises(ValueError, match="init_data_group"):
        mesh.regroup([0], 1)
    assert mesh.launch_rank() == 0


# --- faults ------------------------------------------------------------------

GOOD_SPECS = ["device_loss@5:4", "device_loss@5", "straggle@4:1x3",
              "straggle@4", "straggle@6:2", "preempt@9",
              "device_loss@5:4,preempt@9", " preempt@3 , ,device_loss@1:2",
              "preempt@8,straggle@2:0x1.5,device_loss@4:1", ""]
BAD_SPECS = ["explode@3", "device_loss@x", "device_loss@5:y", "preempt@",
             "preempt", "straggle@4:1xabc", "straggle@q:1x2",
             "preempt@3,oops@4"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_faults_matches_jax(spec):
    got = [dataclasses.astuple(f) for f in faults.parse_faults(spec)]
    want = [dataclasses.astuple(f) for f in jfaults.parse_faults(spec)]
    assert got == want
    assert [f[1] for f in got] == sorted(f[1] for f in got)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_fault_specs_raise_in_both(spec):
    with pytest.raises(ValueError) as got:
        faults.parse_faults(spec)
    with pytest.raises(ValueError) as want:
        jfaults.parse_faults(spec)
    assert str(got.value) == str(want.value)
    assert "grammar: device_loss@STEP:N" in str(got.value)


def _script(mod):
    """One scripted drill over 8 ranks: the polls of 14 steps, with the
    injector's answers at each."""
    inj = mod.FaultInjector(
        mod.parse_faults("device_loss@3:2,straggle@5:1x4,preempt@9,"
                         "device_loss@11:3"), range(8))
    trace = []
    for step in list(range(0, 7)) + list(range(4, 14)):  # a replay from 4
        f = inj.poll(step)
        row = [step, f and dataclasses.astuple(f)]
        if f is not None and f.kind == "device_loss":
            row.append(sorted(inj.commit_loss(f)))
        if f is not None and f.kind == "straggle":
            inj.begin_straggle(f, float(step))
        if step == 8 and inj.straggle_active() is not None:
            row.append(inj.straggle_onset())
            inj.mark_lost([1])
            inj.end_straggle()
        active = inj.straggle_active()
        row += [inj.healthy(), sorted(inj.lost()),
                active and dataclasses.astuple(active)]
        trace.append(row)
    return trace


def test_fault_injector_matches_jax():
    got, want = _script(faults), _script(jfaults)
    assert got == want
    assert got[-1][-3] == [0, 2]  # 8 - 2 - 1 (rotated) - 3


# --- async checkpoints ------------------------------------------------------

@pytest.fixture(scope="module")
def cfgs():
    return jreduced(jconfigs.get("atacworks")), reduced(
        configs.get("atacworks"))


def _state(cfg, seed):
    state = init_state(blocks.init_params(cfg, seed=seed))
    g = torch.Generator().manual_seed(seed)
    for t in list(state.opt.m.values()) + list(state.opt.v.values()):
        t.copy_(torch.rand(t.shape, generator=g))
    state.step = state.step + seed
    return state


def _copy(state) -> dict[str, torch.Tensor]:
    return {k: t.detach().clone()
            for k, t in ckpt.state_tensors(state).items()}


def _assert_state(state, want: dict):
    got = ckpt.state_tensors(state)
    assert set(got) == set(want) and len(got) == 152
    for k, t in want.items():
        assert torch.equal(got[k], t), k


def test_save_async_stores_the_state_it_was_given(cfgs, tmp_path,
                                                  monkeypatch):
    """The optimizer updates the parameters in place: a change made after
    ``save_async`` returns must not reach the file, even while the writer
    has not written yet (the writer waits for the change here)."""
    _, cfg = cfgs
    state = _state(cfg, 1)
    before = _copy(state)
    changed = threading.Event()
    savez = np.savez

    def late_savez(*a, **kw):  # the writer starts after the change
        assert changed.wait(30)
        return savez(*a, **kw)

    monkeypatch.setattr(ckpt.np, "savez", late_savez)
    c = ckpt.Checkpointer(str(tmp_path))
    c.save_async(state, 3)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    for t in state.opt.m.values():
        t.mul_(-1.0)
    changed.set()
    c.wait()
    assert c.all_steps() == [3]
    _assert_state(c.restore(_state(cfg, 2), step=3), before)


def test_killed_async_writer_leaves_no_checkpoint(cfgs, tmp_path,
                                                   monkeypatch, capsys):
    """A writer dying mid-write (the manifest's ``json.dump`` raises after
    ``arrays.npz`` is written, before the COMMIT marker) leaves the
    committed steps as they were (JAX's ``test_kill_mid_async_save``)."""
    _, cfg = cfgs
    c = ckpt.Checkpointer(str(tmp_path))
    first = _state(cfg, 7)
    c.save(first, 1)
    want = _copy(first)

    def dead(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(json, "dump", dead)
    c.save_async(_state(cfg, 8), 2)
    c.wait()
    monkeypatch.undo()
    assert "async save of step 2 failed" in capsys.readouterr().out
    assert c.all_steps() == [1] and c.latest_step() == 1
    _assert_state(c.restore(_state(cfg, 9)), want)
    c.save(_state(cfg, 10), 3)  # the next save sweeps the torn .tmp
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_async_checkpoint_port_writes_jax_restores(cfgs, tmp_path):
    jcfg, cfg = cfgs
    state = _state(cfg, 4)
    c = ckpt.Checkpointer(str(tmp_path))
    c.save_async(state, 5)
    c.wait()
    template = jtrain_step.init_state(
        jblocks.init_params(jax.random.key(1), jcfg))
    flat = jckpt._flatten(jckpt.Checkpointer(str(tmp_path)).restore(template))
    ours = ckpt.state_tensors(state)
    assert set(flat) == set(ours)
    for k, t in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      t.detach().numpy(), err_msg=k)


def test_async_checkpoint_jax_writes_port_restores(cfgs, tmp_path):
    jcfg, cfg = cfgs
    params = jblocks.init_params(jax.random.key(2), jcfg)
    jstate = jtrain_step.init_state(params)._replace(
        step=jnp.asarray(6, jnp.int32))
    jc = jckpt.Checkpointer(str(tmp_path))
    jc.save_async(jstate, 6)
    jc.wait()
    state = ckpt.Checkpointer(str(tmp_path)).restore(_state(cfg, 3))
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg)
    assert int(state.step) == 6
    _assert_state(state, ckpt.state_tensors(want))


# --- the launcher's refusals -------------------------------------------------

def test_drill_without_ckpt_dir_exits_with_jax_message():
    argv = ["--arch", "atacworks", "--faults", "device_loss@5:1"]
    with pytest.raises(SystemExit) as got:
        train.run(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jtrain.run(argv)
    assert str(got.value) == str(want.value)
    assert "needs --ckpt-dir" in str(got.value)


def test_device_loss_of_the_only_rank_exits_with_jax_message(tmp_path):
    """One process, model axis 1: the loss at step 2 leaves no rank; both
    launchers stop with the same message after the tainted step."""
    argv = ["--arch", "atacworks", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "128", "--faults", "device_loss@2:1"]
    with pytest.raises(SystemExit) as got:
        train.run(argv + ["--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "port")])
    with pytest.raises(SystemExit) as want:
        jtrain.run(argv + ["--ckpt-dir", str(tmp_path / "jax")])
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("only 0 healthy device(s) left")
    # both saved the bootstrap restore point, and nothing after it
    assert ckpt.Checkpointer(str(tmp_path / "port")).all_steps() == \
        jckpt.Checkpointer(str(tmp_path / "jax")).all_steps()


# --- a reference behaviour the cross-package drill meets ------------------

def test_relu_gradient_at_a_tie_follows_the_pallas_vjp():
    """A pre-activation of exactly 0 (a zero bias over a window of zero
    counts, as at AtacWorks' initialisation): JAX's Pallas custom VJP
    masks the relu gradient with ``y > 0`` and passes none, as the port's
    plain version and ``Conv1dFunction`` do, while JAX's ``xla`` and
    ``ref`` backends differentiate ``jnp.maximum(u, 0)`` and pass half.
    The drill against JAX's launcher (its ``xla`` default) therefore
    starts from non-zero biases."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    x = np.zeros((1, 2, 16), np.float32)
    w = np.full((3, 4, 2), -0.1, np.float32)
    b = np.zeros(4, np.float32)

    def jax_grad(backend):
        def f(b):
            return jops.conv1d(jnp.asarray(x), jnp.asarray(w), bias=b,
                               activation="relu", padding="SAME",
                               backend=backend).sum()
        return np.asarray(jax.grad(f)(jnp.asarray(b)))

    bt = torch.zeros(4, requires_grad=True)
    y = ops.conv1d(torch.from_numpy(x), torch.from_numpy(w), bias=bt,
                   activation="relu", padding="SAME")
    port = torch.autograd.grad(y.sum(), [bt])[0].numpy()
    np.testing.assert_array_equal(port, jax_grad("pallas"))
    np.testing.assert_array_equal(port, np.zeros(4, np.float32))
    np.testing.assert_array_equal(jax_grad("xla"), np.full(4, 8.0))
