"""The port's training slice (``repro_torch``: loss, AdamW, schedule,
synthetic data, train step, checkpoints, launcher) against the JAX package,
on the CPU.

The reduced AtacWorks config (C=8, S=9, dilation 8, 25 layers) with the
JAX package's initial weights and random non-zero biases runs through both
packages on the same batches (``atacseq_batch``, bitwise equal across the
packages from one seed).  The JAX side uses its ``xla`` conv backend (its
CPU default; the Pallas custom VJP is held against it per layer in
``test_torch_kernels.py``).  The port runs its plain version and, where
named, ``ops.Conv1dFunction`` on CPU tensors, whose wrappers then compute
each pass's plain version.

Tolerances: the loss within rtol 1e-5 and each gradient within 1e-4 of its
largest value (fp32, 25 layers of sums taken in another order); over five
AdamW steps the losses within rtol 1e-4 and the parameters within 1e-5
absolute (lr 1e-3).  AdamW's first steps are sign-like: ``m / sqrt(v)`` is
about +-1 whatever a gradient element's size, so the two frameworks'
rounding reaches the parameters undamped by small gradients, and a
near-zero element whose sign the rounding set differently would move by
up to ``lr`` the other way, which this bound would show.  Measured: 9.1e-7
with and without accumulation.
"""
from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import reduced as jreduced
from repro.core import blocks as jblocks
from repro.data import synthetic as jsynthetic
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.optim import adamw, schedule
from repro_torch.train import losses
from repro_torch.train.train_step import init_state, make_train_step

BATCH, WIDTH = 2, 256
LR = 1e-3


@pytest.fixture(scope="module")
def cfgs():
    return jreduced(jconfigs.get("atacworks")), reduced(
        configs.get("atacworks"))


@pytest.fixture(scope="module")
def jparams(cfgs):
    """The JAX package's initial parameters with random non-zero biases
    (zeros at init would leave the bias path untested), as numpy."""
    jcfg, _ = cfgs
    tree = jax.tree.map(np.asarray,
                        jblocks.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(3)

    def with_bias(p):
        return {"w": p["w"], "b": (0.1 * rng.standard_normal(p["b"].shape)
                                   ).astype(np.float32)}

    return {"stem": with_bias(tree["stem"]),
            "res": [{k: with_bias(v) for k, v in blk.items()}
                    for blk in tree["res"]],
            "head_signal": with_bias(tree["head_signal"]),
            "head_peak": with_bias(tree["head_peak"])}


def _batch_np(seed, batch=BATCH, width=WIDTH):
    return synthetic.atacseq_batch(np.random.default_rng(seed), batch, width)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _model(cfg, jparams):
    model = blocks.init_params(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    return model


def _kernel_path(monkeypatch):
    """Route every layer's conv through ``ops.Conv1dFunction`` on CPU
    tensors (the path a CUDA tensor takes, with plain passes)."""
    def conv1d(x, w, *, padding="SAME", dilation=1, backend=None, **kw):
        assert backend is None
        lo, hi = ops._pad_amounts(w.shape[0], dilation, padding)
        return ops.fused_conv1d(F.pad(x, (lo, hi)).contiguous(),
                                w.contiguous(), dilation=dilation, **kw)
    monkeypatch.setattr(ops, "conv1d", conv1d)


# --- data ----------------------------------------------------------------

@pytest.mark.parametrize("seed,batch,width", [(0, 2, 256), (7, 3, 60_000)])
def test_atacseq_batch_is_bitwise_the_jax_packages(seed, batch, width):
    got = synthetic.atacseq_batch(np.random.default_rng(seed), batch, width)
    want = jsynthetic.atacseq_batch(np.random.default_rng(seed), batch,
                                    width)
    assert set(got) == set(want) == {"noisy", "clean", "peaks"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_loader_is_keyed_by_step(cfgs):
    _, cfg = cfgs
    loader = synthetic.SyntheticLoader(cfg, 2, 128, seed=5, start=3)
    try:
        for i in range(3):
            b = next(loader)
            want = synthetic.make_batch(cfg, 2, 128, seed=5 + 3 + i)
            for k in want:
                assert isinstance(b[k], torch.Tensor)
                np.testing.assert_array_equal(b[k].numpy(), want[k])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


# --- loss, AdamW, schedule ------------------------------------------------

@pytest.mark.parametrize("path", ["ref", "function"])
def test_loss_and_grads_match_jax(cfgs, jparams, path, monkeypatch):
    """The loss, its two parts and all 50 parameter gradients of
    ``blocks.loss_fn`` against ``jax.value_and_grad`` of the JAX one."""
    jcfg, cfg = cfgs
    b = _batch_np(11)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jblocks.loss_fn(p, jcfg, b, backend="xla"),
        has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    if path == "function":
        _kernel_path(monkeypatch)
    model = _model(cfg, jparams)
    loss, aux = blocks.loss_fn(model, cfg, _torch_batch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("mse", "bce"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == 50
    for k, g in want.items():
        scale = g.abs().max().item()
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(),
                                   atol=1e-4 * scale, rtol=1e-4, err_msg=k)


def test_loss_fn_of_other_families_raises(cfgs):
    """Every family's loss and batches are ported, the VLM's last (its
    batch: text tokens and labels after ``n_image_tokens`` image
    embeddings, ``seq`` counting both); a family the port does not know
    raises."""
    import dataclasses
    _, cfg = cfgs
    vlm = dataclasses.replace(configs.get("internvl2-2b"), d_model=8,
                              n_image_tokens=3)
    b = synthetic.make_batch(vlm, 2, 8)
    assert b["tokens"].shape == b["labels"].shape == (2, 5)
    assert b["patches"].shape == (2, 3, 8)
    assert b["patches"].dtype == torch.bfloat16
    assert callable(losses.make_loss_fn(vlm))
    unknown = dataclasses.replace(cfg, family="retrieval")
    with pytest.raises(ValueError, match="unknown family"):
        losses.make_loss_fn(unknown)
    with pytest.raises(ValueError, match="unknown family"):
        synthetic.make_batch(unknown, 1, 8)


@pytest.mark.parametrize("grad_scale", [0.01, 100.0], ids=["unclipped",
                                                           "clipped"])
def test_adamw_matches_jax(grad_scale):
    rng = np.random.default_rng(6)
    shapes = {"a.w": (3, 4, 5), "a.b": (4,), "c.w": (2, 7)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    # copies: update_ writes in place, and jnp.asarray may alias numpy
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.array(v) for k, v in params.items()}
    state, jstate = adamw.init(tparams), jadamw.init(jp)
    for step in range(3):
        grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        lr = 1e-2 * (step + 1)
        tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
        gnorm = adamw.global_norm(tgrads)
        adamw.update_(tgrads, state, tparams, lr=lr, grad_norm=gnorm,
                      finite=torch.isfinite(gnorm))
        jp, jstate, jm = jadamw.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp, lr=lr)
        np.testing.assert_allclose(gnorm.item(), float(jm["grad_norm"]),
                                   rtol=1e-6)
        for k in shapes:
            for got, want in ((tparams[k], jp[k]), (state.m[k], jstate.m[k]),
                              (state.v[k], jstate.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
        assert int(state.count) == int(jstate.count) == step + 1


def test_schedules_match_jax():
    for step in range(13):
        kw = dict(peak_lr=3e-4, warmup_steps=3, total_steps=10)
        np.testing.assert_allclose(
            schedule.cosine_with_warmup(step, **kw).item(),
            float(jschedule.cosine_with_warmup(jnp.int32(step), **kw)),
            rtol=1e-6)
        np.testing.assert_allclose(
            schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32),
                                        **kw).item(),
            float(jschedule.cosine_with_warmup(step, **kw)), rtol=1e-6)
    assert schedule.constant(torch.tensor(4), peak_lr=0.5).item() == 0.5


# --- the train step -------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(cfgs, jparams, accum):
    """Five steps of ``make_train_step`` from the same state on the same
    batches as JAX's ``make_train_step``: losses, gradient norms, learning
    rates, parameters, moments and counters."""
    jcfg, cfg = cfgs
    steps = 5
    kw = dict(accum_steps=accum, peak_lr=LR, warmup_steps=2,
              total_steps=steps)
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, jparams))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    for i in range(steps):
        b = _batch_np(100 + i, batch=4)
        jstate, jm = jstep(jstate, b)
        state, m = step(state, _torch_batch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        assert m["skipped"].item() == float(jm["skipped"]) == 0.0
    assert int(state.step) == int(jstate.step) == steps
    assert int(state.opt.count) == int(jstate.opt.count) == steps
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_nonfinite_step_is_skipped(cfgs, jparams):
    _, cfg = cfgs
    state = init_state(_model(cfg, jparams))
    before = {k: p.detach().clone()
              for k, p in state.params.named_parameters()}
    b = _torch_batch(_batch_np(1))
    b["noisy"][0, 5] = float("nan")
    state, m = make_train_step(cfg, peak_lr=LR, warmup_steps=1)(state, b)
    assert m["skipped"].item() == 1.0 and not np.isfinite(m["loss"].item())
    for k, p in state.params.named_parameters():
        assert torch.equal(p, before[k]), k
    assert int(state.opt.count) == 0 and int(state.step) == 1
    assert all(not v.any() for v in state.opt.m.values())


# --- checkpoints ----------------------------------------------------------

def _trained_jax_state(jcfg, jparams, steps=2):
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, jparams))
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, peak_lr=LR,
                                                warmup_steps=1,
                                                total_steps=4))
    for i in range(steps):
        jstate, _ = jstep(jstate, _batch_np(i))
    return jstate


def test_checkpoint_jax_writes_port_restores(cfgs, jparams, tmp_path):
    jcfg, cfg = cfgs
    jstate = _trained_jax_state(jcfg, jparams)
    jckpt.Checkpointer(str(tmp_path)).save(jstate, 2)
    state = ckpt.Checkpointer(str(tmp_path)).restore(
        init_state(blocks.init_params(cfg, seed=9)))
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg)
    got_t, want_t = ckpt.state_tensors(state), ckpt.state_tensors(want)
    assert len(got_t) == 152 and set(got_t) == set(want_t)
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype, k
        assert torch.equal(got_t[k], want_t[k]), k


def test_checkpoint_port_writes_jax_restores(cfgs, jparams, tmp_path):
    jcfg, cfg = cfgs
    state = init_state(_model(cfg, jparams))
    step = make_train_step(cfg, peak_lr=LR, warmup_steps=1, total_steps=4)
    for i in range(2):
        state, _ = step(state, _torch_batch(_batch_np(i)))
    ckpt.Checkpointer(str(tmp_path)).save(state, 2)
    template = jtrain_step.init_state(
        jblocks.init_params(jax.random.key(1), jcfg))
    restored = jckpt.Checkpointer(str(tmp_path)).restore(template)
    flat = jckpt._flatten(restored)
    ours = ckpt.state_tensors(state)
    assert set(flat) == set(ours) and len(flat) == 152
    for k, t in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      t.detach().numpy(), err_msg=k)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 2 and manifest["leaves"][".step"] == {
        "shape": [], "dtype": "int32"}


def test_checkpoint_bf16_is_stored_as_the_jax_package_stores_it(tmp_path):
    """bf16 leaves: a JAX-written checkpoint restores into the port
    bitwise, and the port writes the same arrays, byte for byte (numpy
    keeps bf16 as raw 2-byte values).  The JAX package cannot restore
    bf16 checkpoints, its own included (ROADMAP.md queue C), so that
    direction is not exercised here."""
    jcfg = jreduced(jconfigs.get("atacworks-bf16"), dtype="bfloat16")
    jstate = jtrain_step.init_state(
        jblocks.init_params(jax.random.key(0), jcfg))
    jckpt.Checkpointer(str(tmp_path / "jax")).save(jstate, 1)
    cfg = reduced(configs.get("atacworks-bf16"), dtype="bfloat16")
    state = ckpt.Checkpointer(str(tmp_path / "jax")).restore(
        init_state(blocks.init_params(cfg, seed=5)))
    w = state.params.res[0].conv1.w
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.detach().float().numpy(),
        np.asarray(jstate.params["res"][0]["conv1"]["w"], np.float32))
    ckpt.Checkpointer(str(tmp_path / "port")).save(state, 1)
    with np.load(tmp_path / "jax" / "step_00000001" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_00000001" / "arrays.npz") as b:
        assert set(a.files) == set(b.files) and len(a.files) == 152
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
    back = ckpt.Checkpointer(str(tmp_path / "port")).restore(
        init_state(blocks.init_params(cfg, seed=6)))
    for k, t in ckpt.state_tensors(back).items():
        assert torch.equal(t, ckpt.state_tensors(state)[k]), k


def test_torn_checkpoints_are_never_offered(cfgs, jparams, tmp_path):
    """A directory without its COMMIT marker is invisible and swept; a
    damaged archive past the marker falls back to the next newest; keep
    retains the newest."""
    _, cfg = cfgs
    c = ckpt.Checkpointer(str(tmp_path), keep=2)
    state = init_state(_model(cfg, jparams))
    for s in (1, 2, 3):
        state.step = torch.tensor(s, dtype=torch.int32)
        c.save(state, s)
    assert c.all_steps() == [2, 3]
    torn = tmp_path / "step_00000009"
    shutil.copytree(tmp_path / "step_00000003", torn)
    os.remove(torn / "COMMIT")
    assert c.all_steps() == [2, 3] and c.latest_step() == 3
    (tmp_path / "step_00000003" / "arrays.npz").write_bytes(b"damaged")
    fresh = init_state(blocks.init_params(cfg, seed=4))
    assert int(c.restore(fresh).step) == 2
    with pytest.raises(FileNotFoundError):
        c.restore(fresh, step=3)
    with pytest.raises(FileNotFoundError, match="torn"):
        c.restore(fresh, step=9)
    state.step = torch.tensor(4, dtype=torch.int32)
    c.save(state, 4)
    assert not torn.exists()
    assert not list(tmp_path.glob("*.tmp"))


# --- the launcher ---------------------------------------------------------

SMOKE = ["--arch", "atacworks", "--smoke", "--device", "cpu", "--batch", "2",
         "--seq", "256"]


def test_launcher_trains_on_cpu_and_resumes(tmp_path, capsys):
    """``--device cpu --smoke`` trains; a run resumed from its step-2
    checkpoint replays steps 2..5 exactly as the uninterrupted run did
    (step-keyed batches, the whole state restored)."""
    full = train.run(SMOKE + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "2"])
    assert len(full["losses"]) == 6 and np.isfinite(full["losses"]).all()
    assert full["samples_per_s"] > 0
    out = capsys.readouterr().out
    assert "step     5 loss" in out and "samples/s" in out
    for s in (4, 6):
        shutil.rmtree(tmp_path / f"step_{s:08d}")
    again = train.run(SMOKE + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                               "--resume"])
    assert again["first_step"] == 2
    np.testing.assert_array_equal(again["losses"], full["losses"][2:])


def test_launcher_accumulates(capsys):
    out = train.run(SMOKE + ["--steps", "2", "--accum", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    with pytest.raises(SystemExit, match="accum"):
        train.run(SMOKE + ["--steps", "1", "--accum", "3"])


def test_launcher_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "atacworks", "--smoke", "--steps", "1"])
