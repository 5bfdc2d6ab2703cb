"""The port's Mamba2 training path (``repro_torch``: config, model, loss,
synthetic tokens, train step, AdamW, checkpoints, launcher) against the
JAX package, on the CPU.

The reduced Mamba2 config (2 layers, d_model 64, vocab 256, d_state 16,
head_dim 8, chunk 16, fp32) with the JAX package's initial weights, every
norm scale, ``D``, ``gate_norm`` and conv bias made random (their init
values, ones and zeros, would leave those paths untested), runs through
both packages on the same token batches (``lm_batch``, bitwise equal
across the packages from one seed).  Sequences of 40 tokens are not a
multiple of the chunk, so the inert padding of the SSD scan is exercised.
The JAX side runs its Pallas depthwise conv in interpret mode (its CPU
default); the port runs its plain version and, where named, the
``ops.DepthwiseConv1dFunction`` on CPU tensors, whose wrappers then
compute each pass's plain version.

Tolerances: logits within 1e-5 of their largest value and the loss within
rtol 1e-5 (fp32, sums in another order); each gradient within 1e-4 of its
leaf's largest value (two layers of fp32 sums, the SSD's chunked products
in another order).  Over four AdamW steps (lr 1e-3) the losses within
rtol 1e-5, the gradient norms within rtol 5e-4 (``GNORM_RTOL``: JAX's
jitted metric, not the gradients, is that far off) and the parameters
within 1e-5 absolute.  AdamW's first steps
are sign-like: ``m / sqrt(v)`` is about +-1 whatever a gradient element's
size, so an element whose gradient is within the two frameworks' rounding
of zero may step by up to ``2 * lr`` the other way.  At most
``FLIP_FRAC`` (1e-4) of the elements may do so; measured: none.
"""
from __future__ import annotations

import dataclasses
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
from repro.data import synthetic as jsynthetic
from repro.models import mamba2 as jmamba2
from repro.train import losses as jlosses
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert, models
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import reduced
from repro_torch.data import synthetic
from repro_torch.kernels import conv1d_brgemm, ops
from repro_torch.launch import train
from repro_torch.models import common, mamba2
from repro_torch.train import losses
from repro_torch.train.train_step import init_state, make_train_step

BATCH, SEQ = 2, 40
LR = 1e-3
FLIP_FRAC = 1e-4
# JAX's jitted step reports a gradient norm 6.7e-5 to 1.2e-4 (relative)
# from the float64 norm of its own gradients on the CPU (the eager
# ``adamw.update`` on the same gradients: 4e-7); the port's is within 1e-6
GNORM_RTOL = 5e-4


@pytest.fixture(scope="module")
def cfgs():
    return (jreduced(jconfigs.get("mamba2-370m")),
            reduced(configs.get("mamba2-370m")))


def _jax_params(jcfg, seed=0):
    """The JAX package's initial parameters with the constant leaves made
    random, as numpy."""
    tree = jax.tree.map(np.asarray,
                        jmamba2.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 3)

    def jitter(a, base):
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    mixer = dict(tree["layers"]["mixer"])
    mixer.update(conv_b=jitter(mixer["conv_b"], 0.0),
                 D=jitter(mixer["D"], 1.0),
                 gate_norm=jitter(mixer["gate_norm"], 1.0))
    return {"embed": tree["embed"],
            "layers": {"norm": {"scale": jitter(
                tree["layers"]["norm"]["scale"], 1.0)}, "mixer": mixer},
            "final_norm": {"scale": jitter(tree["final_norm"]["scale"], 1.0)},
            "unembed": tree["unembed"]}


@pytest.fixture(scope="module")
def jparams(cfgs):
    return _jax_params(cfgs[0])


def _batch_np(seed, cfg, batch=BATCH, seq=SEQ):
    return synthetic.make_batch(cfg, batch, seq, seed=seed)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _model(cfg, jparams):
    model = mamba2.init_params(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    return model


def _function_path(monkeypatch):
    """Route the conv through ``ops.DepthwiseConv1dFunction`` on CPU
    tensors (the path a CUDA tensor takes, with plain passes)."""
    def depthwise_conv1d(x, w, *, padding="CAUSAL", dilation=1,
                         backend=None, **kw):
        assert backend is None
        lo, hi = ops._pad_amounts(w.shape[0], dilation, padding)
        return ops.fused_depthwise_conv1d(F.pad(x, (lo, hi)).contiguous(),
                                          w.contiguous(), dilation=dilation,
                                          **kw)
    monkeypatch.setattr(ops, "depthwise_conv1d", depthwise_conv1d)


def _close_to_largest(got, want, rel, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale, err_msg=what)


# --- config, data ----------------------------------------------------------

def test_config_is_the_jax_packages():
    jcfg, cfg = jconfigs.get("mamba2-370m"), configs.get("mamba2-370m")
    for f in ("n_layers", "d_model", "vocab_size", "norm", "norm_eps",
              "tie_embeddings", "pos_embedding", "dtype", "remat",
              "remat_policy", "xent_chunk", "padded_vocab", "family"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    assert cfg.padded_vocab == 50432 and mamba2.dims(cfg) == (2048, 32, 2304)
    jr, r = jreduced(jcfg), reduced(cfg)
    for f in ("n_layers", "d_model", "vocab_size", "dtype", "remat"):
        assert getattr(r, f) == getattr(jr, f), f
    assert dataclasses.asdict(r.ssm) == dataclasses.asdict(jr.ssm)


@pytest.mark.parametrize("seed,batch,seq", [(0, 2, 40), (7, 8, 2048)])
def test_lm_batch_is_bitwise_the_jax_packages(cfgs, seed, batch, seq):
    _, cfg = cfgs
    full = configs.get("mamba2-370m")
    for c, jc in ((cfg, cfgs[0]), (full, jconfigs.get("mamba2-370m"))):
        got = synthetic.make_batch(c, batch, seq, seed=seed)
        want = jsynthetic.make_batch(jc, batch, seq, seed=seed)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_loader_moves_token_batches(cfgs):
    _, cfg = cfgs
    loader = synthetic.SyntheticLoader(cfg, 2, 16, seed=3, start=2)
    try:
        b = next(loader)
        want = synthetic.make_batch(cfg, 2, 16, seed=5)
        for k in want:
            assert b[k].dtype == torch.int32
            np.testing.assert_array_equal(b[k].numpy(), want[k])
    finally:
        loader.close()


# --- the model ---------------------------------------------------------------

def test_state_dict_is_the_jax_tree(cfgs, jparams):
    """Keys, shapes and dtypes of the port's parameters are the JAX tree's,
    stacked per-layer leaves included; so AdamW's ``ndim >= 2`` rule
    decays the same leaves in both packages."""
    _, cfg = cfgs
    model = mamba2.init_params(cfg, seed=1)
    want = convert.params_from_jax(jparams)
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == 12
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    decayed = sorted(k for k, p in got.items() if p.ndim >= 2)
    assert "layers.mixer.A_log" in decayed and "layers.mixer.conv_b" in decayed
    assert "final_norm.scale" not in decayed and len(decayed) == 11


def test_init_is_seeded_and_follows_the_jax_distributions(cfgs):
    _, cfg = cfgs
    a, b = mamba2.init_params(cfg, seed=5), mamba2.init_params(cfg, seed=5)
    c = mamba2.init_params(cfg, seed=6)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    mixer = a.layers.mixer
    assert not torch.equal(mixer.in_proj, c.layers.mixer.in_proj)
    assert not mixer.conv_b.any() and torch.equal(mixer.D,
                                                  torch.ones_like(mixer.D))
    dt = F.softplus(mixer.dt_bias)
    assert (dt >= cfg.ssm.dt_min * 0.999).all()
    assert (dt <= cfg.ssm.dt_max * 1.001).all()
    np.testing.assert_allclose(torch.exp(mixer.A_log[1]).detach().numpy(),
                               np.arange(1, mixer.A_log.shape[1] + 1),
                               rtol=1e-6)


@pytest.mark.parametrize("vocab", [256, 250], ids=["vocab256", "padded250"])
def test_logits_and_loss_match_jax(cfgs, vocab):
    """fp32 logits, the loss and the final hidden state against JAX's
    ``forward``/``lm_loss``; with a vocabulary of 250 the 6 padded columns
    are masked to NEG_INF."""
    jcfg, cfg = (dataclasses.replace(c, vocab_size=vocab) for c in cfgs)
    jp = _jax_params(jcfg)
    b = _batch_np(11, cfg)
    jlogits, _ = jmamba2.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                                 jnp.asarray(b["tokens"]))
    jloss, _ = jlosses.make_loss_fn(jcfg)(jax.tree.map(jnp.asarray, jp),
                                          jax.tree.map(jnp.asarray, b))
    model = _model(cfg, jp)
    logits = model(torch.from_numpy(b["tokens"]))
    assert logits.shape == (BATCH, SEQ, 256) and logits.dtype == torch.float32
    if vocab < 256:
        assert (logits[..., vocab:] == common.NEG_INF).all()
    _close_to_largest(logits.detach().numpy(), np.asarray(jlogits), 1e-5,
                      "logits")
    loss, aux = losses.make_loss_fn(cfg)(model, _torch_batch(b))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert aux["nll"] is loss
    jhidden, _ = jmamba2.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                                 jnp.asarray(b["tokens"]), hidden_only=True)
    hidden = model(torch.from_numpy(b["tokens"]), hidden_only=True)
    assert hidden.shape == (BATCH, SEQ, cfg.d_model)
    _close_to_largest(hidden.detach().numpy(), np.asarray(jhidden), 1e-5,
                      "hidden")


@pytest.mark.parametrize("path", ["ref", "function"])
def test_grads_match_jax(cfgs, jparams, path, monkeypatch):
    """All 12 gradients of the loss against ``jax.value_and_grad`` of the
    JAX one; ``function`` runs the conv through the port's Function."""
    jcfg, cfg = cfgs
    b = _batch_np(12, cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, b))
    if path == "function":
        _function_path(monkeypatch)
    model = _model(cfg, jparams)
    before = conv1d_brgemm.depthwise_conv1d_fwd.launches
    loss, _ = losses.make_loss_fn(cfg)(model, _torch_batch(b))
    loss.backward()
    assert conv1d_brgemm.depthwise_conv1d_fwd.launches == before  # CPU
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == 12
    for k, g in want.items():
        _close_to_largest(got[k].grad.numpy(), g.numpy(), 1e-4, k)


def test_remat_matches_no_remat(cfgs, jparams, monkeypatch):
    """Recomputing each layer in the backward (``remat``) gives the same
    loss and gradients as keeping the activations, through the Function;
    the forward of each layer's conv runs once more per layer."""
    _, cfg = cfgs
    _function_path(monkeypatch)
    calls = {"fwd": 0}
    real = conv1d_brgemm.depthwise_conv1d_fwd

    def counted(*a, **k):
        calls["fwd"] += 1
        return real(*a, **k)

    monkeypatch.setattr(conv1d_brgemm, "depthwise_conv1d_fwd", counted)
    b = _torch_batch(_batch_np(13, cfg))
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = _model(c, jparams)
        calls["fwd"] = 0
        loss, _ = losses.make_loss_fn(c)(model, b)
        loss.backward()
        out[remat] = (loss.item(), calls["fwd"],
                      {k: p.grad for k, p in model.named_parameters()})
    L = cfg.n_layers
    assert out[False][1] == 2 * L and out[True][1] == 3 * L
    assert out[True][0] == out[False][0]
    for k, g in out[False][2].items():
        assert torch.equal(out[True][2][k], g), k


def test_ssd_padding_is_inert(cfgs):
    """A sequence that is not a multiple of the chunk gives the prefix of
    the same sequence padded to one by hand with inert ``dt = 0``."""
    rng = np.random.default_rng(4)
    b, T, H, P, G, N = 2, 21, 4, 3, 1, 5
    x, dt = rng.standard_normal((b, T, H, P)), rng.random((b, T, H))
    Bm, Cm = rng.standard_normal((b, T, G, N)), rng.standard_normal(
        (b, T, G, N))
    A = -np.arange(1, H + 1, dtype=np.float64)
    t = [torch.from_numpy(a).float() for a in (x, dt, A, Bm, Cm)]
    got = mamba2.ssd_chunked(t[0], t[1], t[2], t[3], t[4], 8)
    want = jmamba2.ssd_chunked(*(jnp.asarray(a, jnp.float32)
                                 for a in (x, dt)), jnp.asarray(
        A, jnp.float32), *(jnp.asarray(a, jnp.float32) for a in (Bm, Cm)),
        8)
    assert got.shape == (b, T, H, P)
    _close_to_largest(got.numpy(), np.asarray(want), 1e-5, "ssd")


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """A chunk whose cumulative decay passes 88 (Mamba2-370M's chunk of 128
    reaches it): the JAX form's masked ``exp`` overflows above the
    diagonal; the port masks before the ``exp``, so its gradient stays
    finite, and its output equals the JAX package's."""
    rng = np.random.default_rng(6)
    b, T, H, P, N = 1, 16, 2, 2, 3
    x = torch.from_numpy(rng.standard_normal((b, T, H, P))).float()
    dt = torch.full((b, T, H), 1.0, requires_grad=True)
    A = torch.tensor([-1.0, -32.0])
    Bm = torch.from_numpy(rng.standard_normal((b, T, 1, N))).float()
    Cm = torch.from_numpy(rng.standard_normal((b, T, 1, N))).float()
    y = mamba2.ssd_chunked(x, dt, A, Bm, Cm, 16)
    y.sum().backward()
    assert torch.isfinite(dt.grad).all()
    want = jmamba2.ssd_chunked(*(jnp.asarray(t.detach().numpy())
                                 for t in (x, dt, A, Bm, Cm)), 16)
    _close_to_largest(y.detach().numpy(), np.asarray(want), 1e-5, "y")


# --- the train step, checkpoints -------------------------------------------

def test_train_steps_match_jax(cfgs, jparams, monkeypatch):
    """Four steps of ``make_train_step`` (through the Function) from the
    same state on the same batches as JAX's jitted ``make_train_step``,
    which holds AdamW's decay rule on the stacked leaves: losses, gradient
    norms, learning rates, parameters, counters."""
    jcfg, cfg = cfgs
    _function_path(monkeypatch)
    steps = 4
    kw = dict(peak_lr=LR, warmup_steps=2, total_steps=steps)
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, jparams))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    for i in range(steps):
        b = _batch_np(100 + i, cfg)
        jstate, jm = jstep(jstate, b)
        state, m = step(state, _torch_batch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=GNORM_RTOL)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        assert m["skipped"].item() == float(jm["skipped"]) == 0.0
    assert int(state.step) == int(jstate.step) == steps
    assert int(state.opt.count) == int(jstate.opt.count) == steps
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    beyond = total = 0
    for k, p in state.params.named_parameters():
        diff = (p.detach() - want[k]).abs()
        assert diff.max().item() <= 2 * steps * LR, k
        beyond += int((diff > 1e-5).sum())
        total += diff.numel()
    assert beyond <= FLIP_FRAC * total, (beyond, total)


def _trained_jax_state(jcfg, jparams, cfg, steps=2):
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, jparams))
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, peak_lr=LR,
                                                warmup_steps=1,
                                                total_steps=4))
    for i in range(steps):
        jstate, _ = jstep(jstate, _batch_np(i, cfg))
    return jstate


def test_checkpoint_jax_writes_port_restores(cfgs, jparams, tmp_path):
    jcfg, cfg = cfgs
    jstate = _trained_jax_state(jcfg, jparams, cfg)
    jckpt.Checkpointer(str(tmp_path)).save(jstate, 2)
    state = ckpt.Checkpointer(str(tmp_path)).restore(
        init_state(mamba2.init_params(cfg, seed=9)))
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg)
    got_t, want_t = ckpt.state_tensors(state), ckpt.state_tensors(want)
    assert len(got_t) == 3 * 12 + 2 and set(got_t) == set(want_t)
    assert ".params/layers/mixer/in_proj" in got_t
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype, k
        assert torch.equal(got_t[k], want_t[k]), k


def test_checkpoint_port_writes_jax_restores(cfgs, jparams, tmp_path):
    jcfg, cfg = cfgs
    state = init_state(_model(cfg, jparams))
    step = make_train_step(cfg, peak_lr=LR, warmup_steps=1, total_steps=4)
    for i in range(2):
        state, _ = step(state, _torch_batch(_batch_np(i, cfg)))
    ckpt.Checkpointer(str(tmp_path)).save(state, 2)
    template = jtrain_step.init_state(
        jmamba2.init_params(jax.random.key(1), jcfg))
    restored = jckpt.Checkpointer(str(tmp_path)).restore(template)
    flat = jckpt._flatten(restored)
    ours = ckpt.state_tensors(state)
    assert set(flat) == set(ours) and len(flat) == 3 * 12 + 2
    for k, t in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      t.detach().numpy(), err_msg=k)


# --- registry, loss and launcher ---------------------------------------------

def test_other_lm_families_raise(cfgs, jparams):
    """The families and options still missing raise (the VLM, the "dots"
    remat policy); the streamed cross-entropy, which raised here until
    it was ported, gives Mamba2's full-logits loss."""
    _, cfg = cfgs
    vlm = dataclasses.replace(cfg, family="vlm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.get_model(vlm)
    model = _model(cfg, jparams)
    batch = _torch_batch(_batch_np(5, cfg, seq=32))
    full, _ = losses.make_loss_fn(cfg)(model, batch)
    streamed, _ = losses.make_loss_fn(dataclasses.replace(
        cfg, xent_chunk=8))(model, batch)
    np.testing.assert_allclose(streamed.item(), full.item(), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        common.maybe_remat(lambda x: x, dataclasses.replace(
            cfg, remat=True, remat_policy="dots"))
    assert models.get_model(cfg) is mamba2


SMOKE = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--batch",
         "2", "--seq", "24"]


def test_launcher_trains_on_cpu_and_resumes(tmp_path, capsys):
    full = train.run(SMOKE + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "2"])
    assert len(full["losses"]) == 4 and np.isfinite(full["losses"]).all()
    assert full["tokens_per_s"] > 0 and "peak_memory_gb" not in full
    out = capsys.readouterr().out
    assert "step     3 loss" in out and "tokens/s" in out
    shutil.rmtree(tmp_path / "step_00000004")
    again = train.run(SMOKE + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                               "--resume"])
    assert again["first_step"] == 2
    np.testing.assert_array_equal(again["losses"], full["losses"][2:])


def test_launcher_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "mamba2-370m", "--smoke", "--steps", "1"])
