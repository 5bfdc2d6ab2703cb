"""The port's hybrid family (``repro_torch``: Zamba2's config, the model
with its weight-shared attention block, the loss, the train step, the
hybrid decode cache, decode, the fused prefill, both launchers,
checkpoints and the roofline's counts) against the JAX package, on the
CPU.

The reduced Zamba2-7B config (4 Mamba2 layers of d_model 64 with the
shared block applied after layers 1 and 3, its 4 heads over 2 KV heads
of 16, d_ff 128, vocab 256, SSM d_state 16, head_dim 8, chunk 16, fp32)
runs with the JAX package's initial weights, every norm scale, conv
bias, D and gate norm made random (their init values, ones and zeros,
would leave those paths untested), through both packages on the same
token batches, for both ``attn_impl`` values.  The JAX side runs its
Pallas flash and depthwise kernels in interpret mode; the port's flash
wrappers and, where named, its ``DepthwiseConv1dFunction`` compute their
plain versions on CPU tensors.

Tolerances, as in ``tests/test_torch_whisper.py``: logits within 1e-5
of their largest value and the loss within rtol 1e-5 (fp32, sums in
another order); each gradient within ``GRAD_TOL`` (1e-5) of its leaf's
largest value, the shared block's (summed over its two applications) and
the embedding table's (reached through the residual and both
applications) among them; the gradient norms within ``GNORM_RTOL``
(5e-4, JAX's jitted metric).  Over three AdamW steps (lr 1e-3) the
parameters within 1e-5 absolute, except that AdamW's first steps are
sign-like, so at most ``FLIP_FRAC`` (1e-4) of the elements may step by
up to ``2 * lr`` the other way.
"""
from __future__ import annotations

import dataclasses
import functools
import math

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
from repro.models import zamba2 as jzamba2
from repro.roofline import flops as jflops
from repro.train import losses as jlosses
from repro.train import serve_step as jserve_step
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert, models
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import reduced
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import common, mamba2, zamba2
from repro_torch.roofline import flops
from repro_torch.train import losses, serve_step
from repro_torch.train.data_parallel import param_grads
from repro_torch.train.train_step import init_state, make_train_step

ARCH = "zamba2-7b"
IMPLS = ("chunked", "flash")
BATCH, SEQ = 2, 64
TOL, GRAD_TOL, GNORM_RTOL = 1e-5, 1e-5, 5e-4
LR, FLIP_FRAC = 1e-3, 1e-4
DECODE_STEPS = 12
N_LEAVES = 21


def _cfgs(impl="chunked", **kw):
    return (dataclasses.replace(jreduced(jconfigs.get(ARCH)), attn_impl=impl,
                                **kw),
            dataclasses.replace(reduced(configs.get(ARCH)), attn_impl=impl,
                                **kw))


@functools.cache
def _params(jcfg, seed=0):
    """The JAX package's initial parameters with every norm scale, conv
    bias, D and gate norm made random, as numpy."""
    tree = jax.tree.map(np.asarray,
                        jzamba2.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 3)
    base = {"scale": 1.0, "conv_b": 0.0, "D": 1.0, "gate_norm": 1.0}

    def jitter(path, a):
        name = path[-1].key
        if name not in base:
            return a
        return (base[name] + 0.1 * rng.standard_normal(a.shape)).astype(
            a.dtype)

    return jax.tree_util.tree_map_with_path(jitter, tree)


def _jp(jcfg):
    return jax.tree.map(jnp.asarray, _params(jcfg))


def _model(cfg, jparams):
    model = models.init_model(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    return model


def _batch(cfg, seed=11, batch=BATCH, seq=SEQ):
    """The port's batch (tensors) and the same batch for JAX (arrays)."""
    b = synthetic.make_batch(cfg, batch, seq, seed=seed)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t, np.float32))


def _close_to_largest(got, want, rel, what):
    got, want = _np(got), _np(want)
    finite = want > -1e29  # the padded vocabulary's NEG_INF columns
    scale = max(float(np.abs(np.where(finite, want, 0)).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


# --- config, data, parameters ----------------------------------------------

FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab_size", "qk_norm", "qkv_bias",
          "attn_out_bias", "rope_theta", "norm", "norm_eps", "mlp_act",
          "mlp_bias", "tie_embeddings", "pos_embedding", "max_position",
          "attn_every", "dtype", "remat", "remat_policy",
          "attn_chunk", "xent_chunk", "attn_impl", "padded_vocab", "source")


@pytest.mark.parametrize("which", ["published", "reduced"])
def test_config_is_the_jax_packages(which):
    jcfg, cfg = jconfigs.get(ARCH), configs.get(ARCH)
    if which == "reduced":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
        assert cfg.name == jcfg.name == ARCH + "-smoke"
        assert (cfg.n_layers, cfg.attn_every, cfg.n_heads,
                cfg.n_kv_heads) == (4, 2, 4, 2)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), (which, f)
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    assert zamba2.n_shared_applications(cfg) == \
        jzamba2.n_shared_applications(jcfg)


def test_published_widths_and_counts():
    """The repo's Zamba2-7B: 81 layers of d_model 3,584, a conv over
    7,296 channels, 13 applications of the shared block (32 heads over 32
    KV heads of 112); 6,788,166,144 parameters by JAX's count, which
    leaves out the norms, D, dt_bias, A_log and the conv bias (the
    model's leaves hold 1,503,440 more); the 12-layer cut that trains on one
    card 1,408,948,224 with two applications.  ``roofline.flops``' hybrid
    counts equal JAX's at the full config, and a decode step's bound
    reads 13.35 GB of weights (the embedding table's batch rows only),
    2.38 GB of SSM state and about 0.35 GB of K/V."""
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.dtype) == (
        81, 3584, 112, "bfloat16")
    assert mamba2.dims(cfg) == (7168, 112, 7296)
    assert zamba2.n_shared_applications(cfg) == 13
    assert flops.param_count(cfg) == jflops.param_count(jcfg) == 6788166144
    cut = dataclasses.replace(cfg, n_layers=12)
    assert flops.param_count(cut) == 1408948224
    assert zamba2.n_shared_applications(cut) == 2
    s, (d_inner, H, conv_dim) = cfg.ssm, mamba2.dims(cfg)
    d_proj = 2 * d_inner + 2 * s.d_state + H
    layer = (cfg.d_model * d_proj + s.conv_width * conv_dim
             + d_inner * cfg.d_model + cfg.d_model + conv_dim + 3 * H
             + d_inner)
    shared = sum(math.prod(shape) for shape, _, _ in
                 zamba2.shared_leaves(cfg).values())
    leaves = (2 * cfg.padded_vocab * cfg.d_model + cfg.n_layers * layer
              + shared + cfg.d_model)
    assert leaves - flops.param_count(cfg) == 1503440
    for kind, T, B in (("train", 4096, 4), ("prefill", 200, 8),
                       ("decode", 232, 8)):
        shape = flops.StepShape(kind, T, B)
        assert flops.model_flops(cfg, shape) == jflops.model_flops(
            jcfg, shape), kind
    assert flops.model_flops(cut, flops.StepShape("train", 4096, 4)) == \
        pytest.approx(1.41e14, rel=5e-3)
    shape = flops.StepShape("decode", 233, 8)
    cache = flops.decode_cache_bytes(cfg, 8, 233)
    weights = flops.hbm_bytes_decode(cfg, shape) - cache
    assert weights == pytest.approx(13.35e9, rel=2e-3)
    state = 2 * 8 * 4 * H * s.head_dim * s.d_state * cfg.n_layers
    assert state == pytest.approx(2.38e9, rel=2e-3)
    kv = cache - state - 2 * 8 * 4 * 3 * conv_dim * cfg.n_layers
    assert kv == 2 * 8 * 233 * 32 * 2 * 112 * 13


def test_decode_cache_bytes_are_the_caches():
    """A hybrid decode step's cache bytes: the Mamba2 leaves (fp32
    whatever the cache's dtype) read and written, each application's
    K/V of ``seq_len`` positions read once."""
    _, cfg = _cfgs()
    for dtype in (torch.bfloat16, torch.float32):
        cache = serve_step.make_cache(cfg, 3, 7, dtype=dtype)
        mamba = sum(t.numel() * t.element_size()
                    for t in cache["mamba"].values())
        kv = sum(cache[k].numel() * cache[k].element_size()
                 for k in ("k", "v"))
        assert flops.decode_cache_bytes(cfg, 3, 7, dtype.itemsize) == \
            2 * mamba + kv


@pytest.mark.parametrize("seed", [0, 7])
def test_lm_batch_is_bitwise_the_jax_packages(seed):
    jcfg, cfg = _cfgs()
    got = synthetic.make_batch(cfg, 3, 20, seed=seed)
    want = jsynthetic.make_batch(jcfg, 3, 20, seed=seed)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_state_dict_is_the_jax_tree():
    """Keys, shapes and dtypes are the JAX tree's: Mamba2's stacked
    ``layers.`` leaves and the shared block's under ``shared.`` (Q, K, V
    from the 2·D concat); AdamW's ``ndim >= 2`` rule decays the same
    leaves in both packages."""
    jcfg, cfg = _cfgs()
    model = zamba2.init_params(cfg, seed=1)
    want = convert.params_from_jax(_params(jcfg))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == N_LEAVES
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert got["shared.in_norm.scale"].shape == (128,)
    assert got["shared.wq"].shape == (128, 64)
    assert got["shared.wk"].shape == (128, 32)  # 2 KV heads of 16
    assert got["shared.mlp.w_down"].shape == (128, 64)
    assert got["layers.mixer.in_proj"].shape[0] == 4
    decayed = {k for k, p in got.items() if p.ndim >= 2}
    assert "layers.mixer.conv_b" in decayed and "shared.wo" in decayed
    assert "shared.in_norm.scale" not in decayed


def _old_mamba2_draw(cfg, seed):
    """``mamba2.init_params``' draw before it went leaf by leaf: every
    leaf whole on the host, in one order."""
    s = cfg.ssm
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    d_inner, H, conv_dim = mamba2.dims(cfg)
    d_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)

    dt = torch.exp(torch.rand((L, H), generator=gen)
                   * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    return {"embed.tok": normal(V, D, scale=0.02),
            "layers.mixer.in_proj": normal(L, D, d_proj, scale=D ** -0.5),
            "layers.mixer.conv_w": normal(L, s.conv_width, conv_dim,
                                          scale=s.conv_width ** -0.5),
            "layers.mixer.dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "layers.mixer.out_proj": normal(L, d_inner, D,
                                            scale=d_inner ** -0.5),
            "unembed": normal(D, V, scale=D ** -0.5)}


@pytest.mark.parametrize("width", ["reduced", "d_model 1024"])
def test_mamba2_weights_are_bitwise_what_they_were(width):
    """``mamba2.init_params`` now draws a stacked leaf a layer's slab at a
    time (``normal_leaf``, shared with Zamba2): for a given seed every
    Mamba2 weight is bitwise the whole-leaf draw it replaced, at the
    reduced widths and at Mamba2-370M's d_model (two layers, a small
    vocabulary: the slabs are the full width's), bf16 and fp32; and
    Zamba2's Mamba2 leaves are Mamba2's draw for its config."""
    cfg = reduced(configs.get("mamba2-370m"))
    if width != "reduced":
        cfg = dataclasses.replace(cfg, d_model=1024,
                                  ssm=configs.get("mamba2-370m").ssm)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        got = dict(mamba2.init_params(c, seed=3).named_parameters())
        for k, t in _old_mamba2_draw(c, 3).items():
            assert torch.equal(got[k], t), (width, dtype, k)
    _, zcfg = _cfgs()
    z = dict(zamba2.init_params(zcfg, seed=4).named_parameters())
    gen = torch.Generator().manual_seed(4)
    for k, t in mamba2.draw_leaves(zcfg, gen, "cpu").items():
        assert torch.equal(z[k], t), k


def test_init_is_seeded_and_follows_the_jax_distributions():
    _, cfg = _cfgs()
    a, b = zamba2.init_params(cfg, seed=5), zamba2.init_params(cfg, seed=5)
    c = zamba2.init_params(cfg, seed=6)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.shared.wq, c.shared.wq)
    sh = a.shared
    assert torch.equal(sh.in_norm.scale, torch.ones(128))
    assert torch.equal(sh.mlp_norm.scale, torch.ones(64))
    for w, fan_in in ((sh.wq, 128), (sh.wk, 128), (sh.wo, 64),
                      (sh.mlp.w_gate, 64), (sh.mlp.w_down, 128)):
        assert float(w.detach().std()) == pytest.approx(fan_in ** -0.5,
                                                    rel=0.15)


# --- forward and gradients ---------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_logits_and_loss_match_jax(impl):
    """The fp32 logits, the loss, the final hidden state and the
    last-position logits against JAX's ``forward`` and ``lm_loss``."""
    jcfg, cfg = _cfgs(impl)
    jp = _jp(jcfg)
    tb, jb = _batch(cfg)
    model = _model(cfg, _params(jcfg))
    jlogits, aux = jzamba2.forward(jp, jcfg, jb["tokens"])
    assert aux == 0.0
    logits = model(tb["tokens"])
    assert logits.shape == (BATCH, SEQ, 256) and logits.dtype == torch.float32
    _close_to_largest(logits, jlogits, TOL, "logits")
    jloss, _ = jlosses.make_loss_fn(jcfg)(jp, jb)
    loss, aux = losses.make_loss_fn(cfg)(model, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert aux["nll"] is loss
    jhidden, _ = jzamba2.forward(jp, jcfg, jb["tokens"], hidden_only=True)
    _close_to_largest(model(tb["tokens"], hidden_only=True), jhidden, TOL,
                      "hidden")
    jlast, _ = jzamba2.forward(jp, jcfg, jb["tokens"], last_only=True)
    last = model(tb["tokens"], last_only=True)
    assert last.shape == (BATCH, 1, 256)
    _close_to_largest(last, jlast, TOL, "last")


@pytest.mark.parametrize("impl", IMPLS)
def test_grads_match_jax(impl, monkeypatch):
    """Every gradient leaf of the loss against ``jax.value_and_grad`` of
    the JAX one, the shared block's (a sum over its two applications) and
    ``embed.tok``'s (through the residual and both applications) among
    them, and the global norm.  The flash path also runs the conv through
    ``DepthwiseConv1dFunction``: the Functions a CUDA tensor takes."""
    jcfg, cfg = _cfgs(impl)
    if impl == "flash":
        _function_path(monkeypatch)
    tb, jb = _batch(cfg, seed=12)
    (jloss, _), jgrads = jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True)(_jp(jcfg), jb)
    model = _model(cfg, _params(jcfg))
    loss, _ = losses.make_loss_fn(cfg)(model, tb)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, param_grads(loss, params)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want) and len(want) == N_LEAVES
    for k, g in want.items():
        _close_to_largest(grads[k], g, GRAD_TOL, k)
    assert grads["shared.wq"].abs().max() > 0
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    jnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in want.values()))
    np.testing.assert_allclose(norm, jnorm, rtol=GNORM_RTOL)


def test_remat_matches_no_remat(monkeypatch):
    """Recomputing each layer, shared block included, in the backward
    gives the same loss and gradients, bitwise; the flash forward runs
    once more an application and the conv's Function once more a layer:
    2 x 2 forward and 2 backward flash calls with remat on."""
    jcfg, cfg = _cfgs("flash")
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, real):
        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(fa, "flash_fwd", counted("fwd", fa.flash_fwd))
    monkeypatch.setattr(fa, "flash_bwd", counted("bwd", fa.flash_bwd))
    _function_path(monkeypatch)
    tb, _ = _batch(cfg, seed=13)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = _model(c, _params(jcfg))
        calls.update(fwd=0, bwd=0)
        loss, _ = losses.make_loss_fn(c)(model, tb)
        loss.backward()
        out[remat] = (loss.item(), dict(calls),
                      {k: p.grad for k, p in model.named_parameters()})
    n = zamba2.n_shared_applications(cfg)
    assert out[False][1] == {"fwd": n, "bwd": n}
    assert out[True][1] == {"fwd": 2 * n, "bwd": n}
    assert out[True][0] == out[False][0]
    for k, g in out[False][2].items():
        assert torch.equal(out[True][2][k], g), k


# --- the train step and checkpoints ------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_train_steps_match_jax(impl, monkeypatch):
    """Three steps of ``make_train_step`` from ``train_state_from_jax`` on
    the same batches as JAX's jitted ``make_train_step``: losses, gradient
    norms, learning rates, parameters, counters."""
    jcfg, cfg = _cfgs(impl)
    _function_path(monkeypatch)
    steps = 3
    kw = dict(peak_lr=LR, warmup_steps=1, total_steps=steps)
    jstate = jtrain_step.init_state(_jp(jcfg))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    for i in range(steps):
        tb, jb = _batch(cfg, seed=100 + i, seq=32)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
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


def test_checkpoint_jax_writes_port_restores(tmp_path):
    jcfg, cfg = _cfgs()
    jstate = jtrain_step.init_state(_jp(jcfg))
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, peak_lr=LR,
                                                warmup_steps=1,
                                                total_steps=4))
    jstate, _ = jstep(jstate, _batch(cfg, seed=1, seq=16)[1])
    jckpt.Checkpointer(str(tmp_path)).save(jstate, 1)
    state = ckpt.Checkpointer(str(tmp_path)).restore(
        init_state(zamba2.init_params(cfg, seed=9)))
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg)
    got_t, want_t = ckpt.state_tensors(state), ckpt.state_tensors(want)
    assert len(got_t) == 3 * N_LEAVES + 2 and set(got_t) == set(want_t)
    assert ".params/shared/mlp/w_gate" in got_t
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype, k
        assert torch.equal(got_t[k], want_t[k]), k


def test_checkpoint_port_writes_jax_restores(tmp_path):
    jcfg, cfg = _cfgs()
    state = init_state(_model(cfg, _params(jcfg)))
    step = make_train_step(cfg, peak_lr=LR, warmup_steps=1, total_steps=4)
    state, _ = step(state, _batch(cfg, seed=2, seq=16)[0])
    ckpt.Checkpointer(str(tmp_path)).save(state, 1)
    template = jtrain_step.init_state(
        jzamba2.init_params(jax.random.key(1), jcfg))
    flat = jckpt._flatten(jckpt.Checkpointer(str(tmp_path)).restore(template))
    ours = ckpt.state_tensors(state)
    assert set(flat) == set(ours) and len(flat) == 3 * N_LEAVES + 2
    for k, t in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      t.detach().numpy(), err_msg=k)


# --- serving -----------------------------------------------------------------

def test_cache_layout_is_the_jax_packages():
    """``make_cache``: the Mamba2 leaves (L, B, ...) in fp32 whatever the
    dtype, one K/V slot per application (n_app, B, Tmax, KV, hd) in the
    cache's dtype, as JAX's ``init_cache``; no two layers share storage."""
    jcfg, cfg = _cfgs()
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        cache = serve_step.make_cache(cfg, BATCH, 20, dtype=dtype)
        jcache = dict(_leaves(jserve_step.make_cache(jcfg, BATCH, 20,
                                                     dtype=jdtype)))
        got = dict(_leaves(cache))
        assert set(got) == set(jcache) == {"mamba.conv", "mamba.ssm", "k",
                                           "v"}
        for k, t in got.items():
            assert tuple(t.shape) == jcache[k].shape, k
            assert str(t.dtype).removeprefix("torch.") == str(
                jcache[k].dtype), k
        assert cache["k"].shape == (2, BATCH, 20, 2, 16)
        assert cache["mamba"]["ssm"].dtype == torch.float32
    conv = cache["mamba"]["conv"]
    conv[0].fill_(1.0)
    assert not conv[1].any()


def test_decode_matches_jax_serve_step():
    """Twelve teacher-forced decode steps from JAX's cache (fp32,
    ``cache_from_jax``) against JAX's jitted serve step on the same cache:
    logits, next tokens and every cache leaf after every step; then the
    decode against the port's own forward."""
    jcfg, cfg = _cfgs()
    jp = _jp(jcfg)
    tb, jb = _batch(cfg, seed=16, seq=DECODE_STEPS)
    model = _model(cfg, _params(jcfg))
    jcache = jserve_step.make_cache(jcfg, BATCH, DECODE_STEPS,
                                    dtype=jnp.float32)
    cache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache))
    jserve = jax.jit(jserve_step.make_serve_step(jcfg))
    pserve = serve_step.make_serve_step(cfg)
    logits = []
    for t in range(DECODE_STEPS):
        jnxt, jcache, jlogits = jserve(jp, jcache, jb["tokens"][:, t:t + 1],
                                       jnp.int32(t))
        pnxt, cache, plogits = pserve(model, cache,
                                      tb["tokens"][:, t:t + 1], t)
        _close_to_largest(plogits, jlogits, TOL, f"logits at step {t}")
        np.testing.assert_array_equal(pnxt.numpy(), np.asarray(jnxt))
        jleaves = dict(_leaves(jax.tree.map(np.asarray, jcache)))
        for k, leaf in _leaves(cache):
            _close_to_largest(leaf, jleaves[k], TOL, f"cache {k} at {t}")
        logits.append(plogits[:, 0])
    with torch.inference_mode():
        full = model(tb["tokens"])
    _close_to_largest(torch.stack(logits, 1), full, TOL, "decode vs forward")
    with pytest.raises(ValueError, match="past the cache"):
        zamba2.decode_step(model, cache, tb["tokens"][:, :1], DECODE_STEPS)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_step_matches_jax_and_the_decode(impl, monkeypatch):
    """``make_prefill_step`` against JAX's (its Pallas flash and conv in
    interpret mode) on a 64-token prompt: a flash call an application;
    then ``serve.prefill_gap`` against the port's sequential decode."""
    jcfg, cfg = _cfgs(impl)
    jp = _jp(jcfg)
    tb, jb = _batch(cfg, seed=18)
    model = _model(cfg, _params(jcfg))
    jnxt, jlogits = jax.jit(jserve_step.make_prefill_step(jcfg))(
        jp, {"tokens": jb["tokens"]})
    calls = {"n": 0}
    real = fa.flash_fwd

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd", counted)
    pnxt, plogits = serve_step.make_prefill_step(cfg)(model, tb)
    assert plogits.shape == (BATCH, 1, cfg.padded_vocab)
    _close_to_largest(plogits, jlogits, TOL, "prefill logits")
    np.testing.assert_array_equal(pnxt.numpy(), np.asarray(jnxt))
    assert calls["n"] == (2 if impl == "flash" else 0)
    cache = serve_step.make_cache(cfg, BATCH, SEQ, dtype=torch.float32)
    step = serve_step.make_serve_step(cfg)
    for t in range(SEQ):
        _, cache, logits = step(model, cache, tb["tokens"][:, t:t + 1], t)
    gap = serve.prefill_gap(model, cfg, tb["tokens"], logits)
    assert gap["gap"] <= gap["tol"] == serve.PREFILL_TOL_F32
    assert gap["tokens_equal"]


def test_jax_refuses_an_fp32_cache_for_a_bf16_hybrid():
    """The reference's behaviour, pinned: the JAX launcher's fp32 cache
    (``make_cache(..., dtype=jnp.float32)``) turns a bf16 Zamba2's shared
    block output fp32 and its ``lax.cond`` refuses the branches; with a
    bf16 K/V cache (``init_cache``'s default) it decodes.  The port's
    launcher gives a bf16 hybrid a cache of the model's dtype, its Mamba2
    states fp32 as JAX's, and decodes within the bf16 prefill tolerance
    of its fused prefill."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp = jzamba2.init_params(jax.random.key(2), jcfg)
    tokens = jnp.ones((BATCH, 1), jnp.int32)
    fp32 = jserve_step.make_cache(jcfg, BATCH, 8, dtype=jnp.float32)
    with pytest.raises(TypeError, match="branches"):
        jzamba2.decode_step(jp, jcfg, fp32, tokens, 0)
    logits, _ = jzamba2.decode_step(
        jp, jcfg, jserve_step.make_cache(jcfg, BATCH, 8), tokens, 0)
    assert bool(jnp.isfinite(logits).all())
    assert serve.lm_cache_dtype(cfg) == torch.bfloat16
    assert serve.lm_cache_dtype(_cfgs()[1]) == torch.float32
    model = zamba2.init_params(cfg, seed=4)
    args = serve.parse_args(["--arch", ARCH, "--device", "cpu", "--batch",
                             "2", "--prompt-len", "6", "--gen", "4",
                             "--seed", "3"])
    stats = serve.serve_lm(args, cfg, model=model)
    assert stats["cache_dtype"] == "torch.bfloat16"
    gap = serve.prefill_gap(model, cfg, stats["prompt"],
                            stats["prompt_logits"])
    assert gap["gap"] <= gap["tol"] and gap["tokens_equal"]


def test_serve_lm_matches_the_jax_launchers_loop():
    """``serve_lm`` on JAX's weights against the JAX launcher's loop (its
    jitted serve step over an fp32 cache, the fp32 model): the prompt,
    the logits at the prompt's end and every generated token."""
    jcfg, cfg = _cfgs()
    jp = _jp(jcfg)
    model = _model(cfg, _params(jcfg))
    args = serve.parse_args(["--arch", ARCH, "--device", "cpu", "--batch",
                             "3", "--prompt-len", "6", "--gen", "7",
                             "--seed", "5"])
    stats = serve.serve_lm(args, cfg, model=model)
    cache = jserve_step.make_cache(jcfg, 3, 13, dtype=jnp.float32)
    jserve = jax.jit(jserve_step.make_serve_step(jcfg))
    prompt = jnp.asarray(np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 6)), jnp.int32)
    np.testing.assert_array_equal(stats["prompt"].numpy(),
                                  np.asarray(prompt))
    for t in range(6):
        nxt, cache, logits = jserve(jp, cache, prompt[:, t:t + 1],
                                    jnp.int32(t))
    _close_to_largest(stats["prompt_logits"], logits, TOL,
                      "logits at the prompt's end")
    out = [nxt]
    for t in range(6, 12):
        nxt, cache, logits = jserve(jp, cache, nxt, jnp.int32(t))
        out.append(nxt)
    np.testing.assert_array_equal(
        stats["tokens"], np.asarray(jnp.concatenate(out, axis=1)))
    assert stats["steps"] == 6 and stats["cache_dtype"] == "torch.float32"


# --- launchers ---------------------------------------------------------------

def test_launcher_serves_zamba2_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--batch", "2", "--prompt-len", "8", "--gen",
                       "8"]) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "logits finite" in out
    assert "smoke: fused prefill == sequential decode" in out


def test_launcher_trains_zamba2_on_cpu(capsys):
    summary = train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--attn-impl", "flash", "--steps", "3", "--batch",
                         "2", "--seq", "16"])
    assert summary["arch"] == ARCH + "-smoke"
    assert summary["attn_impl"] == "flash"
    assert len(summary["losses"]) == 3 and np.isfinite(summary["losses"]).all()
    assert summary["skipped_steps"] == 0
    out = capsys.readouterr().out
    assert "attn_impl=flash" in out and "tokens/s" in out


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launcher_default_device_without_cuda_raises(launcher):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        if launcher == "serve":
            serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--prompt-len", "4", "--gen", "4"])
        else:
            train.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_models_and_losses_take_the_hybrid_family():
    _, cfg = _cfgs()
    assert models.get_model(cfg) is zamba2
    assert losses.make_loss_fn(cfg) is not None
    assert common.maybe_remat(len, cfg) is len  # remat off when reduced
    with pytest.raises(ValueError, match="hybrid"):
        zamba2.init_params(reduced(configs.get("mamba2-370m")))
