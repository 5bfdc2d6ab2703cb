"""The port's dense transformer training path (``repro_torch``: configs,
norms, rotary embeddings, attention through the plain path and the flash
wrappers, MLPs, the model, loss, synthetic tokens, the train step with
its in-place AdamW, checkpoints, launcher) against the JAX package, on
the CPU.

The reduced StarCoder2-3B (LayerNorm, GELU, biases, tied embeddings) and
Qwen3-8B (RMSNorm, qk_norm, SwiGLU, no biases) configs (2 layers,
d_model 64, 4 heads over 2 KV heads of 16, d_ff 128, vocab 256, fp32)
run with the JAX package's initial weights, every norm and bias made
random (their init values, ones and zeros, would leave those paths
untested), through both packages on the same token batches (``lm_batch``,
bitwise equal across the packages from one seed), for both
``attn_impl`` values.  The JAX side runs its Pallas flash kernels in
interpret mode; the port's flash wrappers compute their plain versions
on CPU tensors.

Tolerances: logits and hidden states within 1e-5 of their largest value
and the loss within rtol 1e-5 (fp32, sums in another order); each
gradient within 1e-4 of its leaf's largest value (two layers of fp32
sums in another order).  Over four AdamW steps (lr 1e-3) the losses
within rtol 1e-5, the gradient norms within rtol 5e-4 (``GNORM_RTOL``:
JAX's jitted metric is that far from the float64 norm of its own
gradients; see ``tests/test_torch_mamba2.py``) and the parameters within
1e-5 absolute, except that AdamW's first steps are sign-like, so an
element whose gradient is within the two frameworks' rounding of zero may
step by up to ``2 * lr`` the other way: at most ``FLIP_FRAC`` (1e-4) of
the elements may.
"""
from __future__ import annotations

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import reduced as jreduced
from repro.data import synthetic as jsynthetic
from repro.models import common as jcm
from repro.models import transformer as jtransformer
from repro.train import losses as jlosses
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert, models
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import reduced
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models import common, transformer
from repro_torch.optim import adamw
from repro_torch.train import losses
from repro_torch.train.train_step import init_state, make_train_step

ARCHS = ("starcoder2-3b", "qwen3-8b")
DENSE = ARCHS + ("qwen2-7b", "qwen3-14b")
IMPLS = ("chunked", "flash")
BATCH, SEQ = 2, 64
LR = 1e-3
FLIP_FRAC = 1e-4
GNORM_RTOL = 5e-4


def _cfgs(arch, impl="chunked"):
    return (dataclasses.replace(jreduced(jconfigs.get(arch)), attn_impl=impl),
            dataclasses.replace(reduced(configs.get(arch)), attn_impl=impl))


def _jax_params(jcfg, seed=0):
    """The JAX package's initial parameters with every norm, bias and
    qk_norm leaf made random, as numpy."""
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 3)

    def jitter(path, a):
        name = path[-1].key
        if name.startswith("w") or name in ("tok", "unembed"):
            return a
        base = 1.0 if name in ("scale", "q_norm", "k_norm") else 0.0
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(jitter, tree)


@functools.cache
def _params(jcfg):
    return _jax_params(jcfg)


def _batch_np(seed, cfg, batch=BATCH, seq=SEQ):
    return synthetic.make_batch(cfg, batch, seq, seed=seed)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _model(cfg, jparams):
    model = transformer.init_params(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    return model


def _close_to_largest(got, want, rel, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale, err_msg=what)


# --- configs, data -------------------------------------------------------------

FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab_size", "qk_norm", "qkv_bias",
          "attn_out_bias", "rope_theta", "norm", "norm_eps", "mlp_act",
          "mlp_bias", "tie_embeddings", "pos_embedding", "max_position",
          "dtype", "remat", "remat_policy", "attn_chunk", "xent_chunk",
          "attn_impl", "padded_vocab", "source")


@pytest.mark.parametrize("arch", DENSE)
def test_config_is_the_jax_packages(arch):
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
    jr, r = jreduced(jcfg), reduced(cfg)
    for f in FIELDS:
        assert getattr(r, f) == getattr(jr, f), (arch, f)
    assert cfg.attn_impl == "chunked"


def test_starcoder2_widths():
    cfg = configs.get("starcoder2-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.padded_vocab) == (
        30, 3072, 24, 2, 128, 12288, 49152)
    n = sum(np.prod(s) for s, _, _ in transformer._leaf_spec(cfg).values())
    assert 3.0e9 < n < 3.1e9  # 3.03 B parameters


@pytest.mark.parametrize("seed,seq", [(0, 64), (5, 4096)])
def test_lm_batch_is_bitwise_the_jax_packages(seed, seq):
    cfg, jcfg = configs.get("starcoder2-3b"), jconfigs.get("starcoder2-3b")
    got = synthetic.make_batch(cfg, 2, seq, seed=seed)
    want = jsynthetic.make_batch(jcfg, 2, seq, seed=seed)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


# --- the pieces -------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms_match_jax(norm):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    cfg = dataclasses.replace(reduced(configs.get("starcoder2-3b")),
                              norm=norm)
    p = {"scale": jnp.asarray(scale)}
    if norm == "layernorm":
        p["bias"] = jnp.asarray(bias)
    want = jcm.apply_norm(p, jnp.asarray(x), cfg)
    got = common.apply_norm(torch.from_numpy(scale), torch.from_numpy(x), cfg,
                            torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = jcm.rms_head_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = common.rms_head_norm(torch.from_numpy(x), torch.from_numpy(scale),
                               1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    for pos in (np.arange(9), np.stack([np.arange(9), np.arange(9) + 5])):
        want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e5)
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                1e5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_matches_jax(arch):
    """GELU is JAX's default tanh form; SwiGLU's silu in fp32."""
    jcfg, cfg = _cfgs(arch)
    lp = jax.tree.map(lambda a: a[0], _params(jcfg)["dense_layers"]["mlp"])
    x = np.random.default_rng(3).standard_normal((2, 7, 64)).astype(
        np.float32)
    want = jcm.apply_mlp(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jcfg)
    got = common.apply_mlp({k: torch.from_numpy(np.array(v))
                            for k, v in lp.items()}, torch.from_numpy(x), cfg)
    _close_to_largest(got.numpy(), want, 1e-5, "mlp")


# --- the model ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_is_the_jax_tree(arch):
    """Keys, shapes and dtypes are the JAX tree's, per-layer leaves stacked
    under ``dense_layers``; so AdamW's ``ndim >= 2`` rule decays the same
    leaves in both packages."""
    jcfg, cfg = _cfgs(arch)
    model = transformer.init_params(cfg, seed=1)
    want = convert.params_from_jax(_params(jcfg))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == (19 if arch ==
                                                   "starcoder2-3b" else 14)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert got["dense_layers.attn.wq"].shape == (2, 64, 64)
    decayed = {k for k, p in got.items() if p.ndim >= 2}
    assert "dense_layers.attn_norm.scale" in decayed
    assert "final_norm.scale" not in decayed


def test_init_is_seeded():
    _, cfg = _cfgs("starcoder2-3b")
    a, b = (transformer.init_params(cfg, seed=5) for _ in range(2))
    c = transformer.init_params(cfg, seed=6)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.dense_layers.attn.wq, c.dense_layers.attn.wq)
    assert not a.dense_layers.attn.bq.any()
    assert torch.equal(a.final_norm.scale, torch.ones(64))
    w = a.dense_layers.mlp.w_up
    assert abs(w.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_jax(arch, impl):
    """fp32 logits, the loss, the final hidden state and the last-position
    logits against JAX's ``forward``/``lm_loss``."""
    jcfg, cfg = _cfgs(arch, impl)
    jp = jax.tree.map(jnp.asarray, _params(jcfg))
    b = _batch_np(11, cfg)
    tokens = jnp.asarray(b["tokens"])
    jlogits, _ = jtransformer.forward(jp, jcfg, tokens)
    jloss, _ = jlosses.make_loss_fn(jcfg)(jp, jax.tree.map(jnp.asarray, b))
    model = _model(cfg, _params(jcfg))
    t = torch.from_numpy(b["tokens"])
    logits = model(t)
    assert logits.shape == (BATCH, SEQ, 256) and logits.dtype == torch.float32
    _close_to_largest(logits.detach().numpy(), jlogits, 1e-5, "logits")
    loss, aux = losses.make_loss_fn(cfg)(model, _torch_batch(b))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert aux["nll"] is loss
    jhidden, _ = jtransformer.forward(jp, jcfg, tokens, hidden_only=True)
    _close_to_largest(model(t, hidden_only=True).detach().numpy(), jhidden,
                      1e-5, "hidden")
    jlast, _ = jtransformer.forward(jp, jcfg, tokens, last_only=True)
    last = model(t, last_only=True)
    assert last.shape == (BATCH, 1, 256)
    _close_to_largest(last.detach().numpy(), jlast, 1e-5, "last")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch, impl):
    """Every gradient leaf of the loss against ``jax.value_and_grad`` of
    the JAX one (the flash path: ``FlashAttentionFunction`` on CPU
    tensors against JAX's ``custom_vjp`` of its Pallas kernels)."""
    jcfg, cfg = _cfgs(arch, impl)
    b = _batch_np(12, cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, _params(jcfg)),
        jax.tree.map(jnp.asarray, b))
    model = _model(cfg, _params(jcfg))
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    loss, _ = losses.make_loss_fn(cfg)(model, _torch_batch(b))
    loss.backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == before  # CPU
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        _close_to_largest(got[k].grad.numpy(), g.numpy(), 1e-4, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat(arch, monkeypatch):
    """Recomputing each layer in the backward gives the same loss and
    gradients, bitwise; the flash forward runs once more per layer
    (2 L forward and L backward calls with remat on)."""
    jcfg, cfg = _cfgs(arch, "flash")
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, real):
        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(fa, "flash_fwd", counted("fwd", fa.flash_fwd))
    monkeypatch.setattr(fa, "flash_bwd", counted("bwd", fa.flash_bwd))
    b = _torch_batch(_batch_np(13, cfg))
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = _model(c, _params(jcfg))
        calls.update(fwd=0, bwd=0)
        loss, _ = losses.make_loss_fn(c)(model, b)
        loss.backward()
        out[remat] = (loss.item(), dict(calls),
                      {k: p.grad for k, p in model.named_parameters()})
    L = cfg.n_layers
    assert out[False][1] == {"fwd": L, "bwd": L}
    assert out[True][1] == {"fwd": 2 * L, "bwd": L}
    assert out[True][0] == out[False][0]
    for k, g in out[False][2].items():
        assert torch.equal(out[True][2][k], g), k


def test_decode_path_and_other_families_raise():
    """The transformer builds the dense, MoE and VLM families (the VLM's
    leaves are the dense model's: the image embeddings are an input);
    another family raises in the model registry and in ``init_params``."""
    _, cfg = _cfgs("starcoder2-3b")
    vlm = dataclasses.replace(cfg, family="vlm", n_image_tokens=8)
    assert models.get_model(vlm) is transformer
    a, b = transformer.init_params(cfg, seed=4), transformer.init_params(
        vlm, seed=4)
    for (k, va), (kb, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert k == kb and torch.equal(va, vb), k
    assert configs.get("internvl2-2b").family == "vlm"
    unknown = dataclasses.replace(cfg, family="retrieval")
    with pytest.raises(ValueError, match="unknown family"):
        models.get_model(unknown)
    with pytest.raises(ValueError, match="not 'retrieval'"):
        transformer.init_params(unknown)
    assert models.get_model(cfg) is transformer


# --- AdamW in place -------------------------------------------------------------------

def _functional_update(grads, state, params, *, lr, gnorm=None):
    """The port's AdamW update and the train step's skip as they were
    before the update went in place: whole new tensors for the
    parameters, both moments and the count, then ``torch.where`` between
    them and the old ones.  ``gnorm``, where given, replaces the norm of
    the whole leaves."""
    g32 = {k: g.float() for k, g in grads.items()}
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in g32.values()))
    scale = torch.where(gnorm > adamw.GRAD_CLIP,
                        adamw.GRAD_CLIP / (gnorm + 1e-9),
                        torch.ones_like(gnorm))
    g32 = {k: g * scale for k, g in g32.items()}
    count = state.count + 1
    b1c = 1 - adamw.B1 ** count.float()
    b2c = 1 - adamw.B2 ** count.float()
    new_m = {k: adamw.B1 * state.m[k] + (1 - adamw.B1) * g
             for k, g in g32.items()}
    new_v = {k: adamw.B2 * state.v[k] + (1 - adamw.B2) * (g * g)
             for k, g in g32.items()}

    def step(p, m, v):
        upd = (m / b1c) / (torch.sqrt(v / b2c) + adamw.EPS)
        if p.ndim >= 2:
            upd = upd + adamw.WEIGHT_DECAY * p.float()
        return (p.float() - lr * upd).to(p.dtype)

    finite = torch.isfinite(gnorm)

    def keep(n, o):
        return torch.where(finite, n, o)

    new = {k: keep(step(p, new_m[k], new_v[k]), p) for k, p in params.items()}
    opt = adamw.AdamWState(m={k: keep(new_m[k], state.m[k]) for k in params},
                           v={k: keep(new_v[k], state.v[k]) for k in params},
                           count=keep(count, state.count))
    return new, opt, gnorm


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_adamw_equals_the_functional_update(dtype, sliced,
                                                      monkeypatch):
    """``adamw.update_`` gives bitwise what the functional update gave,
    over steps that clip, do not clip, and one with a non-finite
    gradient, which leaves every tensor as it was.  ``sliced``: the large
    leaf goes a slice of its leading axis at a time, its squared sum too,
    so the global norm may differ in its last bits (rtol 1e-6); given the
    same norm the update is bitwise the functional one."""
    if sliced:
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", 40)  # "a.w": 3 x 60
    rng = np.random.default_rng(6)
    shapes = {"a.w": (3, 6, 10), "a.b": (6,), "c.w": (4, 7)}
    tdt = getattr(torch, dtype)
    params = {k: torch.from_numpy(rng.standard_normal(s)).to(tdt)
              for k, s in shapes.items()}
    assert len(adamw._slices(params["a.w"])) == (3 if sliced else 1)
    ref_params = {k: p.clone() for k, p in params.items()}
    state, ref_state = adamw.init(params), adamw.init(ref_params)
    for step, grad_scale in enumerate((0.01, 100.0, float("nan"), 1.0)):
        grads = {k: torch.from_numpy(grad_scale * rng.standard_normal(s)).to(
            tdt) for k, s in shapes.items()}
        lr = torch.tensor(1e-2 * (step + 1))
        gnorm = adamw.global_norm(grads)
        before = {k: p.clone() for k, p in params.items()}
        adamw.update_(grads, state, params, lr=lr, grad_norm=gnorm,
                      finite=torch.isfinite(gnorm))
        whole = _functional_update(grads, ref_state, ref_params, lr=lr)[2]
        np.testing.assert_allclose(gnorm.item(), whole.item(), rtol=1e-6)
        ref_params, ref_state, _ = _functional_update(
            grads, ref_state, ref_params, lr=lr,
            gnorm=gnorm if sliced else None)
        for k in shapes:
            assert torch.equal(params[k], ref_params[k]), (step, k)
            assert torch.equal(state.m[k], ref_state.m[k]), (step, k)
            assert torch.equal(state.v[k], ref_state.v[k]), (step, k)
            if np.isnan(grad_scale):
                assert torch.equal(params[k], before[k])
        assert torch.equal(state.count, ref_state.count)
    assert int(state.count) == 3


def test_skipped_step_leaves_the_train_state():
    """A non-finite loss skips the whole step in the train step."""
    _, cfg = _cfgs("starcoder2-3b")
    state = init_state(transformer.init_params(cfg, seed=2))
    step = make_train_step(cfg, peak_lr=LR, warmup_steps=1, total_steps=4)
    state, m = step(state, _torch_batch(_batch_np(0, cfg)))
    assert m["skipped"].item() == 0.0
    before = {k: t.clone() for k, t in ckpt.state_tensors(state).items()}
    with torch.no_grad():
        state.params.final_norm.bias[0] = float("inf")
    before[".params/final_norm/bias"] = state.params.final_norm.bias.clone()
    state, m = step(state, _torch_batch(_batch_np(1, cfg)))
    assert m["skipped"].item() == 1.0
    after = ckpt.state_tensors(state)
    for k, t in before.items():
        if k != ".step":
            assert torch.equal(after[k], t), k
    assert int(state.step) == 2 and int(state.opt.count) == 1


# --- the train step, checkpoints ----------------------------------------------------------

@pytest.mark.parametrize("arch,impl", [("starcoder2-3b", "flash"),
                                       ("qwen3-8b", "chunked")])
def test_train_steps_match_jax(arch, impl):
    """Four steps of ``make_train_step`` from the same state on the same
    batches as JAX's jitted ``make_train_step``: losses, gradient norms,
    learning rates, parameters, counters."""
    jcfg, cfg = _cfgs(arch, impl)
    steps = 4
    kw = dict(peak_lr=LR, warmup_steps=2, total_steps=steps)
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, _params(jcfg)))
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


def test_checkpoint_jax_writes_port_restores(tmp_path):
    jcfg, cfg = _cfgs("starcoder2-3b")
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, _params(jcfg)))
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, peak_lr=LR,
                                                warmup_steps=1,
                                                total_steps=4))
    for i in range(2):
        jstate, _ = jstep(jstate, _batch_np(i, cfg))
    jckpt.Checkpointer(str(tmp_path)).save(jstate, 2)
    state = ckpt.Checkpointer(str(tmp_path)).restore(
        init_state(transformer.init_params(cfg, seed=9)))
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg)
    got_t, want_t = ckpt.state_tensors(state), ckpt.state_tensors(want)
    assert len(got_t) == 3 * 19 + 2 and set(got_t) == set(want_t)
    assert ".params/dense_layers/attn/wq" in got_t
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype, k
        assert torch.equal(got_t[k], want_t[k]), k


def test_checkpoint_port_writes_jax_restores(tmp_path):
    jcfg, cfg = _cfgs("qwen3-8b")
    state = init_state(_model(cfg, _params(jcfg)))
    step = make_train_step(cfg, peak_lr=LR, warmup_steps=1, total_steps=4)
    for i in range(2):
        state, _ = step(state, _torch_batch(_batch_np(i, cfg)))
    ckpt.Checkpointer(str(tmp_path)).save(state, 2)
    template = jtrain_step.init_state(
        jtransformer.init_params(jax.random.key(1), jcfg))
    restored = jckpt.Checkpointer(str(tmp_path)).restore(template)
    flat = jckpt._flatten(restored)
    ours = ckpt.state_tensors(state)
    assert set(flat) == set(ours) and len(flat) == 3 * 14 + 2
    for k, t in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      t.detach().numpy(), err_msg=k)


# --- launcher -------------------------------------------------------------------------------

SMOKE = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
         "--attn-impl", "flash", "--batch", "2", "--seq", "32"]


def test_launcher_trains_on_cpu_and_resumes(tmp_path, capsys):
    full = train.run(SMOKE + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "2"])
    assert full["attn_impl"] == "flash" and full["arch"] == (
        "starcoder2-3b-smoke")
    assert len(full["losses"]) == 4 and np.isfinite(full["losses"]).all()
    assert full["skipped_steps"] == 0
    assert full["tokens_per_s"] > 0 and "peak_memory_gb" not in full
    out = capsys.readouterr().out
    assert "attn_impl=flash" in out and "tokens/s" in out
    shutil.rmtree(tmp_path / "step_00000004")
    again = train.run(SMOKE + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                               "--resume"])
    assert again["first_step"] == 2
    np.testing.assert_array_equal(again["losses"], full["losses"][2:])


def test_launcher_attn_impl_picks_the_path(monkeypatch):
    """``--attn-impl`` sets the config's field; without it the config's
    own (``chunked``) is kept, and the flash wrappers are not called."""
    calls = {"n": 0}
    real = fa.flash_fwd

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd", counted)
    argv = SMOKE[:5] + ["--batch", "1", "--seq", "16", "--steps", "1"]
    assert train.run(argv)["attn_impl"] == "chunked" and calls["n"] == 0
    assert train.run(argv + ["--attn-impl", "flash"])["attn_impl"] == "flash"
    assert calls["n"] == 2  # one layer call each for 2 layers


def test_launcher_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "starcoder2-3b", "--smoke", "--attn-impl",
                    "flash", "--steps", "1"])


def test_cuda_tensor_reaches_the_kernel_or_raises(monkeypatch):
    """The flash wrappers take the plain version only for a CPU tensor: a
    tensor on another device goes to the kernel path, whose checks refuse
    a device that is not CUDA.  A ``meta`` tensor (a dry-run's) takes
    the kernel path's ``meta`` branch, which launches nothing and returns
    the kernel's empty outputs; the card's checks refuse it as any other
    device that is not CUDA."""
    def plain(*a, **kw):
        raise AssertionError("a tensor off the CPU reached the plain version")

    monkeypatch.setattr(fa._ref, "flash_fwd_ref", plain)
    monkeypatch.setattr(fa._ref, "flash_bwd_ref", plain)
    q = torch.zeros((1, 4, 1, 1, 64), device="meta")
    k = torch.zeros((1, 4, 1, 64), device="meta")
    lse = torch.zeros((1, 4, 1, 1), device="meta")
    launches = fa.flash_fwd.launches, fa.flash_bwd.launches
    o, lse_o = fa.flash_fwd(q, k, k)
    assert (o.shape, lse_o.shape, o.device.type) == (q.shape, lse.shape,
                                                     "meta")
    dq, dk, dv = fa.flash_bwd(q, k, k, q, lse, q)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == launches
    for fn in ("flash_fwd", "flash_bwd"):
        with pytest.raises(ValueError, match="runs on cuda"):
            fa._check_on_card(fn, ("q", q), ("k", k), ("v", k))
