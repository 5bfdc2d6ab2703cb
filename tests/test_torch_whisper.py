"""The port's encoder-decoder family (``repro_torch``: Whisper's config,
the sinusoidal and learned position embeddings, ``encdec_batch``, the
conv frontend, the encoder, the decoder, the loss, the train step with
the frontend's unused leaves, the cross-attention cache, decode, the
fused prefill and both launchers) against the JAX package, on the CPU.

The reduced Whisper-large-v3 config (2 + 2 layers, d_model 64, 4 heads,
over 2 KV heads of 16 in the self-attention and over all 4 in the
cross-attention, d_ff 128, vocab 256, 64 encoder frames, fp32) runs with
the JAX package's initial weights, every norm and bias made random
(their init values, ones and zeros, would leave those paths untested),
through both packages on the same batches (``encdec_batch``, bitwise
equal across the packages from one seed), for both ``attn_impl`` values.
The JAX side runs its Pallas flash kernels in interpret mode, which need
the sequence to be a multiple of the query tile ``min(attn_chunk, T)``
(64 here): at full width (1,500 frames over a tile of 256) JAX's flash
refuses the encoder, so a ragged encoder width is held against JAX's
``chunked`` path.  The port's flash wrappers compute their plain
versions on CPU tensors.

The JAX package serves Whisper against a cross-attention cache of zeros
(its ``init_cache`` makes one and nothing fills it); the port fills it
with ``fill_cross_cache``, and the JAX side of these tests builds the
same filled cache from JAX's own ``encode`` and ``cross_kv``.

Tolerances, as in ``tests/test_torch_transformer.py``: logits, hidden
and encoder states within 1e-5 of their largest value and the loss
within rtol 1e-5 (fp32, sums in another order); each gradient within
``GRAD_TOL`` (1e-5) of its leaf's largest value, the gradient norms
within ``GNORM_RTOL`` (5e-4).  Over three AdamW steps (lr 1e-3) the
parameters within 1e-5 absolute, except that AdamW's first steps are
sign-like, so an element whose gradient is within the two frameworks'
rounding of zero may step by up to ``2 * lr`` the other way: at most
``FLIP_FRAC`` (1e-4) of the elements may.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.data import synthetic as jsynthetic
from repro.models import common as jcm
from repro.models import whisper as jwhisper
from repro.train import losses as jlosses
from repro.train import serve_step as jserve_step
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert, models
from repro_torch.configs.base import reduced
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import common, whisper
from repro_torch.roofline import flops
from repro_torch.train import losses, serve_step
from repro_torch.train.data_parallel import param_grads
from repro_torch.train.train_step import make_train_step

ARCH = "whisper-large-v3"
IMPLS = ("chunked", "flash")
BATCH, SEQ = 2, 64
TOL, GRAD_TOL, GNORM_RTOL = 1e-5, 1e-5, 5e-4
LR, FLIP_FRAC = 1e-3, 1e-4
DECODE_STEPS = 12
# K's bias in the self-attention: without rotary embeddings it adds q . bk
# to every score of a query's row, which the softmax ignores, so its exact
# gradient is zero and both packages return rounding noise there (about
# 1e-9), held within GRAD_TOL of the K projection's largest gradient; and
# AdamW turns noise into steps of about lr of either sign, so its elements
# are left out of the flip count (each still within 2 lr a step)
ZERO_GRAD = {"enc_layers.attn.bk": "enc_layers.attn.wk",
             "dec_layers.attn.bk": "dec_layers.attn.wk"}


def _cfgs(impl="chunked", **kw):
    return (dataclasses.replace(jreduced(jconfigs.get(ARCH)), attn_impl=impl,
                                **kw),
            dataclasses.replace(reduced(configs.get(ARCH)), attn_impl=impl,
                                **kw))


@functools.cache
def _params(jcfg, seed=0):
    """The JAX package's initial parameters with every norm scale and bias
    made random, as numpy."""
    tree = jax.tree.map(np.asarray,
                        jwhisper.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 3)

    def jitter(path, a):
        name = path[-1].key
        if name.startswith("w") or name in ("tok", "pos", "unembed") or (
                name.startswith("conv") and name.endswith("_w")):
            return a
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

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
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    return tb, {k: jnp.asarray(np.asarray(v)) for k, v in tb.items()}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t, np.float32))


def _close_to_largest(got, want, rel, what):
    got, want = _np(got), _np(want)
    finite = want > -1e29  # the padded vocabulary's NEG_INF columns
    scale = max(float(np.abs(np.where(finite, want, 0)).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _check_grads(got: dict, want: dict, skip=()):
    """Each gradient leaf within GRAD_TOL of its largest value (a
    ``ZERO_GRAD`` leaf: of its K projection's); ``skip`` names prefixes
    left out."""
    assert set(got) == set(want)
    for k, g in want.items():
        if k.startswith(tuple(skip)):
            continue
        if k in ZERO_GRAD:
            scale = float(np.abs(_np(want[ZERO_GRAD[k]])).max())
            assert np.abs(_np(got[k]) - _np(g)).max() <= GRAD_TOL * scale, k
        else:
            _close_to_largest(got[k], g, GRAD_TOL, k)


def _jax_filled_cache(jcfg, jparams, frames, max_len):
    """JAX's cache (``make_cache``, fp32) with its cross K/V filled from
    JAX's ``encode`` and ``cross_kv`` vmapped over the decoder's layers."""
    cache = jserve_step.make_cache(jcfg, frames.shape[0], max_len,
                                   dtype=jnp.float32)
    enc = jwhisper.encode(jparams, jcfg, frames)
    k, v = jax.vmap(lambda p: jwhisper.cross_kv(p, enc, jcfg))(
        jparams["dec_layers"]["cross"])
    return dict(cache, cross_k=k, cross_v=v)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


# --- configs, data, embeddings -----------------------------------------------------

FIELDS = ("family", "n_layers", "n_encoder_layers", "encoder_width",
          "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab_size", "qk_norm", "qkv_bias", "attn_out_bias", "norm",
          "norm_eps", "mlp_act", "mlp_bias", "tie_embeddings",
          "pos_embedding", "max_position", "dtype", "remat", "remat_policy",
          "attn_chunk", "xent_chunk", "attn_impl", "padded_vocab", "source")


@pytest.mark.parametrize("which", ["published", "reduced"])
def test_config_is_the_jax_packages(which):
    jcfg, cfg = jconfigs.get(ARCH), configs.get(ARCH)
    if which == "reduced":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
        assert cfg.name == jcfg.name == ARCH + "-smoke"
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), (which, f)


def test_published_widths():
    """arXiv:2212.04356's large-v3: 32 + 32 layers of d_model 1280, 20
    heads of 64 (MHA), d_ff 5120, 51,866 tokens, 1,500 frames; 1.69 B
    parameters in the port's model, of which 629 M in the encoder, 84 M in
    the learned position table and 2.7 M in the conv frontend; the
    roofline's count (JAX's) leaves out the position table, the frontend,
    norms and biases."""
    cfg = configs.get(ARCH)
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.encoder_width, cfg.padded_vocab) == (
        32, 32, 1280, 20, 20, 64, 5120, 51866, 1500, 51968)
    assert (cfg.norm, cfg.mlp_act, cfg.pos_embedding, cfg.dtype) == (
        "layernorm", "gelu", "learned", "bfloat16")
    spec = whisper._leaf_spec(cfg)
    n = {k: int(np.prod(s)) for k, (s, _, _) in spec.items()}
    assert 1.68e9 < sum(n.values()) < 1.70e9
    assert 6.28e8 < sum(v for k, v in n.items()
                        if k.startswith("enc_layers.")) < 6.30e8
    assert n["embed.pos"] == (1 << 16) * 1280
    assert sum(v for k, v in n.items() if k.startswith("frontend.")) == (
        3 * 1280 * 128 + 3 * 1280 * 1280 + 2 * 1280)
    assert flops.param_count(cfg) == 1600783360


@pytest.mark.parametrize("T,d", [(64, 64), (7, 10), (1500, 1280)])
def test_sinusoidal_positions_match_jax(T, d):
    """Within 1e-6 of JAX's at the reduced widths.  At full width the two
    packages' fp32 ``exp`` (XLA's and PyTorch's) give some column's
    frequency one ulp (2^-24 of it, at most 2^-24) apart, which the
    position t multiplies inside sin: row t within (t + 1) 2^-23."""
    want = np.asarray(jcm.sinusoidal_positions(T, d))
    got = common.sinusoidal_positions(T, d)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    bound = 1e-6 if T <= 64 else (np.arange(T)[:, None] + 1) * 2.0 ** -23
    assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("pos_embedding", ["learned", "sinusoidal"])
def test_embedding_matches_jax(pos_embedding):
    """The token rows plus the learned table's rows at ``positions`` (or at
    0..T-1 by default): bitwise; or plus the sinusoids: within 1e-6."""
    jcfg, cfg = _cfgs(pos_embedding=pos_embedding)
    jemb = jax.tree.map(np.asarray,
                        jcm.init_embed(jax.random.key(3), jcfg, jnp.float32))
    assert set(jemb) == set(common.embedding_leaves(cfg))
    for k, (shape, _, _) in common.embedding_leaves(cfg).items():
        assert jemb[k].shape == shape
    toks = np.random.default_rng(0).integers(0, 256, (2, 9)).astype(np.int32)
    tok = torch.from_numpy(np.array(jemb["tok"]))
    pos = torch.from_numpy(np.array(jemb["pos"])) if "pos" in jemb else None
    for positions in (None, np.array([5]), np.arange(3, 12)):
        t = toks[:, :1] if positions is not None and len(positions) == 1 \
            else toks
        want = jcm.embed_tokens(jax.tree.map(jnp.asarray, jemb),
                                jnp.asarray(t), jcfg,
                                positions=None if positions is None
                                else jnp.asarray(positions))
        got = common.embed_tokens(
            tok, torch.from_numpy(t), cfg, pos=pos,
            positions=None if positions is None
            else torch.from_numpy(positions))
        if pos_embedding == "learned":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 7])
def test_encdec_batch_is_bitwise_the_jax_packages(seed, dtype):
    cfg = dataclasses.replace(reduced(configs.get(ARCH)), dtype=dtype)
    jcfg = dataclasses.replace(jreduced(jconfigs.get(ARCH)), dtype=dtype)
    got = synthetic.make_batch(cfg, 3, 20, seed=seed)
    want = jsynthetic.make_batch(jcfg, 3, 20, seed=seed)
    assert set(got) == set(want) == {"tokens", "labels", "frames"}
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["frames"].dtype == getattr(torch, dtype)
    assert got["frames"].shape == (3, 64, 64)
    np.testing.assert_array_equal(got["frames"].float().numpy(),
                                  want["frames"].astype(np.float32))


def test_loader_moves_the_frames():
    _, cfg = _cfgs()
    loader = synthetic.SyntheticLoader(cfg, 4, 8, seed=2, rank=1, world=2)
    try:
        b = next(loader)
    finally:
        loader.close()
    want = synthetic.make_batch(cfg, 4, 8, seed=2)
    assert torch.equal(b["frames"], want["frames"][2:])
    np.testing.assert_array_equal(b["tokens"].numpy(), want["tokens"][2:])


# --- the conv frontend --------------------------------------------------------------

def test_conv_frontend_and_its_gradient_match_jax(monkeypatch):
    """mel (2, 128, 40) through both frontends (JAX's default CPU backend;
    the port's ``ops.conv1d`` on CPU tensors, its plain version), then the
    gradient of a random projection of the frames to mel and the four
    leaves."""
    jcfg, cfg = _cfgs()
    jp = _params(jcfg)["frontend"]
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 128, 40)).astype(np.float32)
    cot = rng.standard_normal((2, 20, 64)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jwhisper.conv_frontend(p, x, jcfg) * cot)

    jout = jwhisper.conv_frontend(jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(mel), jcfg)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(mel))
    p = {k: torch.from_numpy(np.array(v)).requires_grad_()
         for k, v in jp.items()}
    x = torch.from_numpy(mel).requires_grad_()
    calls = {"n": 0}
    real = ops.conv1d

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(ops, "conv1d", counted)
    out = whisper.conv_frontend(p, x, cfg)
    assert calls["n"] == 2 and out.shape == (2, 20, 64)
    _close_to_largest(out, jout, TOL, "frames")
    (out * torch.from_numpy(cot)).sum().backward()
    _close_to_largest(x.grad, jg_x, GRAD_TOL, "d mel")
    for k, t in p.items():
        _close_to_largest(t.grad, jg_p[k], GRAD_TOL, k)


# --- the model -----------------------------------------------------------------------

def test_state_dict_is_the_jax_tree():
    """Keys, shapes and dtypes are the JAX tree's (frontend included), the
    per-layer leaves stacked under ``enc_layers`` and ``dec_layers``; so
    AdamW's ``ndim >= 2`` rule decays the same leaves in both packages."""
    jcfg, cfg = _cfgs()
    model = whisper.init_params(cfg, seed=1)
    want = convert.params_from_jax(_params(jcfg))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == 52
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert got["enc_layers.attn.wq"].shape == (2, 64, 64)
    assert got["enc_layers.attn.wk"].shape == (2, 64, 32)  # 2 KV heads
    assert got["dec_layers.cross.wk"].shape == (2, 64, 64)  # all 4 heads
    assert "dec_layers.cross.bk" not in got
    assert got["embed.pos"].shape == (4096, 64)
    assert got["frontend.conv2_w"].shape == (3, 64, 64)
    decayed = {k for k, p in got.items() if p.ndim >= 2}
    assert {"frontend.conv1_w", "frontend.conv2_w",
            "enc_layers.attn_norm.scale"} <= decayed
    assert "enc_norm.scale" not in decayed
    a, b = whisper.init_params(cfg, seed=1), whisper.init_params(cfg, seed=2)
    assert torch.equal(a.frontend.conv1_w, model.frontend.conv1_w)
    assert not torch.equal(a.frontend.conv1_w, b.frontend.conv1_w)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_logits_and_loss_match_jax(impl):
    """The encoder's states, the fp32 logits, the loss, the final hidden
    state and the last-position logits against JAX's ``encode``,
    ``forward`` and ``encdec_loss``; ``extra_embeds`` is ``frames``."""
    jcfg, cfg = _cfgs(impl)
    jp = _jp(jcfg)
    tb, jb = _batch(cfg)
    model = _model(cfg, _params(jcfg))
    _close_to_largest(whisper.encode(model, tb["frames"]),
                      jwhisper.encode(jp, jcfg, jb["frames"]), TOL, "enc")
    jlogits, _ = jwhisper.forward(jp, jcfg, jb["tokens"], frames=jb["frames"])
    logits = model(tb["tokens"], frames=tb["frames"])
    assert logits.shape == (BATCH, SEQ, 256) and logits.dtype == torch.float32
    _close_to_largest(logits, jlogits, TOL, "logits")
    jloss, _ = jlosses.make_loss_fn(jcfg)(jp, jb)
    loss, aux = losses.make_loss_fn(cfg)(model, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert aux["nll"] is loss
    jhidden, _ = jwhisper.forward(jp, jcfg, jb["tokens"], frames=jb["frames"],
                                  hidden_only=True)
    _close_to_largest(model(tb["tokens"], extra_embeds=tb["frames"],
                            hidden_only=True), jhidden, TOL, "hidden")
    jlast, _ = jwhisper.forward(jp, jcfg, jb["tokens"], frames=jb["frames"],
                                last_only=True)
    last = model(tb["tokens"], frames=tb["frames"], last_only=True)
    assert last.shape == (BATCH, 1, 256)
    _close_to_largest(last, jlast, TOL, "last")
    with pytest.raises(ValueError, match="frames"):
        model(tb["tokens"])


@pytest.mark.parametrize("impl", IMPLS)
def test_grads_match_jax(impl):
    """Every gradient leaf of the loss against ``jax.value_and_grad`` of
    the JAX one (the flash path: ``FlashAttentionFunction`` on CPU tensors
    against JAX's ``custom_vjp`` of its Pallas kernels), the global norm,
    and the frontend's leaves, which the loss does not read: zeros on
    both sides."""
    jcfg, cfg = _cfgs(impl)
    tb, jb = _batch(cfg, seed=12)
    (jloss, _), jgrads = jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True)(_jp(jcfg), jb)
    model = _model(cfg, _params(jcfg))
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    loss, _ = losses.make_loss_fn(cfg)(model, tb)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, param_grads(loss, params)))
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == before  # CPU
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    _check_grads(grads, want)
    for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b"):
        assert not grads[f"frontend.{k}"].any() and not want[
            f"frontend.{k}"].any()
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    jnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in want.values()))
    np.testing.assert_allclose(norm, jnorm, rtol=GNORM_RTOL)


@pytest.mark.parametrize("width", [50, 100])
def test_ragged_encoder_flash_matches_jax_chunked(width):
    """The port's flash over a ragged encoder row (50 frames: one query
    tile shorter than ``attn_chunk``; 100: a tile of 64 and a ragged one,
    as 1,500 frames over 256 at full width) against JAX's ``chunked``
    path: logits, loss and every gradient.  JAX's flash refuses 100."""
    jcfg, cfg = _cfgs("chunked", encoder_width=width)
    _, fcfg = _cfgs("flash", encoder_width=width)
    tb, jb = _batch(fcfg, seed=14, seq=32)
    (jloss, _), jgrads = jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True)(_jp(jcfg), jb)
    model = _model(fcfg, _params(jcfg))
    loss, _ = losses.make_loss_fn(fcfg)(model, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    _check_grads({k: p.grad for k, p in model.named_parameters()}, want,
                 skip=("frontend.",))
    if width > jcfg.attn_chunk:
        jflash = dataclasses.replace(jcfg, attn_impl="flash")
        with pytest.raises(AssertionError):
            jwhisper.encode(_jp(jcfg), jflash, jb["frames"])


def test_remat_matches_no_remat(monkeypatch):
    """Recomputing each layer in the backward gives the same loss and
    gradients, bitwise; the flash forward runs once more per layer: 2 (L_enc
    + L) forward and L_enc + L backward calls with remat on."""
    jcfg, cfg = _cfgs("flash")
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, real):
        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(fa, "flash_fwd", counted("fwd", fa.flash_fwd))
    monkeypatch.setattr(fa, "flash_bwd", counted("bwd", fa.flash_bwd))
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
    n = cfg.n_encoder_layers + cfg.n_layers
    assert out[False][1] == {"fwd": n, "bwd": n}
    assert out[True][1] == {"fwd": 2 * n, "bwd": n}
    assert out[True][0] == out[False][0]
    for k, g in out[False][2].items():
        if g is None:
            assert out[True][2][k] is None and k.startswith("frontend."), k
        else:
            assert torch.equal(out[True][2][k], g), k


# --- the train step -------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_train_steps_match_jax(impl):
    """Three steps of ``make_train_step`` from ``train_state_from_jax`` on
    the same batches as JAX's jitted ``make_train_step``: losses, gradient
    norms, learning rates, parameters (the frontend's, which only AdamW's
    decay moves, among them), counters."""
    jcfg, cfg = _cfgs(impl)
    steps = 3
    kw = dict(peak_lr=LR, warmup_steps=1, total_steps=steps)
    jstate = jtrain_step.init_state(_jp(jcfg))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    front = {k: p.detach().clone() for k, p in
             state.params.frontend.named_parameters()}
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
        if k not in ZERO_GRAD:
            beyond += int((diff > 1e-5).sum())
            total += diff.numel()
    assert beyond <= FLIP_FRAC * total, (beyond, total)
    # the frontend's matrices decayed (and moved as JAX's did); its zero
    # biases stayed
    for k, p in state.params.frontend.named_parameters():
        if k.endswith("_w"):
            assert not torch.equal(p, front[k]), k
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[f"frontend.{k}"].numpy(),
                                       rtol=1e-6, atol=0)
        else:
            assert torch.equal(p, front[k]), k


# --- serving ------------------------------------------------------------------------------

def test_fill_cross_cache_matches_jax():
    """``fill_cross_cache`` against JAX's ``encode`` and ``cross_kv``
    vmapped over the decoder's layers; the cache keeps JAX's layouts and
    its self-attention K/V stay zero."""
    jcfg, cfg = _cfgs()
    jp = _jp(jcfg)
    tb, jb = _batch(cfg, seed=15)
    model = _model(cfg, _params(jcfg))
    cache = serve_step.make_cache(cfg, BATCH, 20, dtype=torch.float32)
    jcache = jserve_step.make_cache(jcfg, BATCH, 20, dtype=jnp.float32)
    jleaves = dict(_leaves(jcache))
    assert set(jleaves) == set(cache) == {"k", "v", "cross_k", "cross_v"}
    for k, t in cache.items():
        assert tuple(t.shape) == jleaves[k].shape, k
    assert cache["cross_k"].shape == (2, BATCH, 64, 4, 16)
    assert cache["k"].shape == (2, BATCH, 20, 2, 16)
    assert whisper.fill_cross_cache(model, cache, tb["frames"]) is cache
    want = _jax_filled_cache(jcfg, jp, jb["frames"], 20)
    for k in ("cross_k", "cross_v"):
        _close_to_largest(cache[k], want[k], TOL, k)
    assert not cache["k"].any() and not cache["v"].any()
    small = serve_step.make_cache(cfg, BATCH, 20, dtype=torch.float32,
                                  enc_len=10)
    assert small["cross_k"].shape == (2, BATCH, 10, 4, 16)
    with pytest.raises(ValueError, match="do not fit"):
        whisper.fill_cross_cache(model, small, tb["frames"])


def test_decode_matches_jax_on_the_filled_cache():
    """Twelve teacher-forced decode steps on the filled cache (converted
    from JAX's by ``cache_from_jax``) against JAX's jitted serve step on
    the same cache: logits, next tokens and every cache leaf after every
    step; then the decode against the port's own forward."""
    jcfg, cfg = _cfgs()
    jp = _jp(jcfg)
    tb, jb = _batch(cfg, seed=16, seq=DECODE_STEPS)
    model = _model(cfg, _params(jcfg))
    jcache = _jax_filled_cache(jcfg, jp, jb["frames"], DECODE_STEPS)
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
        for k, leaf in cache.items():
            _close_to_largest(leaf, jleaves[k], TOL, f"cache {k} at {t}")
        logits.append(plogits[:, 0])
    with torch.inference_mode():
        full = model(tb["tokens"], frames=tb["frames"])
    _close_to_largest(torch.stack(logits, 1), full, TOL, "decode vs forward")


def test_jax_launchers_zero_cross_cache_ignores_the_audio():
    """The reference's behaviour, pinned: the JAX launcher's cache
    (``make_cache``, cross K/V zeros, never filled) decodes logits far
    from JAX's own ``forward`` on the frames (about the largest logit
    apart), while the cache filled from ``encode`` and ``cross_kv``
    matches it within TOL."""
    jcfg, _ = _cfgs()
    jp = _jp(jcfg)
    _, jb = _batch(_cfgs()[1], seed=17, seq=DECODE_STEPS)
    full, _ = jwhisper.forward(jp, jcfg, jb["tokens"], frames=jb["frames"])
    full = np.asarray(full)
    jserve = jax.jit(jserve_step.make_serve_step(jcfg))
    gaps = {}
    for name, cache in (
            ("zeros", jserve_step.make_cache(jcfg, BATCH, DECODE_STEPS,
                                             dtype=jnp.float32)),
            ("filled", _jax_filled_cache(jcfg, jp, jb["frames"],
                                         DECODE_STEPS))):
        assert bool(jnp.any(cache["cross_k"] != 0)) == (name == "filled")
        out = []
        for t in range(DECODE_STEPS):
            _, cache, logits = jserve(jp, cache, jb["tokens"][:, t:t + 1],
                                      jnp.int32(t))
            out.append(np.asarray(logits)[:, 0])
        got = np.stack(out, 1)[..., :jcfg.vocab_size]
        want = full[..., :jcfg.vocab_size]
        gaps[name] = np.abs(got - want).max() / np.abs(want).max()
    assert gaps["filled"] <= TOL
    assert gaps["zeros"] > 0.1, gaps


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_step_matches_jax_and_the_decode(impl, monkeypatch):
    """``make_prefill_step`` with the frames against JAX's (its Pallas
    flash in interpret mode) on a 12-token prompt: 2 flash calls for the
    encoder and 2 for the decoder; then ``serve.prefill_gap`` against the
    port's sequential decode on the filled cache."""
    jcfg, cfg = _cfgs(impl)
    jp = _jp(jcfg)
    tb, jb = _batch(cfg, seed=18, seq=DECODE_STEPS)
    model = _model(cfg, _params(jcfg))
    jnxt, jlogits = jax.jit(jserve_step.make_prefill_step(jcfg))(
        jp, {"tokens": jb["tokens"], "frames": jb["frames"]})
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
    assert calls["n"] == (4 if impl == "flash" else 0)
    cache = serve_step.make_cache(cfg, BATCH, DECODE_STEPS,
                                  dtype=torch.float32)
    whisper.fill_cross_cache(model, cache, tb["frames"])
    step = serve_step.make_serve_step(cfg)
    for t in range(DECODE_STEPS):
        _, cache, logits = step(model, cache, tb["tokens"][:, t:t + 1], t)
    gap = serve.prefill_gap(model, cfg, tb["tokens"], logits, tb["frames"])
    assert gap["gap"] <= gap["tol"] == serve.PREFILL_TOL_F32
    assert gap["tokens_equal"]


def test_bf16_decode_runs_on_a_cache_of_the_models_dtype():
    """A bf16 model serves with a bf16 cache (``lm_cache_dtype``): finite
    logits, and the decode within the bf16 prefill tolerance of the fused
    prefill."""
    _, cfg = _cfgs(dtype="bfloat16")
    assert serve.lm_cache_dtype(cfg) == torch.bfloat16
    model = whisper.init_params(cfg, seed=4)
    args = serve.parse_args(["--arch", ARCH, "--device", "cpu", "--batch",
                             "2", "--prompt-len", "5", "--gen", "4",
                             "--seed", "3"])
    stats = serve.serve_lm(args, cfg, model=model)
    assert stats["cache_dtype"] == "torch.bfloat16"
    assert stats["frames"].dtype == torch.bfloat16 and stats["encode_s"] > 0
    gap = serve.prefill_gap(model, cfg, stats["prompt"],
                            stats["prompt_logits"], stats["frames"])
    assert gap["gap"] <= gap["tol"] and gap["tokens_equal"]


def test_serve_lm_matches_jax_on_the_filled_cache():
    """``serve_lm`` on JAX's weights against the JAX launcher's loop run on
    the cache filled from the same seeded frames: the prompt, the logits
    at the prompt's end and every generated token."""
    jcfg, cfg = _cfgs()
    jp = _jp(jcfg)
    model = _model(cfg, _params(jcfg))
    args = serve.parse_args(["--arch", ARCH, "--device", "cpu", "--batch",
                             "3", "--prompt-len", "6", "--gen", "7",
                             "--seed", "5"])
    stats = serve.serve_lm(args, cfg, model=model)
    frames = jsynthetic.make_batch(jcfg, 3, 6, seed=5)["frames"]
    np.testing.assert_array_equal(stats["frames"].numpy(), frames)
    cache = _jax_filled_cache(jcfg, jp, jnp.asarray(frames), 13)
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


# --- launchers ------------------------------------------------------------------------------

def test_launcher_serves_whisper_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--batch", "2", "--prompt-len", "4", "--gen",
                       "8"]) == 0
    out = capsys.readouterr().out
    assert "encode (2, 64, 64) frames" in out
    assert "p50" in out and "logits finite" in out
    assert "smoke: fused prefill == sequential decode" in out


def test_launcher_trains_whisper_on_cpu(capsys):
    summary = train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--attn-impl", "flash", "--steps", "3", "--batch",
                         "2", "--seq", "16"])
    assert summary["arch"] == ARCH + "-smoke"
    assert summary["attn_impl"] == "flash"
    assert len(summary["losses"]) == 3 and np.isfinite(summary["losses"]).all()
    assert summary["skipped_steps"] == 0
    assert summary["tokens_per_s"] == pytest.approx(
        2 * 16 / summary["median_step_s"])
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
