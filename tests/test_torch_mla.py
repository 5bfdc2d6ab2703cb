"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) and
DeepSeek-V3's config through the MoE transformer (the block, both
decodes, the model's logits, loss and gradients, the serve step, the
cache, both launchers, ``convert`` and the roofline's counts) against the
JAX package, on the CPU.

The reduced DeepSeek-V3 config (JAX's ``reduced``: one dense layer of
d_ff 128, then one MoE layer of 8 experts of d_ff 32, top-2 by sigmoid
scores with routed scaling 2.5, 1 shared expert; d_model 64, 4 heads of
MLA at q_lora 32, kv_lora 16, nope 16 + rope 8 for the keys, v 16; vocab
256, fp32) runs with the JAX package's initial weights, every norm scale
and ``router_bias`` made random, on token batches made with numpy from a
seed, for both ``attn_impl`` values.  The JAX side runs its Pallas flash
kernels in interpret mode (v padded from 16 to the qk width 24, as at
full width from 128 to 192); the port's flash wrappers compute their
plain versions on CPU tensors.  Each JAX reference is computed once a
module (``functools.cache``).

Tolerances (fp32, sums in another order): block outputs, logits, hidden
states and decode logits within ``TOL`` (1e-5) of their largest value;
losses within rtol 1e-5; every gradient within ``GRAD_TOL`` (1e-5) of
its leaf's largest value; the caches within ``TOL``; the absorbed decode
within ``TOL`` of the plain one (the same sums regrouped through
``kv_up``); the load-balance loss within 1e-6.  Routing is discontinuous,
so a pass through the MoE layer checks the selection first: the same
experts as sets, with the smallest selection margin at least 100 times
the largest selection-score difference between the two sides.  In bf16
(the cache's dtype behaviour) within ``BF16_TOL`` (3e-2) of the largest
logit: the two packages round bf16 products at other places.
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
from repro.models import mla as jmla
from repro.models import transformer as jtransformer
from repro.roofline import flops as jflops
from repro.train import losses as jlosses
from repro.train import serve_step as jserve_step
from repro_torch import configs, convert, models
from repro_torch.configs.base import NOT_PORTED, reduced
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, train
from repro_torch.models import mla, moe, transformer
from repro_torch.roofline import flops
from repro_torch.train import losses, serve_step
from repro_torch.train.data_parallel import param_grads

ARCH = "deepseek-v3-671b"
IMPLS = ("chunked", "flash")
BATCH, SEQ = 2, 64
TOL, GRAD_TOL, ROUTE_TOL, BF16_TOL = 1e-5, 1e-5, 1e-6, 3e-2
MARGIN_OVER_DIFF = 100.0
DECODE_STEPS = 8
N_LEAVES = 32
ATTN = ("q_down", "q_norm", "q_up", "kv_down", "kv_norm", "kv_up", "wo")


def _cfgs(impl="chunked", **kw):
    return (dataclasses.replace(jreduced(jconfigs.get(ARCH)), attn_impl=impl,
                                **kw),
            dataclasses.replace(reduced(configs.get(ARCH)), attn_impl=impl,
                                **kw))


@functools.cache
def _init(jcfg, seed):
    """The JAX package's initial parameters (jitted), as numpy; the
    attention implementation does not change them."""
    if jcfg.attn_impl != "chunked":
        return _init(dataclasses.replace(jcfg, attn_impl="chunked"), seed)
    return jax.tree.map(np.asarray, jax.jit(
        jtransformer.init_params, static_argnums=1)(jax.random.key(seed),
                                                    jcfg))


@functools.cache
def _params(jcfg, seed=0):
    """The JAX package's initial parameters with every norm scale and
    ``router_bias`` made random, as numpy."""
    tree = _init(jcfg, seed)
    rng = np.random.default_rng(seed + 3)
    base = {"scale": 1.0, "q_norm": 1.0, "kv_norm": 1.0, "router_bias": 0.0}

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
    b = synthetic.make_batch(cfg, batch, seq, seed=seed)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t, np.float32))


def _close_to_largest(got, want, rel, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _layer_attn(jcfg, layer="dense_layers"):
    """One layer's MLA leaves: JAX's (arrays) and the port's (tensors)."""
    jp = jax.tree.map(lambda a: a[0], _params(jcfg)[layer]["attn"])
    return ({k: jnp.asarray(v) for k, v in jp.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in jp.items()})


def _absorb_layout(jcfg, tree):
    """``tree`` (one layer's MLA leaves, or the model's) with every
    ``kv_up`` (..., kv_lora, H * (nope + v)), each head's nope key then
    its value, laid out as JAX's absorbed decode reads it: the nope keys
    of all heads, then the values of all heads.  JAX's absorbed decode on
    the laid-out weights computes the function its plain decode computes
    on the original ones."""
    a, H = jcfg.mla, jcfg.n_heads

    def lay(path, w):
        if path[-1].key != "kv_up":
            return w
        w = jnp.asarray(w).reshape(*w.shape[:-1], H, -1)
        lead = w.shape[:-2]
        return jnp.concatenate(
            [w[..., :a.qk_nope_head_dim].reshape(*lead, -1),
             w[..., a.qk_nope_head_dim:].reshape(*lead, -1)], -1)

    return jax.tree_util.tree_map_with_path(lay, tree)


# --- config, counts, parameters --------------------------------------------

@pytest.mark.parametrize("which", ["published", "reduced"])
def test_config_is_the_jax_packages(which):
    jcfg, cfg = jconfigs.get(ARCH), configs.get(ARCH)
    if which == "reduced":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    for f in ("family", "n_layers", "d_model", "n_heads", "vocab_size",
              "rope_theta", "norm", "norm_eps", "mlp_act", "dtype",
              "attn_chunk", "padded_vocab", "source"):
        assert getattr(cfg, f) == getattr(jcfg, f), (which, f)
    assert dataclasses.asdict(cfg.mla) == dataclasses.asdict(jcfg.mla)
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)


def test_config_is_ported_and_the_vlm_alone_waits():
    """``configs.get`` returns the config; the VLM, which waited here
    last, is ported too (``tests/test_torch_vlm.py``): no architecture is
    refused, and the model registry gives the transformer for both."""
    cfg = configs.get(ARCH)
    assert cfg.mla.kv_lora_rank == 512 and cfg.moe.n_experts == 256
    assert NOT_PORTED == ()
    assert configs.get("internvl2-2b").family == "vlm"
    assert models.get_model(dataclasses.replace(cfg, family="vlm")) is \
        transformer
    assert models.get_model(cfg) is transformer


def test_published_counts_are_the_jax_packages():
    """671.03 B parameters and 37.55 B a token uses (JAX's counts); the
    cuts the card runs (4 layers at every width: 15.11 B; 2 layers of 16
    experts: 3.37 B); the useful flops of a train, prefill and decode step
    and the decode's cache bytes equal JAX's; the decode's bytes are
    JAX's less the untied table's unread rows."""
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    assert flops.param_count(cfg) == jflops.param_count(jcfg)
    assert flops.param_count(cfg) == pytest.approx(671.03e9, rel=1e-5)
    assert flops.active_param_count(cfg) == jflops.active_param_count(jcfg)
    assert flops.active_param_count(cfg) == pytest.approx(37.55e9, rel=1e-4)
    four = dataclasses.replace(cfg, n_layers=4)
    assert flops.param_count(four) == pytest.approx(15.11e9, rel=1e-3)
    cut = dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(
        cfg.moe, n_experts=16, first_dense_layers=1))
    assert flops.param_count(cut) == pytest.approx(3.37e9, rel=2e-3)
    for c, jc in ((cfg, jcfg), (four, dataclasses.replace(jcfg, n_layers=4))):
        for kind, T, B in (("train", 4096, 4), ("prefill", 200, 8),
                           ("decode", 232, 8)):
            shape = flops.StepShape(kind, T, B)
            assert flops.model_flops(c, shape) == jflops.model_flops(
                jc, shape), kind
    shape = flops.StepShape("decode", 232, 8)
    cache = 2 * 8 * 232 * (512 + 64) * 61
    assert flops.decode_cache_bytes(cfg, 8, 232) == cache
    assert jflops.hbm_bytes_decode(jcfg, shape) == (
        2 * jflops.active_param_count(jcfg) + cache)
    assert flops.hbm_bytes_decode(cfg, shape) == (
        jflops.hbm_bytes_decode(jcfg, shape) - 2 * (129280 - 8) * 7168)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_is_the_jax_tree(dtype):
    """Keys, shapes and dtypes are the JAX tree's: each stack's ``attn``
    holds the seven MLA leaves (``init_mla``) in place of GQA's four."""
    jcfg, cfg = _cfgs(dtype=dtype)
    model = transformer.init_params(cfg, seed=1)
    want = convert.params_from_jax(_init(jcfg, 0))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == N_LEAVES
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    attn = {k.split(".")[-1] for k in got if ".attn." in k}
    assert attn == set(ATTN)
    assert got["dense_layers.attn.q_up"].shape == (1, 32, 4 * 24)
    assert got["moe_layers.attn.kv_down"].shape == (1, 64, 16 + 8)
    assert got["moe_layers.attn.kv_up"].shape == (1, 16, 4 * (16 + 16))
    assert got["dense_layers.attn.wo"].shape == (1, 4 * 16, 64)
    assert got["moe_layers.attn.kv_norm"].dtype == getattr(torch, dtype)


def test_init_is_seeded_and_independent_of_the_threads(monkeypatch):
    """The same seed gives the same weights, bitwise, whatever the number
    of host threads; the JAX package's scales (fan-in ** -0.5); a leaf of
    more than ``SLAB`` values is drawn in blocks of rows, an expert leaf
    a (layer, expert) slab at a time."""
    _, cfg = _cfgs()
    a = transformer.init_params(cfg, seed=5)
    monkeypatch.setattr(transformer.os, "cpu_count", lambda: 1)
    b = transformer.init_params(cfg, seed=5)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    m = a.dense_layers.attn
    for w, fan_in in ((m.q_down, 64), (m.q_up, 32), (m.kv_up, 16),
                      (m.wo, 64)):
        assert float(w.detach().std()) == pytest.approx(fan_in ** -0.5,
                                                        rel=0.2)
    assert transformer._slabs("moe_layers.moe.w_up", (2, 3, 4, 5)) == [
        (i, e) for i in range(2) for e in range(3)]
    assert transformer._slabs("dense_layers.attn.wo", (2, 4, 5)) == [0, 1]
    assert transformer._slabs("embed.tok", (256, 64)) is None
    rows = transformer._slabs("embed.tok", (129536, 7168))
    assert rows[0] == slice(0, 2340) and len(rows) == 56


# --- the attention block -------------------------------------------------

@functools.cache
def _jax_block(impl):
    """JAX's ``mla_attention_block`` on a seeded input: the output and
    the gradients of its input and of every leaf for a seeded
    cotangent."""
    jcfg, _ = _cfgs(impl)
    jp, _ = _layer_attn(jcfg)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((BATCH, SEQ, 64)).astype(np.float32)
    cot = rng.standard_normal((BATCH, SEQ, 64)).astype(np.float32)
    pos = jnp.arange(SEQ)

    def f(p, x):
        out = jmla.mla_attention_block(p, x, jcfg, pos)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return x, cot, np.asarray(out), jax.tree.map(np.asarray, gp), \
        np.asarray(gx)


@pytest.mark.parametrize("impl", IMPLS)
def test_mla_block_matches_jax(impl):
    """``mla_attention_block``: the output and the gradients of x and of
    each of the seven leaves against ``jax.grad`` of JAX's (``"flash"``:
    JAX's Pallas kernels in interpret mode at the padded head dim, the
    port's plain versions through ``FlashAttentionFunction``)."""
    jcfg, cfg = _cfgs(impl)
    x, cot, jout, jgp, jgx = _jax_block(impl)
    _, p = _layer_attn(jcfg)
    p = {k: v.requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = mla.mla_attention_block(p, tx, cfg, torch.arange(SEQ))
    _close_to_largest(out, jout, TOL, "block output")
    (out * torch.from_numpy(cot)).sum().backward()
    _close_to_largest(tx.grad, jgx, GRAD_TOL, "dx")
    for k in ATTN:
        _close_to_largest(p[k].grad, jgp[k], GRAD_TOL, f"d{k}")


def test_flash_pads_v_to_the_qk_width(monkeypatch):
    """The flash path hands the kernels one head dim (nope + rope) for q,
    k and v, v's last columns zeros, G = 1 over all H heads; the output's
    padded columns are zeros."""
    seen = {}
    real = fa.flash_fwd

    def spy(q, k, v, **kw):
        seen.update(q=q.shape, k=k.shape, v=v.clone())
        o, lse = real(q, k, v, **kw)
        seen["o"] = o
        return o, lse

    monkeypatch.setattr(fa, "flash_fwd", spy)
    jcfg, cfg = _cfgs("flash")
    x, *_ = _jax_block("flash")
    _, p = _layer_attn(jcfg)
    mla.mla_attention_block(p, torch.from_numpy(x), cfg, torch.arange(SEQ))
    assert seen["q"] == (BATCH, SEQ, 4, 1, 24)
    assert seen["k"] == (BATCH, SEQ, 4, 24) == seen["v"].shape
    assert not seen["v"][..., 16:].any() and seen["v"][..., :16].any()
    assert not seen["o"][..., 16:].any()


# --- decode -----------------------------------------------------------------

@functools.cache
def _jax_decode(absorb, laid_out=True):
    """JAX's ``mla_attention_decode`` over DECODE_STEPS positions of a
    seeded input from a zero fp32 cache: each step's output, and the
    cache after the last.  The absorbed branch takes the weights in its
    own layout of ``kv_up`` (``_absorb_layout``) unless not ``laid_out``."""
    jcfg, _ = _cfgs()
    jp, _ = _layer_attn(jcfg)
    if absorb and laid_out:
        jp = _absorb_layout(jcfg, jp)
    x = np.random.default_rng(32).standard_normal(
        (BATCH, DECODE_STEPS, 64)).astype(np.float32)
    cache = jmla.mla_init_cache(jcfg, BATCH, DECODE_STEPS + 2, jnp.float32)
    outs = []
    for t in range(DECODE_STEPS):
        o, cache = jmla.mla_attention_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                             jcfg, cache, t, absorb=absorb)
        outs.append(np.asarray(o))
    return x, outs, jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("absorb", [False, True], ids=["plain", "absorbed"])
def test_mla_decode_matches_jax(absorb):
    """``mla_attention_decode`` at every position 0..7 against JAX's (the
    plain branch re-expanding the cache, the absorbed one in the latent
    space, JAX's on ``kv_up`` in its own layout): each step's output and
    the cache written in place."""
    jcfg, cfg = _cfgs()
    x, jouts, jcache = _jax_decode(absorb)
    _, p = _layer_attn(jcfg)
    cache = mla.mla_init_cache(cfg, BATCH, DECODE_STEPS + 2, torch.float32)
    for t in range(DECODE_STEPS):
        o = mla.mla_attention_decode(p, torch.from_numpy(x[:, t:t + 1]), cfg,
                                     cache, t, absorb=absorb)
        assert o.shape == (BATCH, 1, 64)
        _close_to_largest(o, jouts[t], TOL, f"output at {t}")
    for k in ("c_kv", "k_rope"):
        _close_to_largest(cache[k], jcache[k], TOL, k)
        assert not cache[k][:, DECODE_STEPS:].any()


def test_jax_absorbed_decode_reads_kv_up_in_another_layout():
    """The reference's fault, pinned: on the same weights JAX's absorbed
    decode is another function than its plain decode (it reads ``kv_up``'s
    first H * nope columns as every head's key), far past any rounding;
    on ``kv_up`` laid out as it reads it, the same function within TOL.
    The port's absorbed decode reads the forward's layout (the test
    above and the next)."""
    _, plain, _ = _jax_decode(False)
    _, absorbed, _ = _jax_decode(True, laid_out=False)
    _, laid_out, _ = _jax_decode(True)
    scale = np.abs(np.concatenate(plain, 1)).max()
    gap = np.abs(np.concatenate(absorbed, 1) - np.concatenate(plain, 1)).max()
    assert gap > 0.1 * scale
    _close_to_largest(np.concatenate(laid_out, 1), np.concatenate(plain, 1),
                      TOL, "JAX absorbed on its layout vs plain")


def test_absorbed_decode_equals_plain():
    """The two branches on the same cache and token agree within TOL of
    the largest output: the same attention, ``kv_up`` applied before or
    after the sums."""
    jcfg, cfg = _cfgs()
    x, *_ = _jax_decode(False)
    _, p = _layer_attn(jcfg)
    outs = {}
    for absorb in (False, True):
        cache = mla.mla_init_cache(cfg, BATCH, DECODE_STEPS, torch.float32)
        outs[absorb] = [mla.mla_attention_decode(
            p, torch.from_numpy(x[:, t:t + 1]), cfg, cache, t, absorb=absorb)
            for t in range(DECODE_STEPS)]
    _close_to_largest(torch.cat(outs[True], 1), torch.cat(outs[False], 1),
                      TOL, "absorbed vs plain")


# --- the model ------------------------------------------------------------

@functools.cache
def _jax_forward(impl):
    """JAX's logits, aux, loss (total and NLL) and gradients on batch 11,
    and the MoE layer's selection, computed once."""
    jcfg, cfg = _cfgs(impl)
    jp = _jp(jcfg)
    _, jb = _batch(cfg)
    logits, aux = jax.jit(lambda p, t: jtransformer.forward(p, jcfg, t))(
        jp, jb["tokens"])
    (loss, jaux), grads = jax.jit(jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True))(jp, jb)
    return dict(logits=np.asarray(logits), aux=float(aux), loss=float(loss),
                nll=float(jaux["nll"]),
                grads=convert.params_from_jax(jax.tree.map(np.asarray,
                                                           grads)))


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_aux_and_loss_match_jax(impl):
    """The fp32 logits, the load-balance loss, the total loss and its NLL
    against JAX's ``forward`` and ``lm_loss`` (a flipped selection would
    move the logits by an expert's share, far past TOL); the last
    position's logits (the fused prefill's)."""
    jcfg, cfg = _cfgs(impl)
    ref = _jax_forward(impl)
    tb, _ = _batch(cfg)
    model = _model(cfg, _params(jcfg))
    logits, aux = model(tb["tokens"])
    assert logits.shape == (BATCH, SEQ, 256) and logits.dtype == torch.float32
    _close_to_largest(logits, ref["logits"], TOL, "logits")
    np.testing.assert_allclose(aux.item(), ref["aux"], rtol=ROUTE_TOL)
    loss, parts = losses.make_loss_fn(cfg)(model, tb)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(parts["nll"].item(), ref["nll"], rtol=1e-5)
    last, _ = model(tb["tokens"], last_only=True)
    _close_to_largest(last, ref["logits"][:, -1:], TOL, "last")


@pytest.mark.parametrize("impl", IMPLS)
def test_grads_match_jax(impl):
    """Every gradient leaf of the total loss (the seven MLA leaves of each
    stack among them) against ``jax.value_and_grad`` of JAX's;
    ``router_bias``'s zeros on both sides; the global norm."""
    jcfg, cfg = _cfgs(impl)
    ref = _jax_forward(impl)
    tb, _ = _batch(cfg)
    model = _model(cfg, _params(jcfg))
    loss, _ = losses.make_loss_fn(cfg)(model, tb)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, param_grads(loss, params)))
    want = ref["grads"]
    assert set(grads) == set(want) and len(want) == N_LEAVES
    for k, g in want.items():
        if k.endswith("router_bias"):
            assert not np.asarray(g).any() and not grads[k].any()
            continue
        _close_to_largest(grads[k], g, GRAD_TOL, k)
    for k in ATTN:
        assert grads[f"moe_layers.attn.{k}"].abs().max() > 0, k
    norm = np.sqrt(sum(float((g.double() ** 2).sum())
                       for g in grads.values()))
    jnorm = np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                        for g in want.values()))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-5)


def test_remat_matches_no_remat(monkeypatch):
    """Recomputing each layer in the backward gives the same loss and
    gradients, bitwise; the flash forward runs once more a layer: 2 x 2
    forward and 2 backward calls with remat, each at the padded head dim
    24."""
    jcfg, cfg = _cfgs("flash")
    calls = {"fwd": [], "bwd": 0}
    real_fwd, real_bwd = fa.flash_fwd, fa.flash_bwd

    def fwd(q, *a, **k):
        calls["fwd"].append(q.shape[-1])
        return real_fwd(q, *a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd", fwd)
    monkeypatch.setattr(fa, "flash_bwd", bwd)
    tb, _ = _batch(cfg, seed=13)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = _model(c, _params(jcfg))
        calls.update(fwd=[], bwd=0)
        loss, _ = losses.make_loss_fn(c)(model, tb)
        loss.backward()
        out[remat] = (loss.item(), len(calls["fwd"]), calls["bwd"],
                      {k: p.grad for k, p in model.named_parameters()})
        assert set(calls["fwd"]) == {24}
    assert out[False][1:3] == (2, 2) and out[True][1:3] == (4, 2)
    assert out[True][0] == out[False][0]
    for k, g in out[False][3].items():
        if g is None:
            assert out[True][3][k] is None, k
            continue
        assert torch.equal(out[True][3][k], g), k


# --- serving -----------------------------------------------------------------

def test_cache_layout_is_the_jax_packages():
    """``make_cache``: the compressed cache a layer stack, ``"dense"`` and
    ``"moe"`` each ``{"c_kv": (1, B, Tmax, 16), "k_rope": (1, B, Tmax,
    8)}``, as JAX's ``init_cache``; the launcher's cache takes the model's
    dtype (bf16 for the published config) where JAX's launcher builds
    fp32."""
    jcfg, cfg = _cfgs()
    cache = serve_step.make_cache(cfg, BATCH, 20, dtype=torch.float32)
    jcache = jserve_step.make_cache(jcfg, BATCH, 20, dtype=jnp.float32)
    assert set(cache) == set(jcache) == {"dense", "moe"}
    for stack in cache:
        assert set(cache[stack]) == set(jcache[stack]) == {"c_kv", "k_rope"}
        for k, w in (("c_kv", 16), ("k_rope", 8)):
            assert tuple(cache[stack][k].shape) == jcache[stack][k].shape == (
                1, BATCH, 20, w)
    assert serve.lm_cache_dtype(configs.get(ARCH)) == torch.bfloat16
    assert serve.lm_cache_dtype(cfg) == torch.float32


@pytest.mark.parametrize("absorb", [False, True], ids=["plain", "absorbed"])
def test_decode_matches_jax_and_the_forward(absorb):
    """Teacher-forced ``make_serve_step(cfg, absorb=)`` from JAX's fp32
    cache against JAX's jitted ``make_serve_step(jcfg, absorb=)`` (the
    absorbed one on ``kv_up`` in its own layout): logits, next tokens and
    the cache after every step, the MoE layer's selection at every
    position; then the decode against the port's own forward (the fused
    prefill's logits at every position)."""
    jcfg, cfg = _cfgs()
    jp = _jp(jcfg)
    if absorb:
        jp = _absorb_layout(jcfg, jp)
    tb, jb = _batch(cfg, seed=16, seq=DECODE_STEPS)
    model = _model(cfg, _params(jcfg))
    jcache = jserve_step.make_cache(jcfg, BATCH, DECODE_STEPS,
                                    dtype=jnp.float32)
    cache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache))
    jserve = jax.jit(jserve_step.make_serve_step(jcfg, absorb=absorb))
    pserve = serve_step.make_serve_step(cfg, absorb=absorb)
    logits = []
    model.routing = decoded = moe.RoutingLog()
    for t in range(DECODE_STEPS):
        jnxt, jcache, jlogits = jserve(jp, jcache, jb["tokens"][:, t:t + 1],
                                       jnp.int32(t))
        pnxt, cache, plogits = pserve(model, cache,
                                      tb["tokens"][:, t:t + 1], t)
        _close_to_largest(plogits, jlogits, TOL, f"logits at step {t}")
        np.testing.assert_array_equal(pnxt.numpy(), np.asarray(jnxt))
        logits.append(plogits[:, 0])
    for stack in ("dense", "moe"):
        for k in ("c_kv", "k_rope"):
            _close_to_largest(cache[stack][k], jcache[stack][k], TOL,
                              f"cache {stack}.{k}")
    model.routing = forward = moe.RoutingLog()
    with torch.inference_mode():
        full, _ = model(tb["tokens"])
    model.routing = None
    r = moe.compare_routing(forward, decoded)
    assert r["total_flips"] == 0
    assert r["min_margin"] >= MARGIN_OVER_DIFF * r["max_score_diff"], r
    _close_to_largest(torch.stack(logits, 1), full, TOL, "decode vs forward")
    with pytest.raises(ValueError, match="past the cache"):
        transformer.decode_step(model, cache, tb["tokens"][:, :1],
                                DECODE_STEPS)


def test_bf16_model_with_an_fp32_cache_matches_jax():
    """JAX's launcher builds an fp32 cache for a bf16 model; the MLA decode
    takes it (the expansion promotes to fp32, the output is cast back to
    bf16 before ``wo``), on both sides: the port's logits within
    BF16_TOL of JAX's over 4 steps, its cache staying fp32."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp = jax.tree.map(jnp.asarray, _params(jcfg))
    tb, jb = _batch(cfg, seed=17, seq=4)
    model = _model(cfg, _params(jcfg))
    jcache = jserve_step.make_cache(jcfg, BATCH, 4, dtype=jnp.float32)
    cache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache))
    jserve = jax.jit(jserve_step.make_serve_step(jcfg))
    pserve = serve_step.make_serve_step(cfg)
    for t in range(4):
        _, jcache, jlogits = jserve(jp, jcache, jb["tokens"][:, t:t + 1],
                                    jnp.int32(t))
        _, cache, plogits = pserve(model, cache, tb["tokens"][:, t:t + 1], t)
        _close_to_largest(plogits, jlogits, BF16_TOL, f"logits at {t}")
    assert cache["moe"]["c_kv"].dtype == torch.float32


def test_launcher_serves_deepseek_on_cpu(capsys):
    """``--smoke``: the fused prefill held to the sequential decode with the
    decode's selection replayed, and its own selection compared: no flip
    in fp32."""
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--batch", "2", "--prompt-len", "8", "--gen",
                       "8"]) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "logits finite" in out
    assert "the decode's expert selection replayed" in out
    assert "flips {1: 0}" in out


def test_launcher_trains_deepseek_on_cpu(capsys):
    summary = train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--attn-impl", "flash", "--steps", "3", "--batch",
                         "2", "--seq", "16"])
    assert summary["arch"] == ARCH + "-smoke"
    assert summary["attn_impl"] == "flash"
    assert len(summary["losses"]) == 3
    assert np.isfinite(summary["losses"]).all()
    assert all(n < t for n, t in zip(summary["nlls"], summary["losses"]))
    assert "attn_impl=flash" in capsys.readouterr().out


def test_convert_round_trip():
    """JAX's MLA tree (numpy, bf16) -> the port's state dict -> numpy:
    every leaf bitwise."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    tree = _init(jcfg, 3)
    model = models.init_model(cfg)
    model.load_state_dict(convert.params_from_jax(tree))
    back = {k: p.float().numpy() for k, p in model.state_dict().items()}
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(back[key], a.astype(np.float32), key)
    assert model.moe_layers.attn.kv_up.dtype == torch.bfloat16
