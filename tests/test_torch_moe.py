"""The port's MoE family (``repro_torch``: Moonlight's config, the router,
both expert dispatches, the model with its dense and MoE stacks, the
load-balance loss in the total, the streamed cross-entropy, decode, the
fused prefill, both launchers, ``convert`` and the roofline's counts)
against the JAX package, on the CPU.

The reduced Moonlight-16B-A3B config (one dense layer of d_ff 128, then
one MoE layer of 8 experts of d_ff 32, top-2 by sigmoid scores with
routed scaling 2.446, and 2 shared experts as one MLP of 64; d_model 64,
4 heads over 2 KV heads of 16, vocab 256, fp32) runs with the JAX
package's initial weights, every norm scale and ``router_bias`` made
random (their init values, ones and zeros, would leave those paths
untested), through both packages on the same token batches, for both
``attn_impl`` values.  The JAX side runs its Pallas flash kernels in
interpret mode; the port's flash wrappers compute their plain versions
on CPU tensors.  Each JAX reference is computed once a module
(``functools.cache``).

Routing is discontinuous, so every comparison through an MoE layer
checks the selection first: the selected experts equal as sets on both
sides, with the smallest selection margin (k-th minus (k+1)-th score)
at least ``MARGIN_OVER_DIFF`` (100) times the largest selection-score
difference between the two sides, so no rounding could have flipped one.

Tolerances: routing weights and the load-balance loss within 1e-6
(fp32, one product of width 64); logits, hidden states and MoE outputs
within 1e-5 of their largest value and losses within rtol 1e-5 (fp32,
sums in another order); each gradient within ``GRAD_TOL`` (1e-5) of its
leaf's largest value, ``router_bias``'s exactly zero on both sides (it
steers the selection only); the streamed cross-entropy within 1e-6 of
the full one (the same sums, chunked).  Over three AdamW steps (lr 1e-3)
the losses within rtol 1e-5, the gradient norms within ``GNORM_RTOL``
(5e-4, JAX's jitted metric) and the parameters within 1e-5, except that
AdamW's first steps are sign-like, so at most ``FLIP_FRAC`` (1e-4) of
the elements may step by up to ``2 * lr`` the other way.
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
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.roofline import flops as jflops
from repro.train import losses as jlosses
from repro.train import serve_step as jserve_step
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert, models
from repro_torch.configs.base import NOT_PORTED, reduced
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, train
from repro_torch.models import common, moe, transformer
from repro_torch.roofline import flops
from repro_torch.train import losses, serve_step
from repro_torch.train.data_parallel import param_grads
from repro_torch.train.train_step import make_train_step

ARCH = "moonshot-v1-16b-a3b"
IMPLS = ("chunked", "flash")
BATCH, SEQ = 2, 64
TOL, GRAD_TOL, ROUTE_TOL = 1e-5, 1e-5, 1e-6
GNORM_RTOL, LR, FLIP_FRAC = 5e-4, 1e-3, 1e-4
MARGIN_OVER_DIFF = 100.0
DECODE_STEPS = 10
N_LEAVES = 26


def _cfgs(impl="chunked", **kw):
    return (dataclasses.replace(jreduced(jconfigs.get(ARCH)), attn_impl=impl,
                                **kw),
            dataclasses.replace(reduced(configs.get(ARCH)), attn_impl=impl,
                                **kw))


@functools.cache
def _params(jcfg, seed=0):
    """The JAX package's initial parameters with every norm scale and
    ``router_bias`` made random, as numpy."""
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 3)
    base = {"scale": 1.0, "router_bias": 0.0}

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
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _check_selection(experts, scores, jexperts, jscores, what):
    """The same experts selected on both sides (as sets, row by row), and
    every row's margin beyond any rounding the sides differ by."""
    experts, jexperts = np.asarray(experts), np.asarray(jexperts)
    scores, jscores = _np(scores), _np(jscores)
    np.testing.assert_array_equal(np.sort(experts, -1), np.sort(jexperts, -1),
                                  err_msg=what)
    k = experts.shape[-1]
    top = -np.sort(-scores, -1)
    margin = float((top[..., k - 1] - top[..., k]).min())
    diff = float(np.abs(scores - jscores).max())
    assert margin >= MARGIN_OVER_DIFF * diff, (what, margin, diff)
    return margin, diff


def _moe_input(jp, jcfg, tokens):
    """JAX's hidden state entering the MoE layer's FFN (its ``mlp_norm``
    output), by the JAX package's own layer functions."""
    x = jcm.embed_tokens(jp["embed"], tokens, jcfg)
    pos = jnp.arange(tokens.shape[1])
    x, _ = jtransformer._layer_fwd(
        jax.tree.map(lambda a: a[0], jp["dense_layers"]), x, jcfg, pos,
        moe_layer=False)
    lp = jax.tree.map(lambda a: a[0], jp["moe_layers"])
    x = x + jcm.attention_block(lp["attn"],
                                jcm.apply_norm(lp["attn_norm"], x, jcfg),
                                jcfg, pos)
    return jcm.apply_norm(lp["mlp_norm"], x, jcfg), lp["moe"]


@functools.cache
def _jax_forward(impl):
    """JAX's logits, aux, loss (total and NLL), gradients and the MoE
    layer's selection on batch 11, computed once."""
    jcfg, _ = _cfgs(impl)
    jp = _jp(jcfg)
    _, jb = _batch(_cfgs(impl)[1])
    logits, aux = jtransformer.forward(jp, jcfg, jb["tokens"])
    (loss, jaux), grads = jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True)(jp, jb)
    h, p = _moe_input(jp, jcfg, jb["tokens"])
    h2d = h.reshape(BATCH * SEQ, -1)
    w, idx, _ = jmoe.route(p, h2d, jcfg)
    sel = jax.nn.sigmoid(h2d.astype(jnp.float32) @ p["router"]) \
        + p["router_bias"]
    return dict(logits=np.asarray(logits), aux=float(aux), loss=float(loss),
                nll=float(jaux["nll"]),
                grads=convert.params_from_jax(jax.tree.map(np.asarray,
                                                           grads)),
                experts=np.asarray(idx).reshape(BATCH, SEQ, -1),
                scores=np.asarray(sel).reshape(BATCH, SEQ, -1))


# --- config, counts, parameters --------------------------------------------

FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab_size", "qk_norm", "qkv_bias",
          "attn_out_bias", "rope_theta", "norm", "norm_eps", "mlp_act",
          "mlp_bias", "tie_embeddings", "pos_embedding", "max_position",
          "dtype", "remat", "remat_policy", "attn_chunk", "xent_chunk",
          "attn_impl", "padded_vocab", "source")


@pytest.mark.parametrize("which", ["published", "reduced"])
def test_config_is_the_jax_packages(which):
    jcfg, cfg = jconfigs.get(ARCH), configs.get(ARCH)
    if which == "reduced":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
        assert cfg.name == jcfg.name == ARCH + "-smoke"
        assert (cfg.n_layers, cfg.moe.n_experts, cfg.moe.top_k,
                cfg.moe.d_ff_expert, cfg.moe.first_dense_layers,
                cfg.moe.d_ff_dense) == (2, 8, 2, 32, 1, 128)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), (which, f)
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)


def test_published_counts_are_the_jax_packages():
    """28.39 B parameters, 4.80 B a token uses (JAX's counts: no norms,
    no ``router_bias``); the model's leaves hold the norms and biases
    beyond them; the 6-layer cut that trains on one card 3.70 B; the
    useful flops of a step of each kind equal JAX's."""
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    assert flops.param_count(cfg) == jflops.param_count(jcfg) == 28386394112
    assert flops.active_param_count(cfg) == jflops.active_param_count(
        jcfg) == 4804444160
    cut = dataclasses.replace(cfg, n_layers=6)
    assert flops.param_count(cut) == pytest.approx(3.70e9, rel=2e-3)
    spec = transformer._leaf_spec(cfg)
    leaves = sum(int(np.prod(s)) for s, *_ in spec.values())
    D, E = cfg.d_model, cfg.moe.n_experts
    assert leaves - flops.param_count(cfg) == (2 * 48 + 1) * D + 47 * E
    for kind, T, B in (("train", 4096, 4), ("prefill", 200, 8),
                       ("decode", 232, 8)):
        shape = flops.StepShape(kind, T, B)
        assert flops.model_flops(cfg, shape) == jflops.model_flops(
            jcfg, shape), kind
    # a decode step's bound: the active weights (the batch's embedding
    # rows only) and the K/V of 48 layers
    shape = flops.StepShape("decode", 232, 8)
    kv = 2 * 8 * 232 * 16 * 2 * 128 * 48
    assert flops.decode_cache_bytes(cfg, 8, 232) == kv
    assert flops.hbm_bytes_decode(cfg, shape) == (
        2 * flops.active_param_count(cfg) - 2 * (163840 - 8) * D + kv)


def test_other_families_stay_refused():
    assert ARCH not in NOT_PORTED
    for arch in ("deepseek-v3-671b", "internvl2-2b"):
        assert arch in NOT_PORTED
        with pytest.raises(NotImplementedError, match="queue A"):
            configs.get(arch)
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="queue A"):
        models.get_model(dataclasses.replace(cfg, family="vlm"))
    assert models.get_model(cfg) is transformer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_is_the_jax_tree(dtype):
    """Keys, shapes and dtypes are the JAX tree's: the ``dense_layers``
    stack with its ``d_ff_dense`` MLP, the ``moe_layers`` stack with the
    router and ``router_bias`` in fp32 whatever the model's dtype, the
    experts (L, E, ...) and the shared experts' MLP; AdamW's ``ndim >=
    2`` rule decays the same leaves in both packages."""
    jcfg, cfg = _cfgs(dtype=dtype)
    model = transformer.init_params(cfg, seed=1)
    want = convert.params_from_jax(jax.tree.map(
        np.asarray, jtransformer.init_params(jax.random.key(0), jcfg)))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == N_LEAVES
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert got["moe_layers.moe.router"].dtype == torch.float32
    assert got["moe_layers.moe.w_gate"].shape == (1, 8, 64, 32)
    assert got["moe_layers.moe.shared.w_up"].shape == (1, 64, 64)
    assert got["dense_layers.mlp.w_down"].shape == (1, 128, 64)
    assert not got["moe_layers.moe.router_bias"].any()


def test_init_is_seeded_and_independent_of_the_threads(monkeypatch):
    """The same seed gives the same weights, bitwise, whatever the number
    of host threads drawing the stacked leaves' slabs; another seed
    others; the JAX package's scales."""
    _, cfg = _cfgs()
    a = transformer.init_params(cfg, seed=5)
    monkeypatch.setattr(transformer.os, "cpu_count", lambda: 1)
    b = transformer.init_params(cfg, seed=5)
    c = transformer.init_params(cfg, seed=6)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.moe_layers.moe.w_gate, c.moe_layers.moe.w_gate)
    m = a.moe_layers.moe
    for w, fan_in in ((m.router, 64), (m.w_gate, 64), (m.w_down, 32),
                      (m.shared.w_down, 64)):
        assert float(w.detach().std()) == pytest.approx(fan_in ** -0.5,
                                                        rel=0.15)


# --- routing and dispatch ----------------------------------------------------

@pytest.mark.parametrize("score_fn", ["sigmoid", "softmax"])
def test_route_matches_jax(score_fn):
    """The selection (as sets, with its margin), the renormalised and
    scaled weights and the load-balance loss against JAX's ``route``."""
    jcfg, cfg = _cfgs()
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, score_fn=score_fn)) for c in (jcfg, cfg))
    rng = np.random.default_rng(21)
    x = rng.standard_normal((128, 64)).astype(np.float32)
    p = {"router": rng.standard_normal((64, 8)).astype(np.float32) / 8,
         "router_bias": 0.1 * rng.standard_normal(8).astype(np.float32)}
    jw, jidx, jaux = jmoe.route({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jcfg)
    w, idx, aux, sel = moe.route({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x), cfg)
    jlogits = x @ p["router"]
    jsel = (1 / (1 + np.exp(-jlogits)) + p["router_bias"]
            if score_fn == "sigmoid" else
            np.asarray(jax.nn.softmax(jnp.asarray(jlogits), -1)))
    _check_selection(idx, sel, jidx, jsel, score_fn)
    order, jorder = np.argsort(idx.numpy(), -1), np.argsort(jidx, -1)
    np.testing.assert_allclose(np.take_along_axis(w.numpy(), order, -1),
                               np.take_along_axis(np.asarray(jw), jorder, -1),
                               rtol=0, atol=ROUTE_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=ROUTE_TOL)
    if score_fn == "sigmoid":
        np.testing.assert_allclose(w.sum(-1).numpy(), 2.446, rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["dropless", "capacity"])
def test_moe_ffn_matches_jax(dispatch):
    """``moe_ffn`` (routed and shared experts) against JAX's on the same
    input: dropless, and the capacity dispatch at a ``capacity_factor``
    (0.5) under which experts overflow and drop assignments."""
    cf = 0.5 if dispatch == "capacity" else 0.0
    jcfg, cfg = _cfgs()
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in (jcfg, cfg))
    jp = jax.tree.map(lambda a: a[0], _jp(jcfg)["moe_layers"]["moe"])
    p = transformer._nest(*zip(*(
        (k[len("moe_layers.moe."):], t[0]) for k, t in
        convert.params_from_jax(_params(jcfg)).items()
        if k.startswith("moe_layers.moe."))))
    x = np.random.default_rng(22).standard_normal((2, 64, 64)).astype(
        np.float32)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    log = moe.RoutingLog()
    out, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg, routing=log)
    _, jidx, _ = jmoe.route(jp, jnp.asarray(x).reshape(128, 64), jcfg)
    jsel = jax.nn.sigmoid(jnp.asarray(x).reshape(128, 64) @ jp["router"]) \
        + jp["router_bias"]
    experts, scores = log.selection(0)
    _check_selection(experts.reshape(128, 2), scores.reshape(128, 8), jidx,
                     jsel, dispatch)
    _close_to_largest(out, jout, TOL, dispatch)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=ROUTE_TOL)
    if cf:
        counts = np.bincount(np.asarray(jidx).ravel(), minlength=8)
        assert moe.capacity(cfg, 128) == 16 and counts.max() > 16


def test_combine_sums_in_ascending_expert_order():
    """The combine adds each token's k weighted outputs one after another
    in ascending expert id in the outputs' dtype (bf16 here): bitwise a
    loop in that order, not the selection's order."""
    rng = np.random.default_rng(23)
    n, k, D = 40, 6, 16
    o = torch.from_numpy(rng.standard_normal((n * k, D))).to(torch.bfloat16)
    w = torch.from_numpy(rng.random((n, k)).astype(np.float32))
    idx = torch.stack([torch.randperm(64, generator=torch.Generator(
    ).manual_seed(i))[:k] for i in range(n)])
    row_of = torch.arange(n * k).view(n, k)
    got = moe._combine(o, row_of, w, idx)
    for i in range(n):
        want = torch.zeros(D, dtype=torch.bfloat16)
        for j in idx[i].argsort().tolist():
            want = want + o[row_of[i, j]] * w[i, j].to(torch.bfloat16)
        assert torch.equal(got[i], want), i


# --- the model -----------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_logits_aux_and_loss_match_jax(impl):
    """The MoE layer's selection, the fp32 logits, the summed load-balance
    loss, the total ``nll + AUX_WEIGHT * aux`` and its NLL, the hidden
    state and the last position's logits against JAX's ``forward`` and
    ``lm_loss``."""
    jcfg, cfg = _cfgs(impl)
    ref = _jax_forward(impl)
    tb, jb = _batch(cfg)
    model = _model(cfg, _params(jcfg))
    model.routing = moe.RoutingLog()
    logits, aux = model(tb["tokens"])
    model.routing, log = None, model.routing
    assert log.layers() == [1]
    _check_selection(*log.selection(1), ref["experts"], ref["scores"], impl)
    assert logits.shape == (BATCH, SEQ, 256) and logits.dtype == torch.float32
    _close_to_largest(logits, ref["logits"], TOL, "logits")
    np.testing.assert_allclose(aux.item(), ref["aux"], rtol=ROUTE_TOL)
    loss, parts = losses.make_loss_fn(cfg)(model, tb)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(parts["nll"].item(), ref["nll"], rtol=1e-5)
    np.testing.assert_allclose(
        loss.item(), parts["nll"].item() + losses.AUX_WEIGHT * aux.item(),
        rtol=1e-6)
    jhidden, _ = jtransformer.forward(_jp(jcfg), jcfg, jb["tokens"],
                                      hidden_only=True)
    _close_to_largest(model(tb["tokens"], hidden_only=True)[0], jhidden, TOL,
                      "hidden")
    last, _ = model(tb["tokens"], last_only=True)
    assert last.shape == (BATCH, 1, 256)
    _close_to_largest(last, ref["logits"][:, -1:], TOL, "last")


@pytest.mark.parametrize("impl", IMPLS)
def test_grads_match_jax(impl):
    """Every gradient leaf of the total loss against ``jax.value_and_grad``
    of JAX's, the router's (through the weights and the load-balance
    loss) and the experts' among them; ``router_bias``'s a tensor of
    zeros on both sides; the global norm."""
    jcfg, cfg = _cfgs(impl)
    ref = _jax_forward(impl)
    tb, _ = _batch(cfg)
    model = _model(cfg, _params(jcfg))
    loss, _ = losses.make_loss_fn(cfg)(model, tb)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, param_grads(loss, params)))
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    want = ref["grads"]
    assert set(grads) == set(want) and len(want) == N_LEAVES
    for k, g in want.items():
        if k == "moe_layers.moe.router_bias":
            assert not np.asarray(g).any()
            assert isinstance(grads[k], torch.Tensor)
            assert torch.equal(grads[k], torch.zeros(1, 8))
            continue
        _close_to_largest(grads[k], g, GRAD_TOL, k)
    assert grads["moe_layers.moe.router"].abs().max() > 0
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    jnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in want.values()))
    np.testing.assert_allclose(norm, jnorm, rtol=GNORM_RTOL)


def test_remat_matches_no_remat(monkeypatch):
    """Recomputing each layer in the backward gives the same loss and
    gradients, bitwise, and the same selection; the flash forward runs
    once more a layer: 2 x 2 forward and 2 backward calls with remat."""
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
        model.routing = moe.RoutingLog()
        calls.update(fwd=0, bwd=0)
        loss, _ = losses.make_loss_fn(c)(model, tb)
        loss.backward()
        out[remat] = (loss.item(), dict(calls),
                      {k: p.grad for k, p in model.named_parameters()},
                      model.routing)
    assert out[False][1] == {"fwd": 2, "bwd": 2}
    assert out[True][1] == {"fwd": 4, "bwd": 2}
    assert out[True][0] == out[False][0]
    assert moe.compare_routing(out[False][3], out[True][3])[
        "total_flips"] == 0
    for k, g in out[False][2].items():
        if g is None:  # router_bias: the loss does not read it
            assert out[True][2][k] is None, k
            continue
        assert torch.equal(out[True][2][k], g), k


def test_train_steps_match_jax():
    """Three steps of ``make_train_step`` from ``train_state_from_jax`` on
    the same batches as JAX's jitted ``make_train_step``: losses (the
    total; the port's metrics give the NLL apart), gradient norms,
    learning rates, parameters."""
    jcfg, cfg = _cfgs()
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
        assert m["nll"].item() < m["loss"].item()  # the aux is positive
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=GNORM_RTOL)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    beyond = total = 0
    for k, p in state.params.named_parameters():
        diff = (p.detach() - want[k]).abs()
        assert diff.max().item() <= 2 * steps * LR, k
        beyond += int((diff > 1e-5).sum())
        total += diff.numel()
    assert beyond <= FLIP_FRAC * total, (beyond, total)


# --- the streamed cross-entropy -------------------------------------------------

def test_streamed_xent_matches_jax_and_the_full_logits():
    """``streamed_xent`` over chunks of 16 against JAX's on the same hidden
    state, and against the port's ``softmax_xent`` of the full logits
    (value and the gradients to the hidden state and the unembedding);
    through ``make_loss_fn`` with ``xent_chunk`` against JAX's
    ``lm_loss``; a T that no chunk divides takes the full logits."""
    jcfg, cfg = _cfgs(xent_chunk=16)
    jp = _jp(jcfg)
    tb, jb = _batch(cfg, seed=14)
    model = _model(cfg, _params(jcfg))
    hidden = np.random.default_rng(24).standard_normal(
        (BATCH, SEQ, 64)).astype(np.float32)
    want = float(jlosses.streamed_xent(jp, jnp.asarray(hidden), jb["labels"],
                                       jcfg))
    h = torch.from_numpy(hidden).requires_grad_()
    got = losses.streamed_xent(model, h, tb["labels"], cfg)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    g_h, g_u = torch.autograd.grad(got, (h, model.unembed))
    h2 = torch.from_numpy(hidden).requires_grad_()
    full = losses.softmax_xent(
        common.logits_from_hidden(model.embed.tok, model.unembed,
                                          h2, cfg), tb["labels"])
    np.testing.assert_allclose(got.item(), full.item(), rtol=1e-6)
    f_h, f_u = torch.autograd.grad(full, (h2, model.unembed))
    _close_to_largest(g_h, f_h, 1e-6, "d hidden")
    _close_to_largest(g_u, f_u, 1e-6, "d unembed")
    (jloss, jaux), _ = jax.value_and_grad(jlosses.make_loss_fn(jcfg),
                                          has_aux=True)(jp, jb)
    loss, aux = losses.make_loss_fn(cfg)(model, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["nll"].item(), float(jaux["nll"]),
                               rtol=1e-5)
    odd = losses.streamed_xent(model, h[:, :40], tb["labels"][:, :40], cfg)
    np.testing.assert_allclose(odd.item(), float(jlosses.streamed_xent(
        jp, jnp.asarray(hidden[:, :40]), jb["labels"][:, :40], jcfg)),
        rtol=1e-6)


# --- serving -----------------------------------------------------------------

def test_cache_layout_is_the_jax_packages():
    """``make_cache``: one K/V stack a layer stack, ``"dense"`` (1 layer)
    and ``"moe"`` (1), as JAX's ``init_cache``."""
    jcfg, cfg = _cfgs()
    cache = serve_step.make_cache(cfg, BATCH, 20, dtype=torch.float32)
    jcache = jserve_step.make_cache(jcfg, BATCH, 20, dtype=jnp.float32)
    assert set(cache) == set(jcache) == {"dense", "moe"}
    for stack in cache:
        for k in ("k", "v"):
            assert tuple(cache[stack][k].shape) == jcache[stack][k].shape == (
                1, BATCH, 20, 2, 16)


def test_decode_matches_jax_and_the_forward():
    """Teacher-forced decode steps from JAX's fp32 cache against JAX's
    jitted serve step: logits, next tokens and the cache after every
    step, with the MoE layer's selection at every position; then the
    port's decode against its own forward."""
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
    model.routing = decoded = moe.RoutingLog()
    for t in range(DECODE_STEPS):
        jnxt, jcache, jlogits = jserve(jp, jcache, jb["tokens"][:, t:t + 1],
                                       jnp.int32(t))
        pnxt, cache, plogits = pserve(model, cache,
                                      tb["tokens"][:, t:t + 1], t)
        _close_to_largest(plogits, jlogits, TOL, f"logits at step {t}")
        np.testing.assert_array_equal(pnxt.numpy(), np.asarray(jnxt))
        for stack in ("dense", "moe"):
            for k in ("k", "v"):
                _close_to_largest(cache[stack][k], jcache[stack][k], TOL,
                                  f"cache {stack}.{k} at {t}")
        logits.append(plogits[:, 0])
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


def test_routing_replay_forces_the_selection():
    """A log made with ``replay`` makes each MoE layer take the replayed
    selection at the same positions: a forward replaying another batch's
    selection records that selection, not its own top-k."""
    _, cfg = _cfgs()
    model = models.init_model(cfg, seed=2)
    tokens = [_batch(cfg, seed=s, seq=16)[0]["tokens"] for s in (30, 31)]
    logs = []
    with torch.inference_mode():
        for t in tokens:
            model.routing = moe.RoutingLog()
            model(t)
            logs.append(model.routing)
        model.routing = moe.RoutingLog(replay=logs[0])
        model(tokens[1])
        replayed, model.routing = model.routing, None
    assert moe.compare_routing(logs[0], logs[1])["total_flips"] > 0
    assert torch.equal(replayed.selection(1)[0], logs[0].selection(1)[0])


def test_launcher_serves_moonlight_on_cpu(capsys):
    """``--smoke``: the fused prefill held to the sequential decode with
    the decode's selection replayed, and its own selection compared: no
    flip in fp32."""
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--batch", "2", "--prompt-len", "8", "--gen",
                       "8"]) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "logits finite" in out
    assert "the decode's expert selection replayed" in out
    assert "flips {1: 0}" in out


def test_launcher_trains_moonlight_on_cpu(capsys):
    summary = train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--attn-impl", "flash", "--steps", "3", "--batch",
                         "2", "--seq", "16"])
    assert summary["arch"] == ARCH + "-smoke"
    assert summary["attn_impl"] == "flash"
    assert len(summary["losses"]) == len(summary["nlls"]) == 3
    assert np.isfinite(summary["losses"]).all()
    assert all(n < t for n, t in zip(summary["nlls"], summary["losses"]))
    assert summary["skipped_steps"] == 0
    out = capsys.readouterr().out
    assert "attn_impl=flash" in out and " nll " in out


def test_convert_round_trip():
    """JAX's MoE tree (numpy) -> the port's state dict -> numpy: every
    leaf bitwise, the fp32 router kept fp32 in a bf16 model."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(3), jcfg))
    model = models.init_model(cfg)
    model.load_state_dict(convert.params_from_jax(tree))
    flat = convert.params_from_jax(tree)
    for k, p in model.state_dict().items():
        assert p.dtype == flat[k].dtype and torch.equal(p, flat[k]), k
    assert model.moe_layers.moe.router.dtype == torch.float32
    assert model.moe_layers.moe.w_gate.dtype == torch.bfloat16
    back = {k: p.float().numpy() for k, p in model.state_dict().items()}
    for (path, a) in jax.tree_util.tree_leaves_with_path(tree):
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(back[key], a.astype(np.float32), key)
