"""The port's VLM (InternVL2-2B: the dense transformer behind image
embeddings; ``configs``, ``data.synthetic.vlm_batch``, the transformer's
``extra_embeds``, the text-only loss, the fused prefill with patches, the
train step, checkpoints, both launchers, ``convert`` and the roofline's
counts) and the ``"dots"`` remat policy against the JAX package, on the
CPU.

The reduced InternVL2-2B (JAX's ``reduced``: 2 layers, d_model 64, 4
heads over 2 KV heads of 16, d_ff 128, vocab 256, 8 image tokens, fp32)
runs with the JAX package's initial weights, every norm scale made
random, on batches made with numpy from a seed (``SEQ`` 64 positions: 8
image embeddings, then 56 text tokens), for both ``attn_impl`` values.
The JAX side runs its Pallas flash kernels in interpret mode; the port's
flash wrappers compute their plain versions on CPU tensors.  Each JAX
reference is computed once a module (``functools.cache``).

Tolerances (fp32, sums in another order): logits within ``TOL`` (1e-5)
of their largest value, losses within rtol 1e-5, every gradient within
``GRAD_TOL`` (1e-5) of its leaf's largest value.  Over four AdamW steps
(lr 1e-3): the losses within rtol 1e-5, the gradient norms within
``GNORM_RTOL`` (5e-4: JAX's jitted metric is that far from the float64
norm of its own gradients, ``tests/test_torch_mamba2.py``) and the
parameters within 1e-5, up to ``FLIP_FRAC`` of the elements, which may
step by up to 2 x lr the other way (AdamW's first steps are sign-like).
The ``"dots"`` policy is bitwise the port's ``"nothing"`` and no remat
(the same ops on the same inputs), and holds JAX's ``"dots"`` at the
tolerances above, at the reduced VLM and the reduced Mamba2-370M.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import reduced as jreduced
from repro.data import synthetic as jsynthetic
from repro.models import mamba2 as jmamba2
from repro.models import transformer as jtransformer
from repro.roofline import flops as jflops
from repro.train import losses as jlosses
from repro.train import serve_step as jserve_step
from repro.train import train_step as jtrain_step
from repro_torch import configs, convert, models
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import reduced
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, train
from repro_torch.models import transformer
from repro_torch.roofline import flops
from repro_torch.train import losses, serve_step
from repro_torch.train.data_parallel import param_grads
from repro_torch.train.train_step import init_state, make_train_step

ARCH = "internvl2-2b"
IMPLS = ("chunked", "flash")
BATCH, SEQ, N_IMG = 2, 64, 8
TOL, GRAD_TOL = 1e-5, 1e-5
LR, FLIP_FRAC, GNORM_RTOL = 1e-3, 1e-4, 5e-4
N_LEAVES = 12


def _cfgs(arch=ARCH, impl="chunked", **kw):
    return (dataclasses.replace(jreduced(jconfigs.get(arch)), attn_impl=impl,
                                **kw),
            dataclasses.replace(reduced(configs.get(arch)), attn_impl=impl,
                                **kw))


@functools.cache
def _init(jcfg, seed=0):
    """The JAX package's initial parameters (jitted), as numpy; the
    attention implementation and remat do not change them."""
    base = dataclasses.replace(jcfg, attn_impl="chunked", remat=False,
                               remat_policy="nothing")
    if base != jcfg:
        return _init(base, seed)
    mod = jmamba2 if jcfg.family == "ssm" else jtransformer
    return jax.tree.map(np.asarray, jax.jit(
        mod.init_params, static_argnums=1)(jax.random.key(seed), jcfg))


@functools.cache
def _params(jcfg, seed=0):
    """``_init``'s parameters with every norm scale (and Mamba2's conv
    bias and D) made random, as numpy."""
    rng = np.random.default_rng(seed + 3)
    base = {"scale": 1.0, "gate_norm": 1.0, "D": 1.0, "conv_b": 0.0}

    def jitter(path, a):
        name = path[-1].key
        if name not in base:
            return a
        return (base[name] + 0.1 * rng.standard_normal(a.shape)).astype(
            a.dtype)

    return jax.tree_util.tree_map_with_path(jitter, _init(jcfg, seed))


def _model(cfg, jcfg):
    model = models.init_model(cfg)
    model.load_state_dict(convert.params_from_jax(_params(jcfg)))
    return model


def _batch(cfg, seed=11, batch=BATCH, seq=SEQ):
    """One numpy batch as the port's tensors and JAX's arrays."""
    b = synthetic.make_batch(cfg, batch, seq, seed=seed)
    return ({k: torch.as_tensor(v) for k, v in b.items()},
            {k: jnp.asarray(np.asarray(v.float() if torch.is_tensor(v)
                                       else v)) for k, v in b.items()})


def _close_to_largest(got, want, rel, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale, err_msg=what)


# --- config, data, counts, parameters ----------------------------------------

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab_size", "padded_vocab", "qk_norm",
          "qkv_bias", "rope_theta", "norm", "norm_eps", "mlp_act",
          "tie_embeddings", "pos_embedding", "max_position",
          "n_image_tokens", "dtype", "remat", "remat_policy", "attn_chunk",
          "attn_impl", "xent_chunk", "source")


@pytest.mark.parametrize("which", ["published", "reduced"])
def test_config_is_the_jax_packages(which):
    jcfg, cfg = jconfigs.get(ARCH), configs.get(ARCH)
    if which == "reduced":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), (which, f)
    assert cfg.n_image_tokens == (256 if which == "published" else N_IMG)


@pytest.mark.parametrize("which", ["published", "reduced"])
def test_vlm_batch_is_bitwise_the_jax_packages(which):
    """Tokens, labels and the image embeddings from one seed, bitwise
    (the bf16 cast of the published config's patches too); ``seq`` counts
    the image positions, and a ``seq`` that leaves no text raises."""
    jcfg, cfg = jconfigs.get(ARCH), configs.get(ARCH)
    if which == "reduced":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    seq = cfg.n_image_tokens + 40
    got = synthetic.make_batch(cfg, 2, seq, seed=7)
    want = jsynthetic.make_batch(jcfg, 2, seq, seed=7)
    assert set(got) == set(want) == {"tokens", "labels", "patches"}
    for k in ("tokens", "labels"):
        assert got[k].dtype == np.int32 and got[k].shape == (2, 40)
        np.testing.assert_array_equal(got[k], want[k])
    p = got["patches"]
    assert p.dtype == getattr(torch, cfg.dtype)
    assert tuple(p.shape) == want["patches"].shape == (
        2, cfg.n_image_tokens, cfg.d_model)
    np.testing.assert_array_equal(p.float().numpy(),
                                  want["patches"].astype(np.float32))
    with pytest.raises(ValueError, match="leaves no text"):
        synthetic.make_batch(cfg, 1, cfg.n_image_tokens, seed=0)


def test_published_counts_are_the_jax_packages():
    """1.889 B parameters (JAX's count); the useful flops of a train,
    prefill and decode step equal JAX's (a train step at 4 x 4,096:
    2.055e14); the decode's bytes are JAX's less the untied table's rows
    the batch does not read."""
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    assert flops.param_count(cfg) == jflops.param_count(jcfg)
    assert flops.param_count(cfg) == pytest.approx(1.889e9, rel=1e-3)
    assert flops.active_param_count(cfg) == flops.param_count(cfg)
    for kind, T, B in (("train", 4096, 4), ("prefill", 456, 8),
                       ("decode", 232, 8)):
        shape = flops.StepShape(kind, T, B)
        assert flops.model_flops(cfg, shape) == jflops.model_flops(
            jcfg, shape), kind
    assert flops.model_flops(cfg, flops.StepShape(
        "train", 4096, 4)) == pytest.approx(2.055e14, rel=1e-3)
    shape = flops.StepShape("decode", 232, 8)
    kv = 2 * 8 * 232 * 8 * 2 * 128 * 24
    assert flops.decode_cache_bytes(cfg, 8, 232) == kv
    assert flops.hbm_bytes_decode(cfg, shape) == (
        jflops.hbm_bytes_decode(jcfg, shape) - 2 * (92553 - 8) * 2048)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_is_the_jax_tree(dtype):
    """Keys, shapes and dtypes are the JAX tree's: the dense model's, its
    unembedding untied; the image embeddings are an input, no leaf."""
    jcfg, cfg = _cfgs(dtype=dtype)
    model = transformer.init_params(cfg, seed=1)
    want = convert.params_from_jax(_init(jcfg))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and len(want) == N_LEAVES
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert got["unembed"].shape == (64, 256)


def test_convert_round_trip():
    """JAX's VLM tree (numpy, bf16) -> the port's state dict -> numpy:
    every leaf bitwise."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    tree = _init(jcfg, 3)
    model = models.init_model(cfg)
    model.load_state_dict(convert.params_from_jax(tree))
    back = {k: p.float().numpy() for k, p in model.state_dict().items()}
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(back[key], a.astype(np.float32), key)


# --- the model -------------------------------------------------------------

@functools.cache
def _jax_forward(impl):
    """JAX's logits over the image and text positions, its loss and every
    gradient on batch 11, and its fused prefill's next tokens and last
    logits, computed once."""
    jcfg, cfg = _cfgs(impl=impl)
    jp = jax.tree.map(jnp.asarray, _params(jcfg))
    _, jb = _batch(cfg)
    logits, _ = jax.jit(lambda p, t, e: jtransformer.forward(
        p, jcfg, t, extra_embeds=e))(jp, jb["tokens"], jb["patches"])
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True))(jp, jb)
    nxt, last = jax.jit(jserve_step.make_prefill_step(jcfg))(jp, jb)
    return dict(logits=np.asarray(logits), loss=float(loss),
                nll=float(aux["nll"]), next=np.asarray(nxt),
                last=np.asarray(last),
                grads=convert.params_from_jax(jax.tree.map(np.asarray,
                                                           grads)))


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_and_loss_match_jax(impl):
    """The fp32 logits of every position (the image positions' first)
    against JAX's ``forward(extra_embeds=)``; the loss and its NLL over
    the text positions against JAX's ``vlm_loss``."""
    jcfg, cfg = _cfgs(impl=impl)
    ref = _jax_forward(impl)
    tb, _ = _batch(cfg)
    model = _model(cfg, jcfg)
    logits = model(tb["tokens"], extra_embeds=tb["patches"])
    assert logits.shape == (BATCH, SEQ, 256) and logits.dtype == torch.float32
    _close_to_largest(logits, ref["logits"], TOL, "logits")
    loss, parts = losses.make_loss_fn(cfg)(model, tb)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(parts["nll"].item(), ref["nll"], rtol=1e-5)
    assert parts["nll"] is loss


@pytest.mark.parametrize("impl", IMPLS)
def test_grads_match_jax(impl):
    """Every gradient leaf of the text loss against ``jax.value_and_grad``
    of JAX's, and the global norm."""
    jcfg, cfg = _cfgs(impl=impl)
    ref = _jax_forward(impl)
    tb, _ = _batch(cfg)
    model = _model(cfg, jcfg)
    loss, _ = losses.make_loss_fn(cfg)(model, tb)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, param_grads(loss, params)))
    want = ref["grads"]
    assert set(grads) == set(want) and len(want) == N_LEAVES
    for k, g in want.items():
        _close_to_largest(grads[k], g, GRAD_TOL, k)
    norm = np.sqrt(sum(float((g.double() ** 2).sum())
                       for g in grads.values()))
    jnorm = np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                        for g in want.values()))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_fused_prefill_with_patches_matches_jax(impl, monkeypatch):
    """``make_prefill_step`` on a batch with patches against JAX's jitted
    ``make_prefill_step``: the next tokens and the last position's logits,
    one flash launch a layer under ``"flash"``; without patches it is the
    text's prefill, the forward of the tokens alone."""
    calls = []
    real = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda q, *a, **k: calls.append(q.shape[1])
                        or real(q, *a, **k))
    jcfg, cfg = _cfgs(impl=impl)
    ref = _jax_forward(impl)
    tb, _ = _batch(cfg)
    model = _model(cfg, jcfg)
    step = serve_step.make_prefill_step(cfg)
    nxt, last = step(model, tb)
    assert last.shape == (BATCH, 1, 256)
    _close_to_largest(last, ref["last"], TOL, "prefill logits")
    np.testing.assert_array_equal(nxt.numpy(), ref["next"])
    assert calls == ([SEQ] * cfg.n_layers if impl == "flash" else [])
    _, text = step(model, {"tokens": tb["tokens"]})
    with torch.no_grad():
        want = model(tb["tokens"])[:, -1:]
    _close_to_largest(text, want, TOL, "text prefill")


# --- the train step, checkpoints ---------------------------------------------

def test_train_steps_match_jax():
    """Four steps of ``make_train_step`` from the same state on the same
    batches as JAX's jitted ``make_train_step`` (flash: JAX's Pallas
    kernels in interpret mode): losses, gradient norms, learning rates,
    parameters, counters."""
    jcfg, cfg = _cfgs(impl="flash")
    steps = 4
    kw = dict(peak_lr=LR, warmup_steps=2, total_steps=steps)
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, _params(jcfg)))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    for i in range(steps):
        tb, jb = _batch(cfg, seed=100 + i)
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
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    beyond = total = 0
    for k, p in state.params.named_parameters():
        diff = (p.detach() - want[k]).abs()
        assert diff.max().item() <= 2 * steps * LR, k
        beyond += int((diff > 1e-5).sum())
        total += diff.numel()
    assert beyond <= FLIP_FRAC * total, (beyond, total)


def test_checkpoint_jax_writes_port_restores(tmp_path):
    """A JAX ``TrainState`` after 2 steps, saved by JAX's checkpointer,
    restored by the port's: every tensor bitwise the converted state."""
    jcfg, cfg = _cfgs()
    jstate = jtrain_step.init_state(jax.tree.map(jnp.asarray, _params(jcfg)))
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, peak_lr=LR,
                                                warmup_steps=1,
                                                total_steps=4))
    for i in range(2):
        jstate, _ = jstep(jstate, _batch(cfg, seed=i)[1])
    jckpt.Checkpointer(str(tmp_path)).save(jstate, 2)
    state = ckpt.Checkpointer(str(tmp_path)).restore(
        init_state(transformer.init_params(cfg, seed=9)))
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg)
    got_t, want_t = ckpt.state_tensors(state), ckpt.state_tensors(want)
    assert len(got_t) == 3 * N_LEAVES + 2 and set(got_t) == set(want_t)
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype, k
        assert torch.equal(got_t[k], want_t[k]), k


# --- the "dots" remat policy -------------------------------------------------

DOTS_CASES = [("internvl2-2b", "flash"), ("mamba2-370m", "chunked")]


class _CountMM(TorchDispatchMode):
    """Counts the products with no batch dimension that run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, jcfg, tb):
    model = _model(cfg, jcfg)
    with _CountMM() as mm:
        loss, _ = losses.make_loss_fn(cfg)(model, tb)
        names, params = zip(*model.named_parameters())
        grads = param_grads(loss, params)
    return loss, dict(zip(names, grads)), mm.n


@functools.cache
def _jax_dots(arch, impl):
    """JAX's loss and gradients under ``remat_policy="dots"``."""
    jcfg, cfg = _cfgs(arch, impl, remat=True, remat_policy="dots")
    jp = jax.tree.map(jnp.asarray, _params(jcfg))
    _, jb = _batch(cfg, seed=21)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jlosses.make_loss_fn(jcfg), has_aux=True))(jp, jb)
    return float(loss), convert.params_from_jax(
        jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("arch,impl", DOTS_CASES)
def test_dots_is_bitwise_nothing_and_no_remat(arch, impl):
    """The loss and every gradient under ``"dots"`` equal, bitwise, those
    under ``"nothing"`` and without remat; ``"dots"`` runs the products
    with no batch dimension as often as no remat does (each kept, none
    run again), ``"nothing"`` runs each layer's forward ones twice."""
    jcfg, cfg = _cfgs(arch, impl)
    tb, _ = _batch(cfg, seed=21)
    runs = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        runs[remat, policy] = _loss_and_grads(c, jcfg, tb)
    loss, grads, mm = runs[False, "nothing"]
    for key, (l, g, n) in runs.items():
        assert l.item() == loss.item(), key
        for k, v in grads.items():
            assert torch.equal(g[k], v), (key, k)
    assert runs[True, "dots"][2] == mm < runs[True, "nothing"][2]


@pytest.mark.parametrize("arch,impl", DOTS_CASES)
def test_dots_matches_jax_dots(arch, impl):
    """The port's ``"dots"`` against JAX's ``"dots"``
    (``dots_with_no_batch_dims_saveable``): the loss within rtol 1e-5,
    every gradient within GRAD_TOL of its leaf's largest value."""
    jcfg, cfg = _cfgs(arch, impl, remat=True, remat_policy="dots")
    tb, _ = _batch(cfg, seed=21)
    loss, grads, _ = _loss_and_grads(cfg, jcfg, tb)
    jloss, jgrads = _jax_dots(arch, impl)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        _close_to_largest(grads[k], g, GRAD_TOL, k)


# --- launchers ---------------------------------------------------------------


def test_launcher_serves_the_vlm_on_cpu(monkeypatch, capsys):
    """``serve_lm`` decodes text (no kernel in a decode step); under
    ``--smoke`` its fused text prefill is held to the decode, then the
    prompt's fused prefill behind ``vlm_batch``'s image embeddings runs
    once, finite: one flash launch a layer in each prefill."""
    calls = []
    real = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda q, *a, **k: calls.append(q.shape[1])
                        or real(q, *a, **k))
    args = serve.parse_args(["--arch", ARCH, "--device", "cpu", "--smoke",
                             "--batch", "2", "--prompt-len", "8", "--gen",
                             "6"])
    cfg = dataclasses.replace(reduced(configs.get(ARCH)), attn_impl="flash")
    stats = serve.serve_lm(args, cfg)
    assert calls == [8] * cfg.n_layers + [8 + N_IMG] * cfg.n_layers
    assert stats["tokens"].shape == (2, 6)
    assert tuple(stats["patches"].shape) == (2, N_IMG, 64)
    want = synthetic.make_batch(cfg, 2, N_IMG + 8, seed=0)["patches"]
    assert torch.equal(stats["patches"], want)
    assert stats["image_logits"].shape == (2, 1, 256)
    out = capsys.readouterr().out
    assert "smoke: fused prefill == sequential decode" in out
    assert "image embeddings and 8 tokens: logits finite" in out
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--batch", "2", "--prompt-len", "4", "--gen",
                       "3"]) == 0


def test_launcher_trains_the_vlm_on_cpu(monkeypatch, capsys):
    """Three steps on the CPU through ``--attn-impl flash``: losses finite,
    a flash forward and backward a layer a step over the image and text
    positions; tokens/s counts both."""
    calls = {"fwd": [], "bwd": 0}
    real_fwd, real_bwd = fa.flash_fwd, fa.flash_bwd

    def fwd(q, *a, **k):
        calls["fwd"].append(q.shape[1])
        return real_fwd(q, *a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd", fwd)
    monkeypatch.setattr(fa, "flash_bwd", bwd)
    summary = train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--attn-impl", "flash", "--steps", "3", "--batch",
                         "2", "--seq", "16"])
    assert summary["arch"] == ARCH + "-smoke"
    assert len(summary["losses"]) == 3
    assert np.isfinite(summary["losses"]).all()
    assert calls == {"fwd": [16] * 6, "bwd": 6}
    assert summary["tokens_per_s"] == pytest.approx(
        16 * summary["samples_per_s"])
    assert "attn_impl=flash" in capsys.readouterr().out
    with pytest.raises(ValueError, match="leaves no text"):
        train.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                   "1", "--batch", "1", "--seq", str(N_IMG)])


def test_launchers_need_cpu_or_a_card():
    """Without ``--device cpu`` both launchers go to the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                    "--prompt-len", "4", "--gen", "4"])
