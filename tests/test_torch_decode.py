"""The port's language-model serving path (``repro_torch``: Mamba2's and
the dense transformer's decode, ``common.attention_decode``, the serve,
cache and prefill steps, ``convert.cache_from_jax``,
``ops.depthwise_conv1d_streaming`` and the launcher's LM branch) against
the JAX package, on the CPU.

The reduced Mamba2-370M, StarCoder2-3B and Qwen3-8B configs (2 layers,
d_model 64, vocab 256, fp32) run with the JAX package's initial weights,
every norm, bias, qk_norm, ``D``, ``gate_norm`` and conv bias made random
(their init values, ones and zeros, would leave those paths untested),
loaded through ``convert.params_from_jax``.  The JAX side runs its jitted
``make_serve_step`` and ``make_prefill_step``; its prefill runs the
Pallas depthwise conv (``REPRO_CONV_BACKEND=pallas``) and, with
``attn_impl="flash"``, the Pallas flash kernel, both in interpret mode.

Prompts of 40 tokens are not a multiple of the SSD chunk (16), so the
chunked scan's padding runs.  JAX's flash kernel needs the sequence to
be a multiple of its query tile ``min(attn_chunk, T)`` (64 in the
reduced configs): at 40 it takes the whole prompt as one tile, while a
prompt longer than 64 and not a multiple of it fails in JAX.

Tolerances (fp32): logits within 1e-5 of the largest logit (``TOL``:
the same products summed in another order), every cache leaf within
1e-5 of its largest value, next tokens equal.  The port's decode against
its own teacher-forced forward: within ``SELF_TOL`` (1e-5) of the largest
logit, where the JAX package's own test allows 2e-2.  bf16 (model and
cache): each logit within one bf16 ulp of its value (2^-7) plus 2^-7 of
the largest (``BF16_RTOL``, ``BF16_ATOL``: both sides round fp32 sums
taken in another order to bf16 at every projection, two layers deep),
and tokens equal wherever the top-2 margin exceeds that.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.models import get_model as jget_model
from repro.train import serve_step as jserve_step
from repro_torch import configs, convert, models
from repro_torch.configs.base import reduced
from repro_torch.kernels import flash_attention, ops
from repro_torch.launch import serve
from repro_torch.models import mamba2, transformer
from repro_torch.train import serve_step

ARCHS = ("mamba2-370m", "starcoder2-3b", "qwen3-8b")
BATCH, PROMPT, STEPS = 2, 40, 8
TOL, SELF_TOL = 1e-5, 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -7
# the leaves made random, and the value their noise is centred on
JITTER = {"scale": 1.0, "bias": 0.0, "q_norm": 1.0, "k_norm": 1.0,
          "bq": 0.0, "bk": 0.0, "bv": 0.0, "bo": 0.0, "b_up": 0.0,
          "b_down": 0.0, "conv_b": 0.0, "D": 1.0, "gate_norm": 1.0}


def _cfgs(arch, **kw):
    return (dataclasses.replace(jreduced(jconfigs.get(arch)), **kw),
            dataclasses.replace(reduced(configs.get(arch)), **kw))


def _jax_params(jcfg, seed=0):
    """The JAX package's initial parameters, ``JITTER``'s leaves made
    random, as numpy."""
    tree = jax.tree.map(np.asarray, jget_model(jcfg).init_params(
        jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 3)

    def jitter(path, a):
        base = JITTER.get(path[-1].key)
        if base is None:
            return a
        noise = 0.1 * rng.standard_normal(a.shape)
        return (base + noise).astype(np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(jitter, tree)


def _model(cfg, jparams):
    model = models.init_model(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    return model


def _prompt(cfg, seed=1, batch=BATCH, length=PROMPT):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)


def _close_to_largest(got, want, rel, what):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float32)
    finite = want > -1e29  # the padded vocabulary's NEG_INF columns
    scale = max(float(np.abs(np.where(finite, want, 0)).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _np(t):
    return t.detach().float().numpy()


def _leaves(tree, prefix=""):
    """``(path, leaf)`` of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _jax_serve(jcfg):
    return jax.jit(jserve_step.make_serve_step(jcfg))


def _run_both(jcfg, cfg, jparams, model, jcache, cache, tokens, start,
              steps):
    """``steps`` decode steps on both sides from position ``start``: the
    first ``tokens.shape[1]`` fed from ``tokens``, the rest greedy, each
    side feeding its own next tokens; logits, tokens and every cache leaf
    held after every step."""
    jserve = _jax_serve(jcfg)
    pserve = serve_step.make_serve_step(cfg)
    jt = pt = None
    for i in range(steps):
        pos = start + i
        if i < tokens.shape[1]:
            jt = jnp.asarray(tokens[:, i:i + 1])
            pt = torch.from_numpy(tokens[:, i:i + 1])
        jnxt, jcache, jlogits = jserve(jparams, jcache, jt, jnp.int32(pos))
        pnxt, cache, plogits = pserve(model, cache, pt, pos)
        _close_to_largest(plogits, np.asarray(jlogits), TOL,
                          f"logits at step {i}")
        np.testing.assert_array_equal(pnxt.numpy(), np.asarray(jnxt),
                                      err_msg=f"tokens at step {i}")
        jleaves = dict(_leaves(jax.tree.map(np.asarray, jcache)))
        for path, leaf in _leaves(cache):
            _close_to_largest(leaf, jleaves[path], TOL,
                              f"cache {path} at step {i}")
        jt, pt = jnxt, pnxt


# --- decode against JAX's serve step -------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_serve_step(arch):
    """Eight steps from an empty fp32 cache: three prompt tokens, then
    greedy; logits, next tokens and every cache leaf after every step."""
    jcfg, cfg = _cfgs(arch)
    jparams = _jax_params(jcfg)
    model = _model(cfg, jparams)
    jcache = jserve_step.make_cache(jcfg, BATCH, STEPS, dtype=jnp.float32)
    cache = serve_step.make_cache(cfg, BATCH, STEPS, dtype=torch.float32)
    _run_both(jcfg, cfg, jparams, model, jcache, cache,
              _prompt(cfg, length=3), 0, STEPS)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_decode_from_a_jax_cache(arch):
    """Both packages continue from one mid-stream cache: JAX's after five
    steps, converted by ``cache_from_jax``."""
    jcfg, cfg = _cfgs(arch)
    jparams = _jax_params(jcfg)
    model = _model(cfg, jparams)
    jserve = _jax_serve(jcfg)
    jcache = jserve_step.make_cache(jcfg, BATCH, 12, dtype=jnp.float32)
    toks = _prompt(cfg, seed=5, length=9)
    for t in range(5):
        _, jcache, _ = jserve(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
    cache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache))
    for path, leaf in _leaves(cache):
        want = np.asarray(dict(_leaves(jcache))[path])
        assert leaf.shape == want.shape and leaf.dtype == torch.float32, path
        np.testing.assert_array_equal(leaf.numpy(), want)
    _run_both(jcfg, cfg, jparams, model, jcache, cache, toks[:, 5:], 5, 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_its_own_forward(arch):
    """The port's decode logits at every position against its own
    teacher-forced forward over the whole sequence."""
    _, cfg = _cfgs(arch)
    model = _model(cfg, _jax_params(_cfgs(arch)[0]))
    toks = torch.from_numpy(_prompt(cfg, seed=2, length=12))
    with torch.inference_mode():
        full = models.get_model(cfg).forward(model, toks)
    cache = serve_step.make_cache(cfg, BATCH, 12, dtype=torch.float32)
    step = serve_step.make_serve_step(cfg)
    for t in range(12):
        _, cache, logits = step(model, cache, toks[:, t:t + 1], t)
        _close_to_largest(logits[:, 0], _np(full[:, t]), SELF_TOL,
                          f"position {t}")


def test_cache_layouts_are_the_jax_packages_and_layers_do_not_alias():
    for arch in ARCHS[:2]:
        jcfg, cfg = _cfgs(arch)
        jcache = jserve_step.make_cache(jcfg, 3, 10, dtype=jnp.float32)
        cache = serve_step.make_cache(cfg, 3, 10, dtype=torch.float32)
        jleaves = dict(_leaves(jcache))
        assert set(jleaves) == {p for p, _ in _leaves(cache)}, arch
        for path, leaf in _leaves(cache):
            assert tuple(leaf.shape) == jleaves[path].shape, (arch, path)
            assert leaf.dtype == torch.float32
            leaf[0].fill_(1.0)  # one layer written in place
            assert not leaf[1:].any(), (arch, path)
    # Mamba2's recurrent state stays fp32 in a bf16 cache, as JAX's decode
    # returns it from its first step on
    c = mamba2.init_cache(_cfgs("mamba2-370m")[1], 2, dtype=torch.bfloat16)
    assert c["conv"].dtype == torch.bfloat16
    assert c["ssm"].dtype == torch.float32


# --- the fused prefill step ---------------------------------------------------

@pytest.mark.parametrize("arch,impl", [("mamba2-370m", None),
                                       ("starcoder2-3b", "flash"),
                                       ("starcoder2-3b", "chunked"),
                                       ("qwen3-8b", "flash")])
def test_prefill_step_matches_jax(arch, impl, monkeypatch):
    """``make_prefill_step`` against JAX's (its Pallas kernels in interpret
    mode) on a 40-token prompt, and against the port's own sequential
    decode at the prompt's last position."""
    kw = {} if impl is None else {"attn_impl": impl}
    jcfg, cfg = _cfgs(arch, **kw)
    jparams = _jax_params(jcfg)
    model = _model(cfg, jparams)
    toks = _prompt(cfg, seed=4)
    monkeypatch.setenv("REPRO_CONV_BACKEND", "pallas")
    jnxt, jlogits = jax.jit(jserve_step.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    calls = {"dw": 0, "flash": 0}

    def counted(name, real):
        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(ops, "depthwise_conv1d",
                        counted("dw", ops.depthwise_conv1d))
    monkeypatch.setattr(flash_attention, "flash_fwd",
                        counted("flash", flash_attention.flash_fwd))
    pnxt, plogits = serve_step.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(toks)})
    assert plogits.shape == (BATCH, 1, cfg.padded_vocab)
    _close_to_largest(plogits, np.asarray(jlogits), TOL, "prefill logits")
    np.testing.assert_array_equal(pnxt.numpy(), np.asarray(jnxt))
    L = cfg.n_layers
    assert calls == {"dw": L if cfg.family == "ssm" else 0,
                     "flash": L if impl == "flash" else 0}
    # the port's sequential decode over the same prompt
    cache = serve_step.make_cache(cfg, BATCH, PROMPT, dtype=torch.float32)
    step = serve_step.make_serve_step(cfg)
    for t in range(PROMPT):
        _, cache, logits = step(model, cache, torch.from_numpy(
            toks[:, t:t + 1]), t)
    gap = serve.prefill_gap(model, cfg, torch.from_numpy(toks), logits)
    assert gap["gap"] <= gap["tol"] == serve.PREFILL_TOL_F32, gap
    assert gap["tokens_equal"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "starcoder2-3b"])
def test_inference_runs_each_layer_once_under_remat(arch, monkeypatch):
    """With ``cfg.remat`` (as Mamba2-370M and StarCoder2-3B set it), the
    serve and prefill steps run each layer once: no checkpoint wrapper is
    entered where autograd records nothing."""
    jcfg, cfg = _cfgs(arch, remat=True)
    model = _model(cfg, _jax_params(jcfg))
    mod = mamba2 if cfg.family == "ssm" else transformer
    name = "block_fwd" if cfg.family == "ssm" else "_layer_fwd"
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or
                        real(*a, **k))
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: pytest.fail("checkpoint entered"))
    toks = torch.from_numpy(_prompt(cfg, length=20))
    serve_step.make_prefill_step(cfg)(model, {"tokens": toks})
    assert len(calls) == cfg.n_layers


# --- bf16 and the reference's fp32-cache fault ---------------------------------

@pytest.mark.parametrize("arch", ["mamba2-370m", "starcoder2-3b"])
def test_bf16_decode_matches_jax(arch):
    """bf16 weights and a bf16 cache (``make_cache``'s default), eight
    steps against JAX: logits element by element within one bf16 ulp plus
    ``BF16_ATOL`` of the largest; tokens where the margin is clear."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    jparams = _jax_params(jcfg)
    model = _model(cfg, jparams)
    assert next(model.parameters()).dtype == torch.bfloat16
    jcache = jserve_step.make_cache(jcfg, BATCH, STEPS)
    cache = serve_step.make_cache(cfg, BATCH, STEPS)
    jserve = _jax_serve(jcfg)
    pserve = serve_step.make_serve_step(cfg)
    toks = _prompt(cfg, seed=6, length=STEPS)
    for t in range(STEPS):
        _, jcache, jlogits = jserve(jparams, jcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t))
        _, cache, plogits = pserve(model, cache,
                                   torch.from_numpy(toks[:, t:t + 1]), t)
        want = np.asarray(jlogits)[:, 0, :cfg.vocab_size]
        got = _np(plogits)[:, 0, :cfg.vocab_size]
        atol = BF16_ATOL * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol,
                                   err_msg=f"step {t}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * (atol + BF16_RTOL
                                              * np.abs(want).max())
        same = got.argmax(-1) == want.argmax(-1)
        assert (same | ~clear).all(), f"step {t}"


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-8b"])
def test_jax_cannot_decode_bf16_dense_with_an_fp32_cache(arch):
    """The reference's fault: with an fp32 KV cache its bf16 attention
    output turns fp32 and ``lax.scan`` refuses the layer carry; the port's
    launcher therefore serves bf16 dense models with a cache of the
    model's dtype (which JAX runs, ``test_bf16_decode_matches_jax``), and
    the SSM family and fp32 configs with an fp32 one, as JAX's launcher."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    jparams = jget_model(jcfg).init_params(jax.random.key(0), jcfg)
    jcache = jserve_step.make_cache(jcfg, 1, 4, dtype=jnp.float32)
    with pytest.raises(TypeError, match="carry"):
        _jax_serve(jcfg)(jparams, jcache, jnp.zeros((1, 1), jnp.int32),
                         jnp.int32(0))
    assert serve.lm_cache_dtype(cfg) == torch.bfloat16
    assert serve.lm_cache_dtype(configs.get(arch)) == torch.bfloat16
    assert serve.lm_cache_dtype(_cfgs(arch)[1]) == torch.float32
    assert serve.lm_cache_dtype(configs.get("mamba2-370m")) == torch.float32


def test_moe_decode_raises():
    """Every transformer family decodes: the MoE family
    (``tests/test_torch_moe.py``), with MLA attention
    (``tests/test_torch_mla.py``), and the VLM, whose decode is the dense
    one over text tokens (the same cache, the same logits bitwise on the
    same weights); a family the transformer does not build raises."""
    _, cfg = _cfgs("starcoder2-3b")
    vlm = dataclasses.replace(cfg, family="vlm", n_image_tokens=8)
    dense, model = transformer.init_params(cfg, seed=2), \
        transformer.init_params(vlm, seed=2)
    tokens = torch.from_numpy(np.arange(6, dtype=np.int32).reshape(2, 3))
    caches = [transformer.init_cache(c, 2, 4, torch.float32)
              for c in (cfg, vlm)]
    assert all(tuple(c["dense"]["k"].shape) == (2, 2, 4, 2, 16)
               for c in caches)
    with torch.inference_mode():
        for t in range(3):
            want, _ = transformer.decode_step(dense, caches[0],
                                              tokens[:, t:t + 1], t)
            got, _ = transformer.decode_step(model, caches[1],
                                             tokens[:, t:t + 1], t)
            assert torch.equal(got, want), t
    conv = dataclasses.replace(cfg, family="conv")
    with pytest.raises(ValueError, match="not 'conv'"):
        transformer.init_cache(conv, 1, 8)
    with pytest.raises(ValueError, match="not 'conv'"):
        transformer.decode_step(
            type("M", (), {"cfg": conv})(), None, None, 0)
    assert configs.get("internvl2-2b").n_image_tokens == 256
    assert configs.get("deepseek-v3-671b").mla is not None


# --- depthwise_conv1d_streaming -------------------------------------------------

SCHEDULES = {"ones": [1] * 6, "threes": [3] * 4,
             "ragged": [1, 1, 5, 3, 11, 2, 7]}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("dtype,out_dtype", [("float32", None),
                                             ("bfloat16", "float32"),
                                             ("bfloat16", None)])
@pytest.mark.parametrize("dilation", [1, 2])
def test_depthwise_streaming_matches_jax(schedule, dtype, out_dtype,
                                         dilation):
    """Chunk by chunk from a fresh state (bias and silu): each chunk's
    outputs against JAX's ``depthwise_conv1d_streaming`` (its Pallas
    kernel in interpret mode) and the carried state bitwise; the whole
    stream against the port's one-shot causal call."""
    rng = np.random.default_rng(dilation)
    N, C, S = 2, 16, 4
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jout = None if out_dtype is None else jnp.dtype(out_dtype)
    tout = None if out_dtype is None else getattr(torch, out_dtype)
    widths = SCHEDULES[schedule]
    x = rng.standard_normal((N, C, sum(widths))).astype(np.float32)
    w = (0.5 * rng.standard_normal((S, C))).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a, jdt) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a).to(tdt) for a in (x, w, b))
    jstate = jops.conv_stream_state(N, C, S, dilation, jdt)
    state = ops.conv_stream_state(N, C, S, dilation, tdt)
    outs, lo = [], 0
    for width in widths:
        sl = slice(lo, lo + width)
        jy, jstate = jops.depthwise_conv1d_streaming(
            jx[:, :, sl], jw, state=jstate, bias=jb, activation="silu",
            dilation=dilation, backend="pallas", out_dtype=jout)
        y, state = ops.depthwise_conv1d_streaming(
            tx[:, :, sl], tw, state=state, bias=tb, activation="silu",
            dilation=dilation, out_dtype=tout)
        assert y.dtype == (tout or tdt) and state.is_contiguous()
        rel = TOL if y.dtype == torch.float32 else BF16_RTOL
        _close_to_largest(y, np.asarray(jy, np.float32), rel,
                          f"chunk at {lo}")
        np.testing.assert_array_equal(_np(state),
                                      np.asarray(jstate, np.float32))
        outs.append(y)
        lo += width
    whole = ops.depthwise_conv1d(tx, tw, bias=tb, activation="silu",
                                 dilation=dilation, padding="CAUSAL",
                                 out_dtype=tout)
    _close_to_largest(torch.cat(outs, dim=-1), _np(whole),
                      TOL if whole.dtype == torch.float32 else BF16_RTOL,
                      "stream vs one shot")


def test_depthwise_streaming_refuses_a_wrong_state():
    w = torch.ones(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ops.depthwise_conv1d_streaming(torch.ones(2, 8, 5), w,
                                       state=torch.zeros(2, 8, 2))
    with pytest.raises(ValueError, match="dtype"):
        ops.depthwise_conv1d_streaming(
            torch.ones(2, 8, 5), w,
            state=torch.zeros(2, 8, 3, dtype=torch.bfloat16))


# --- the launcher ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-370m", "starcoder2-3b"])
def test_serve_lm_matches_the_jax_launchers_loop(arch):
    """``serve_lm`` on JAX's weights against the JAX launcher's loop
    (sequential prefill through the jitted serve step from an fp32 cache,
    then greedy): the same seeded prompt, the decode's logits at the
    prompt's end, and every generated token."""
    jcfg, cfg = _cfgs(arch)
    jparams = _jax_params(jcfg)
    model = _model(cfg, jparams)
    args = serve.parse_args(["--arch", arch, "--device", "cpu", "--batch",
                             "3", "--prompt-len", "6", "--gen", "7",
                             "--seed", "5"])
    stats = serve.serve_lm(args, cfg, model=model)
    # the JAX launcher's loop (repro/launch/serve.py)
    jserve = _jax_serve(jcfg)
    cache = jserve_step.make_cache(jcfg, 3, 13, dtype=jnp.float32)
    prompt = jnp.asarray(np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 6)), jnp.int32)
    np.testing.assert_array_equal(stats["prompt"].numpy(),
                                  np.asarray(prompt))
    for t in range(6):
        nxt, cache, logits = jserve(jparams, cache, prompt[:, t:t + 1],
                                    jnp.int32(t))
    _close_to_largest(stats["prompt_logits"], np.asarray(logits), TOL,
                      "logits at the prompt's end")
    out = [nxt]
    for t in range(6, 12):
        nxt, cache, logits = jserve(jparams, cache, nxt, jnp.int32(t))
        out.append(nxt)
    np.testing.assert_array_equal(
        stats["tokens"], np.asarray(jnp.concatenate(out, axis=1)))
    assert stats["steps"] == 6 and stats["cache_dtype"] == "torch.float32"


@pytest.mark.parametrize("arch", ["mamba2-370m", "starcoder2-3b"])
def test_launcher_serves_an_lm_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--smoke",
                       "--batch", "2", "--prompt-len", "8", "--gen",
                       "8"]) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "p99" in out and "logits finite" in out
    assert "smoke: fused prefill == sequential decode" in out


def test_launcher_lm_default_device_and_model_parallel_raise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-370m", "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--gen", "8"])
    # tensor-parallel serving needs its ranks: a world of one refuses
    with pytest.raises(ValueError, match="model axis needs 2 ranks"):
        serve.main(["--arch", "starcoder2-3b", "--device", "cpu",
                    "--smoke", "--model-parallel", "2"])
