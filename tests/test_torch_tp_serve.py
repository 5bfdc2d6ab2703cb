"""Tensor-parallel serving of the port's transformer language models
(``models/sharding.py``'s blocks, ``ModelGroup``'s sums and gather,
``models.local_model``, ``serve --model-parallel``) against the JAX
package's single-device decode and prefill, on the CPU.

Two gloo ranks at (1, 2), spawned once a module (``torch_mp_ranks``:
start method ``spawn``, a file store, no TCP port), serve the reduced
fp32 configs of StarCoder2-3B (every bias non-zero, the tied table,
LayerNorm, GELU), Qwen3-8B (qk-norm, SwiGLU, untied), InternVL2-2B (the
image prefix in the fused prefill), Moonlight (dropless and capacity
dispatch, the shared expert) and DeepSeek-V3 (MLA's plain and absorbed
decode, and MoE) on weights of the JAX tree's shapes drawn with numpy,
every bias and norm random.  Each rank holds its blocks only.  Decode steps
(teacher-forced over the prompt, then greedy) and the fused prefill (the
port's ``attn_impl="flash"`` path: its wrapper's plain version on CPU
tensors, on a rank's heads) are held against JAX's jitted
``make_serve_step`` and ``make_prefill_step`` (``attn_impl="chunked"``)
on the same weights: logits within ``TOL`` (1e-5) of the largest logit
(fp32: the same products, the row-parallel ones summed over two ranks in
another order), greedy tokens equal.  The two ranks' logits, tokens and
expert selections are bitwise equal, and an MoE model's selections are
the one-rank port's.  Each refused layout raises its message.
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import get_model as jget_model
from repro.train import serve_step as jserve_step
from repro_torch import configs, convert
from repro_torch.configs.base import reduced
from repro_torch.launch import serve
from repro_torch.models import moe, sharding, transformer
from repro_torch.train import serve_step

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import torch_mp_ranks as ranks  # noqa: E402

TOL = 1e-5
BATCH, PROMPT, GEN = 2, 8, 4
# case -> (arch, config overrides)
CASES = {
    "starcoder2": ("starcoder2-3b", {}),
    "qwen3": ("qwen3-8b", {}),
    "internvl2": ("internvl2-2b", {}),
    "moonlight": ("moonshot-v1-16b-a3b", {}),
    "moonlight_capacity": ("moonshot-v1-16b-a3b", {"capacity_factor": 1.0}),
    "deepseek": ("deepseek-v3-671b", {}),
}
# the leaves made random, and the value their noise is centred on
JITTER = {"scale": 1.0, "bias": 0.0, "q_norm": 1.0, "k_norm": 1.0,
          "kv_norm": 1.0, "bq": 0.0, "bk": 0.0, "bv": 0.0, "bo": 0.0,
          "b_up": 0.0, "b_down": 0.0, "router_bias": 0.0}
LAUNCHER = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--model-parallel", "2"]


def _cfgs(case):
    arch, moe_kw = CASES[case]
    jcfg, cfg = jreduced(jconfigs.get(arch)), reduced(configs.get(arch))
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_kw))
    return jcfg, dataclasses.replace(cfg, attn_impl="flash")


@functools.cache
def _case(case):
    """Weights of the JAX tree's shapes and dtypes drawn with numpy (a
    matrix normal by fan-in ** -0.5, JITTER's leaves about their value),
    the prompt and a VLM's patches."""
    jcfg, cfg = _cfgs(case)
    tree = jax.eval_shape(lambda k: jget_model(jcfg).init_params(k, jcfg),
                          jax.random.key(0))
    rng = np.random.default_rng(3)

    def draw(path, t):
        base = JITTER.get(path[-1].key)
        a = rng.standard_normal(t.shape)
        if base is not None:
            a = base + 0.1 * a
        elif len(t.shape) > 1:
            a = a * t.shape[-2] ** -0.5
        return a.astype(t.dtype)

    out = dict(cfg=cfg, jparams=jax.tree_util.tree_map_with_path(draw, tree),
               prompt=rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
                   np.int32), gen=GEN)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


@functools.cache
def _ranks():
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return ranks.spawn(2, 2, "job_tp_serve", tmp,
                           cases={c: _case(c) for c in CASES},
                           launchers={"starcoder2": LAUNCHER})


@functools.cache
def _jax(case, absorb=False):
    """JAX's single-device decode over the prompt then ``GEN`` greedy
    steps (each fed its own token), and its fused prefill."""
    jcfg, _ = _cfgs(case)
    c = _case(case)
    p = jax.tree.map(jnp.asarray, c["jparams"])
    step = jax.jit(jserve_step.make_serve_step(jcfg, absorb=absorb))
    cache = jserve_step.make_cache(jcfg, BATCH, PROMPT + GEN,
                                   dtype=jnp.float32)
    logits, tokens = [], []
    tok = jnp.asarray(c["prompt"][:, :1])
    for t in range(PROMPT + GEN):
        if t < PROMPT:
            tok = jnp.asarray(c["prompt"][:, t:t + 1])
        tok, cache, lg = step(p, cache, tok, jnp.int32(t))
        logits.append(np.asarray(lg))
        tokens.append(np.asarray(tok))
    batch = {"tokens": jnp.asarray(c["prompt"])}
    if "patches" in c:
        batch["patches"] = jnp.asarray(c["patches"])
    ptok, plog = jax.jit(jserve_step.make_prefill_step(jcfg))(p, batch)
    return dict(logits=logits, tokens=tokens, prefill=np.asarray(plog),
                prefill_tokens=np.asarray(ptok))


def _close_to_largest(got, want, what):
    want = np.asarray(want, np.float32)
    real = want > -1e29  # the padded vocabulary's NEG_INF columns
    scale = float(np.abs(np.where(real, want, 0)).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _equal_trees(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal_trees(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_jax(case):
    """Each rank's decode logits at every step within TOL of JAX's
    single-device decode, the greedy tokens equal; a step runs 2 sums a
    layer, 1 for the embedding and 1 gather of the logits."""
    want = _jax(case)
    cfg = _case(case)["cfg"]
    for r, res in enumerate(_ranks()):
        got = res[case]["decode"]
        assert got["steps"] == PROMPT + GEN
        for t in range(PROMPT + GEN):
            _close_to_largest(got["logits"][t], want["logits"][t],
                              f"{case} rank {r} step {t}")
            np.testing.assert_array_equal(got["tokens"][t], want["tokens"][t])
        assert got["sums"] == (2 * cfg.n_layers + 1) * got["steps"]
        assert got["gathers"] == got["steps"]


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax(case):
    """The fused prefill on each rank's heads (the flash path) within TOL
    of JAX's, its greedy tokens equal."""
    want = _jax(case)
    for r, res in enumerate(_ranks()):
        got = res[case]["prefill"]
        _close_to_largest(got["logits"], want["prefill"],
                          f"{case} rank {r} prefill")
        np.testing.assert_array_equal(got["tokens"], want["prefill_tokens"])


def test_absorbed_decode_matches_jax_plain():
    """DeepSeek-V3's absorbed decode on a rank's heads within TOL of
    JAX's plain decode (the port's absorbed branch computes the plain
    function; JAX's reads ``kv_up`` in another layout,
    ``tests/test_torch_mla.py``)."""
    want = _jax("deepseek")
    for r, res in enumerate(_ranks()):
        got = res["deepseek"]["absorbed"]
        for t in range(PROMPT):
            _close_to_largest(got["logits"][t], want["logits"][t],
                              f"rank {r} absorbed step {t}")


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree_bitwise(case):
    """The two ranks' logits, tokens and expert selections are bitwise
    equal (every rank takes the same greedy token and routes alike), and
    their weights are different blocks."""
    a, b = (res[case] for res in _ranks())
    for key in ("decode", "absorbed", "prefill"):
        if key in a:
            _equal_trees({k: v for k, v in a[key].items()},
                         {k: v for k, v in b[key].items()}, f"{case}.{key}")
    assert not all(np.array_equal(a["weights"][k], b["weights"][k])
                   for k in a["weights"] if k.endswith("wo"))


@pytest.mark.parametrize("case", [c for c in CASES
                                  if configs.get(CASES[c][0]).moe])
def test_selection_is_one_ranks(case):
    """An MoE model's selections on the ranks are the one-rank port's
    (the replicated router on the same hidden state), in decode and
    prefill."""
    c = _case(case)
    cfg, prompt = c["cfg"], torch.from_numpy(c["prompt"])
    model = transformer.Transformer(cfg, convert.params_from_jax(
        c["jparams"]))
    model.routing = moe.RoutingLog()
    cache = serve_step.make_cache(cfg, BATCH, PROMPT + GEN,
                                  dtype=torch.float32)
    step = serve_step.make_serve_step(cfg)
    tok = prompt[:, :1]
    for t in range(PROMPT + GEN):
        tok = prompt[:, t:t + 1] if t < PROMPT else tok
        tok, cache, _ = step(model, cache, tok, t)
    want = {i: model.routing.selection(i)[0].sort(-1).values.numpy()
            for i in model.routing.layers()}
    got = _ranks()[0][case]["decode"]["selection"]
    assert set(got) == set(want)
    for i in want:
        np.testing.assert_array_equal(np.sort(got[i], -1), want[i])
    model.routing = moe.RoutingLog()
    serve_step.make_prefill_step(cfg)(model, {"tokens": prompt})
    got = _ranks()[0][case]["prefill"]["selection"]
    for i in model.routing.layers():
        np.testing.assert_array_equal(
            np.sort(got[i], -1),
            model.routing.selection(i)[0].sort(-1).values.numpy())


def test_launcher_serves_over_two_ranks():
    """``serve_lm`` with ``--model-parallel 2`` on the started world: both
    ranks return the same tokens and prompt logits, the same as one
    process's; rank 0 alone prints; a rank holds half the weights of
    the tied table, heads and MLP, and KV/2 heads of cache."""
    one = serve.serve_lm(serve.parse_args(LAUNCHER[:-2]),
                         reduced(configs.get("starcoder2-3b")))
    a, b = (res["launchers"]["starcoder2"] for res in _ranks())
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["prompt_logits"], b["prompt_logits"])
    np.testing.assert_array_equal(a["tokens"], one["tokens"])
    _close_to_largest(a["prompt_logits"], one["prompt_logits"].numpy(),
                      "launcher prompt logits")
    assert "model-parallel 2" in a["out"] and a["out"].count("smoke:") == 1
    assert b["out"] == ""
    assert (a["coords"], b["coords"]) == ({"data": 0, "model": 0},
                                          {"data": 0, "model": 1})
    cfg = reduced(configs.get("starcoder2-3b"))
    assert a["collectives"]["sums"] == 2 * cfg.n_layers + 1
    assert a["collectives"]["gathers"] == 1
    assert a["prefill_gap"]["gap"] <= a["prefill_gap"]["tol"]
    full = transformer.init_params(cfg)
    whole = sum(p.numel() * p.element_size() for p in full.parameters())
    assert a["weights_bytes"] < whole
    m = sharding.MeshShape(("data", "model"), (1, 2))
    assert a["weights_bytes"] == sum(
        4 * int(np.prod(sharding.local_shape(p.shape, s, m)))
        for (k, p), s in zip(full.state_dict().items(),
                             sharding.param_pspecs(full, m).values()))
    assert a["cache_bytes"] == 2 * cfg.n_layers * 2 * 12 * (
        cfg.n_kv_heads // 2) * cfg.head_dim * 4


def _args(*extra):
    return serve.parse_args(["--arch", "x", "--device", "cpu",
                             "--model-parallel", *extra])


@pytest.mark.parametrize("arch, mp, over, match", [
    ("starcoder2-3b", 3, {}, "4 heads do not divide over 3"),
    # 2 KV heads over 4 ranks: each on 2 of them, with head-aligned blocks
    # (sharding.head_blocks); the id names the layout's case as it was
    # before those blocks served it
    pytest.param("starcoder2-3b", 4, {}, None,
                 id="starcoder2-3b-4-over1-2 KV heads do not divide over 4"),
    ("starcoder2-3b", 3, {"n_heads": 6, "n_kv_heads": 3},
     "padded vocabulary of 256 does not divide over 3"),
    ("moonshot-v1-16b-a3b", 2, {"n_experts": 5},
     "moe_layers.moe.w_gate: dimension 1"),
    ("mamba2-370m", 32, {}, "16 SSM heads do not divide over 32"),
    ("zamba2-7b", 3, {}, "4 heads do not divide over 3"),
    ("whisper-large-v3", 3, {}, "4 heads do not divide over 3"),
])
def test_refused_layouts_raise(arch, mp, over, match):
    """Each layout with no explicit form raises its message (naming
    ROADMAP.md's item) before any group starts; a case whose ``match``
    is None serves (``tp_refusal`` returns None)."""
    cfg = reduced(configs.get(arch))
    if "n_experts" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **over))
    elif over:
        cfg = dataclasses.replace(cfg, **over)
    if match is None:
        assert serve.tp_refusal(cfg, mp) is None
        assert serve.tp_refusal(cfg, mp, world=2 * mp) is None
        return
    with pytest.raises(ValueError, match=match) as e:
        serve.serve_lm(_args(str(mp)), cfg)
    assert serve.TP_ITEM in str(e.value)


LM_ARCHS = [a for a in configs.names() if configs.get(a).family != "conv"]


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("mp", [2, 4, 8])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_every_language_model_serves_at_powers_of_two(arch, mp, dp):
    """Every language model at full width serves on the (dp, mp) mesh at
    mp 2, 4 and 8: where its heads or KV heads do not divide the model
    axis (StarCoder2-3B at 4 and 8, Qwen2-7B and Whisper-large-v3 at 8)
    through head-aligned blocks.  An odd model axis (3) is still refused,
    naming ROADMAP.md's item."""
    cfg = configs.get(arch)
    assert serve.tp_refusal(cfg, mp, world=dp * mp) is None
    why = serve.tp_refusal(cfg, 3, world=3 * dp)
    assert why is not None and serve.TP_ITEM in why


def test_a_data_axis_is_refused():
    """A world larger than the model axis (the FSDP data axis: JAX's
    serve launcher's (world / mp, mp) mesh) now serves
    (``tests/test_torch_dp_serve.py``); a world that is no multiple of
    the model axis, or smaller than it, is still refused."""
    cfg = reduced(configs.get("starcoder2-3b"))
    assert serve.tp_refusal(cfg, 2, world=4) is None
    assert "multiple of 2 ranks" in serve.tp_refusal(cfg, 2, world=3)
    assert "needs 2 ranks" in serve.tp_refusal(cfg, 2, world=1)
    assert serve.tp_refusal(cfg, 2, world=2) is None


def test_tensor_parallel_model_refuses_gradients():
    """The model group carries no gradient: a sum of a tensor that needs
    one raises (the JAX package trains no language model on a model
    axis)."""
    g = sharding.ModelGroup.__new__(sharding.ModelGroup)
    with pytest.raises(ValueError, match="serves only"):
        g.sum(torch.ones(2, requires_grad=True) * 2)
