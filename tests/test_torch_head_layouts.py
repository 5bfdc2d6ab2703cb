"""Tensor-parallel serving where the heads or KV heads do not divide the
model axis (``sharding.head_blocks``: a rank holds whole query heads of
one group and the KV heads they read, a KV head replicated on the ranks
that split its group), against the JAX package's serve and prefill steps
under its launcher's placement, on the CPU.

Gloo ranks spawned once a layout (``torch_mp_ranks.job_dp_serve``: start
method ``spawn``, a file store, no TCP port).  4 at (1, 4) serve reduced
fp32 configs: StarCoder2-3B (4 heads over 2 KV heads: each KV head on 2
ranks, one query head a rank, the form of the full width's 24 over 2 at
mp 4), Qwen2-7B with 14 heads over 2 KV heads (each group of 7 split 4
and 3, the full width's 28 over 4 at mp 8; ``qkv_bias``), Whisper-large-v3
with 6 MHA heads (2, 2, 1, 1, the full width's 20 at mp 8) and at its
reduction's 4 over 2 (the cross-attention on a rank's query heads beside
a replicated self-attention KV head), Zamba2-7B (the shared block),
Moonlight (MoE) and InternVL2-2B (the image prefix in the fused
prefill).  4 at (2, 2) serve StarCoder2-3B with 3 heads over 1 KV head
(2 and 1 query heads a model column, the KV head on every rank), the
parameters FSDP-placed on ``'data'``, so each column gathers blocks of
its own shapes, 2 prompt rows a data row.  The weights are of the JAX tree's
shapes drawn with numpy, every bias and norm random, carried across by
``convert.params_from_jax(..., mesh=, coords=, cfg=)``.

The reference is JAX's jitted ``make_serve_step`` and
``make_prefill_step`` (``attn_impl="chunked"``) with the parameters
placed by ``param_pspecs`` on a ``("data", "model")`` mesh of the same
layout (``torch_mp_ranks.JAX_SERVE_CHILD``, computed once a module beside
the ranks): logits within ``TOL`` (1e-5) of the largest logit, greedy
tokens equal; the ranks of one data row bitwise equal.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import get_model as jget_model
from repro_torch import configs, models
from repro_torch.configs.base import reduced
from repro_torch.launch import serve
from repro_torch.models import sharding

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
BATCH, PROMPT, GEN = 4, 8, 4
LAYOUTS = {"1x4": (1, 4), "2x2": (2, 2)}
# case -> (arch, config overrides, layout, each model rank's (query heads,
# KV heads) counts)
CASES = {
    "starcoder2": ("starcoder2-3b", {}, "1x4", [(1, 1)] * 4),
    "qwen2_g7": ("qwen2-7b", {"n_heads": 14, "n_kv_heads": 2}, "1x4",
                 [(4, 1), (3, 1), (4, 1), (3, 1)]),
    "whisper_mha": ("whisper-large-v3", {"n_heads": 6, "n_kv_heads": 6},
                    "1x4", [(2, 2), (2, 2), (1, 1), (1, 1)]),
    "whisper": ("whisper-large-v3", {}, "1x4", [(1, 1)] * 4),
    "zamba2": ("zamba2-7b", {}, "1x4", [(1, 1)] * 4),
    "moonlight": ("moonshot-v1-16b-a3b", {}, "1x4", [(1, 1)] * 4),
    "internvl2": ("internvl2-2b", {}, "1x4", [(1, 1)] * 4),
    "kv1": ("starcoder2-3b", {"n_heads": 3, "n_kv_heads": 1}, "2x2",
            [(2, 1), (1, 1)]),
}
# the cases whose one-process cache ``convert.cache_from_jax`` places (an
# MoE model's decode may route a near-tie apart between the two models)
CONVERT_CACHE = [c for c in CASES if c != "moonlight"]
JITTER = {"scale": 1.0, "bias": 0.0, "q_norm": 1.0, "k_norm": 1.0,
          "kv_norm": 1.0, "bq": 0.0, "bk": 0.0, "bv": 0.0, "bo": 0.0,
          "b_up": 0.0, "b_down": 0.0, "router_bias": 0.0}
LAUNCHER = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
            "--dist-backend", "gloo", "--batch", "4", "--prompt-len", "8",
            "--gen", "4", "--model-parallel", "4"]
MAIN = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu", "--dist-backend",
        "gloo", "--batch", "4", "--prompt-len", "8", "--gen", "4",
        "--model-parallel", "4"]


def _cfgs(case):
    arch, over, *_ = CASES[case]
    jcfg = jreduced(jconfigs.get(arch), **over)
    cfg = reduced(configs.get(arch), **over)
    return jcfg, dataclasses.replace(cfg, attn_impl="flash")


@functools.cache
def _case(case):
    """Weights of the JAX tree's shapes drawn with numpy (a matrix normal
    by fan-in ** -0.5, JITTER's leaves about their value), the prompt, a
    VLM's patches and Whisper's frames."""
    jcfg, cfg = _cfgs(case)
    tree = jax.eval_shape(lambda k: jget_model(jcfg).init_params(k, jcfg),
                          jax.random.key(0))
    rng = np.random.default_rng(17)

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
                   np.int32), gen=GEN, batches=(BATCH,))
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_width, cfg.d_model)).astype(np.float32)
    return out


def _layout_cases(layout):
    return [c for c, v in CASES.items() if v[2] == layout]


@functools.cache
def _run():
    """(JAX's references by case; each layout's ranks' results): the JAX
    child and both layouts' spawns side by side, once a module."""
    tmp = tempfile.mkdtemp(prefix="head_layouts")
    cases = {c: _case(c) for c in CASES}
    runs = [(c, LAYOUTS[CASES[c][2]], BATCH) for c in CASES]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump(({c: dict(arch=CASES[c][0], over=CASES[c][1], moe_kw={},
                              gen=GEN, **{k: v for k, v in cases[c].items()
                                          if k in ("jparams", "prompt",
                                                   "patches", "frames")})
                      for c in CASES}, runs), f)
    child = subprocess.Popen(
        [sys.executable, "-c", ranks.JAX_SERVE_CHILD,
         os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def spawn(layout):
        dp, mp = LAYOUTS[layout]
        names = _layout_cases(layout)
        return ranks.spawn(
            dp * mp, mp, "job_dp_serve", os.path.join(tmp, layout),
            cases={c: cases[c] for c in names},
            launchers={"starcoder2": LAUNCHER} if layout == "1x4" else {},
            main=MAIN if layout == "1x4" else None,
            convert_cache=[c for c in names if c in CONVERT_CACHE])

    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        res = dict(zip(LAYOUTS, pool.map(spawn, LAYOUTS)))
    _, err = child.communicate(timeout=900)
    assert child.returncode == 0, err[-3000:]
    with open(os.path.join(tmp, "out.pkl"), "rb") as f:
        want = {name: r for (name, _, _), r in pickle.load(f).items()}
    shutil.rmtree(tmp, ignore_errors=True)
    return want, res


def _close_to_largest(got, want, what):
    want = np.asarray(want, np.float32)
    real = want > -1e29  # the padded vocabulary's NEG_INF columns
    scale = float(np.abs(np.where(real, want, 0)).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _rows(case):
    """The case's layout's ranks' results, by data row: [(rows, [the
    row's ranks' decode results])]."""
    dp, mp = LAYOUTS[CASES[case][2]]
    res = _run()[1][CASES[case][2]]
    return [(res[d * mp][case][BATCH]["rows"],
             [res[d * mp + m][case][BATCH]["decode"] for m in range(mp)])
            for d in range(dp)]


def _joined(case, get):
    """``get(result)`` of each data row's first rank joined over the rows
    (the whole batch's); a list of steps joined step by step."""
    parts = [get(results[0]) for _, results in _rows(case)]
    if isinstance(parts[0], list):
        return [np.concatenate([p[t] for p in parts])
                for t in range(len(parts[0]))]
    return np.concatenate(parts)


# --- the assignment, on every config -----------------------------------------

HEAD_ARCHS = [a for a in configs.names() if configs.get(a).n_heads]


@pytest.mark.parametrize("mp", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", HEAD_ARCHS)
def test_head_blocks_cover_every_head_once(arch, mp):
    """``head_blocks`` of every config with attention at mp 2, 4, 8, 16:
    each query head on exactly one rank, contiguous and in rank order;
    each rank's KV heads exactly those its query heads read (h // G, MLA
    reading its own); one group size over a rank's heads; the even split
    where the KV heads divide over the ranks."""
    cfg = configs.get(arch)
    H = cfg.n_heads
    KV = H if cfg.mla else cfg.n_kv_heads
    G = H // KV
    blocks = sharding.head_blocks(cfg, mp)
    assert len(blocks) == mp
    assert [h for q, _ in blocks for h in q] == list(range(H))
    for q, kv in blocks:
        assert len(q) >= 1
        assert list(kv) == sorted({h // G for h in q})
        if KV % mp == 0:
            assert (len(q), len(kv)) == (H // mp, KV // mp)
        elif len(kv) == 1:  # a replicated KV head: part of one group
            assert len(q) <= G


def test_head_blocks_of_the_refused_layouts_of_the_past():
    """The layouts this assignment serves at full width: StarCoder2-3B at
    mp 4 (6 heads a rank) and 8 (3), Qwen2-7B at mp 8 (4 and 3 of each
    group of 7), Whisper-large-v3 at mp 8 (3, 3, 3, 3, 2, 2, 2, 2); every
    rank there holds one KV head but Whisper's, which holds its own."""
    def counts(arch, mp):
        return [(len(q), len(kv)) for q, kv in sharding.head_blocks(
            configs.get(arch), mp)]

    assert counts("starcoder2-3b", 4) == [(6, 1)] * 4
    assert counts("starcoder2-3b", 8) == [(3, 1)] * 8
    assert counts("qwen2-7b", 8) == [(4, 1), (3, 1)] * 4
    assert counts("whisper-large-v3", 8) == [(3, 3)] * 4 + [(2, 2)] * 4
    blocks = sharding.head_blocks(configs.get("qwen2-7b"), 8)
    assert [(q.start, q.stop, kv.start) for q, kv in blocks[:3]] == [
        (0, 4, 0), (4, 7, 0), (7, 11, 1)]


@pytest.mark.parametrize("heads, kv, mp, match", [
    (24, 6, 4, "straddle two groups"), (4, 2, 3, "4 heads do not divide "
                                                  "over 3"),
    (2, 2, 4, "no head"), (4, 2, 8, "no head")])
def test_head_blocks_refuse(heads, kv, mp, match):
    """A rank's heads that would straddle two groups, or a rank with no
    head, raise."""
    cfg = reduced(configs.get("qwen2-7b"), n_heads=heads, n_kv_heads=kv)
    with pytest.raises(ValueError, match=match):
        sharding.head_blocks(cfg, mp)


# --- serving against JAX's placement ------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_decode_matches_jax_placement(case):
    """The decode logits (joined over the data rows) within TOL of JAX's
    under the launcher's placement at every step, teacher-forced then
    greedy, the greedy tokens equal."""
    want = _run()[0][case]
    logits = _joined(case, lambda r: r["logits"])
    tokens = _joined(case, lambda r: r["tokens"])
    assert len(logits) == PROMPT + GEN
    for t in range(PROMPT + GEN):
        _close_to_largest(logits[t], want["logits"][t], f"{case} step {t}")
        np.testing.assert_array_equal(tokens[t], want["tokens"][t])


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax_placement(case):
    """The fused prefill (flash on a rank's heads: the wrapper's plain
    version on CPU tensors; a VLM's behind its patches, Whisper's on its
    frames) within TOL of JAX's, its greedy tokens equal."""
    want = _run()[0][case]
    _close_to_largest(_joined(case, lambda r: r["prefill"]["logits"]),
                      want["prefill"], f"{case} prefill")
    np.testing.assert_array_equal(
        _joined(case, lambda r: r["prefill"]["tokens"]),
        want["prefill_tokens"])


@pytest.mark.parametrize("case", CASES)
def test_model_rows_agree_bitwise(case):
    """The ranks of one data row (its model group) return bitwise equal
    logits, tokens, expert selections and prefills, whatever heads each
    holds."""
    for _, results in _rows(case):
        for r in results[1:]:
            for key in ("logits", "tokens"):
                for a, b in zip(results[0][key], r[key]):
                    np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(results[0]["prefill"][key],
                                              r["prefill"][key])
            for layer, sel in results[0].get("selection", {}).items():
                np.testing.assert_array_equal(sel, r["selection"][layer])


def _want_shape(cfg, key, shape, spec, mesh, heads):
    """A leaf's block at a rank holding ``heads`` ((query, KV) counts):
    its ``'data'`` dimension split evenly, its ``'model'`` one as many
    heads' slices as the rank holds where the leaf carries heads (the
    query heads', or the KV heads' of ``wk``, ``wv``, ``bk``, ``bv``
    outside Whisper's cross-attention), an equal part otherwise."""
    names = key.split(".")
    out = []
    for n, e in zip(shape, spec):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        if "model" in axes and names[-1] in sharding.HEAD_LEAVES:
            kv = (names[-1] in ("wk", "wv", "bk", "bv")
                  and "cross" not in names)
            n = n // (cfg.n_kv_heads if kv else cfg.n_heads) * heads[kv]
            axes = tuple(a for a in axes if a != "model")
        out.append(n // math.prod(mesh.shape[a] for a in axes))
    return tuple(out)


@pytest.mark.parametrize("case", CASES)
def test_a_rank_holds_its_head_blocks(case):
    """Each rank holds exactly its head-aligned blocks (the rank's query
    heads' columns of ``wq``, rows of ``wo``, its KV heads' columns of
    ``wk``/``wv``, replicated where the ranks share a KV head; a
    ``'data'`` dimension split over the data rows; every other leaf
    JAX's block): the shapes, the bytes, and
    ``convert.params_from_jax(..., mesh=, coords=, cfg=)`` and
    ``local_state_dict`` bitwise; each rank's heads are the case's."""
    arch, over, layout, heads = CASES[case]
    cfg = _case(case)["cfg"]
    dp, mp = LAYOUTS[layout]
    mesh = sharding.MeshShape(("data", "model"), (dp, mp))
    shapes = models.leaf_shapes(cfg)
    specs = sharding.param_pspecs(shapes, mesh)
    got = [(len(q), len(kv)) for q, kv in sharding.head_blocks(cfg, mp)]
    assert got == heads
    for rank, res in enumerate(_run()[1][layout]):
        o = res[case]
        assert o["blocks_equal"], (case, rank)
        h = heads[rank % mp]
        want = {k: _want_shape(cfg, k, shapes[k], specs[k], mesh, h)
                for k in shapes}
        if cfg.ssm is not None:  # the fused leaves: segment-aligned
            want.update({k: s for k, s in o["block_shapes"].items()
                         if k.split(".")[-1] in sharding.SSM_SEGMENTS})
        assert o["block_shapes"] == want, (case, rank)
        assert o["weights_bytes"] == 4 * sum(math.prod(s)
                                             for s in want.values())


@pytest.mark.parametrize("case", CONVERT_CACHE)
def test_cache_from_jax_gives_whole_kv_heads(case):
    """``convert.cache_from_jax(tree, mesh=, coords=, cfg=)`` of the one
    process's cache after the prompt gives each rank whole KV heads (its
    query heads of Whisper's cross K/V; JAX's ``cache_pspecs`` splits
    their head_dim where the KV heads do not divide over the ranks) and
    its data row's rows: the shapes of the rank's own ``make_cache(mp=,
    rank=, dp=)`` and, within TOL of the largest value, its values after
    its rows' prompt."""
    heads = CASES[case][3]
    mp = LAYOUTS[CASES[case][2]][1]
    cfg = _case(case)["cfg"]
    for rank, res in enumerate(_run()[1][CASES[case][2]]):
        o = res[case]["cache"]
        assert all(a == b for a, b in o["shapes"]), o["shapes"]
        kv = {a[-2] for a, _ in o["shapes"] if len(a) == 5
              and a[2] == PROMPT}  # the self-attention K/V
        assert kv == {heads[rank % mp][1]}
        assert all(a[-1] == cfg.head_dim for a, _ in o["shapes"]
                   if len(a) == 5 and cfg.ssm is None)
        assert o["gap"] <= TOL, (rank, o["gap"])


def test_launcher_serves_at_1x4():
    """``serve_lm`` on the started world at ``--model-parallel 4``:
    reduced StarCoder2-3B's 2 KV heads each on 2 ranks; every rank returns
    the tokens and prompt logits of one process (within TOL); rank 0
    alone prints; a rank's cache holds its one KV head; a decode step
    runs 2 sums a layer and the embedding's and 1 gather; the fused
    prefill holds to the decode.  ``serve.main`` then serves reduced
    Qwen2-7B at mp 4 (the same layout, its biases on replicated KV heads)
    and ends the group."""
    cfg = reduced(configs.get("starcoder2-3b"))
    one = serve.serve_lm(serve.parse_args(LAUNCHER[:-2]), cfg)
    res = [r["launchers"]["starcoder2"] for r in _run()[1]["1x4"]]
    for r, o in enumerate(res):
        np.testing.assert_array_equal(o["tokens"], one["tokens"])
        _close_to_largest(o["prompt_logits"], one["prompt_logits"].numpy(),
                          f"rank {r} prompt logits")
        assert (o["model_parallel"], o["data_parallel"]) == (4, 1)
        assert o["collectives"]["sums"] == 2 * cfg.n_layers + 1
        assert o["collectives"]["gathers"] == 1
        assert o["cache_bytes"] == 2 * cfg.n_layers * 4 * 12 * 1 * (
            cfg.head_dim) * 4
        assert o["prefill_gap"]["gap"] <= o["prefill_gap"]["tol"]
    assert "mesh (data 1, model 4)" in res[0]["out"]
    assert all(o["out"] == "" for o in res[1:])
    main = [r["main"] for r in _run()[1]["1x4"]]
    assert all(o["code"] == 0 and not o["group_left"] for o in main)
    assert "smoke: fused prefill == sequential decode" in main[0]["out"]
