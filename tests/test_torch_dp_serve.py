"""Serving on JAX's serve launcher's ``(world / mp, mp)`` host mesh: the
parameters FSDP-placed on ``'data'`` (``models.local_model`` with a data
group, ``sharding.DataShards`` over a 2-D mesh, each family's decode
gathering a layer's column block where the layer runs), the batch and
cache on ``'data'`` (``sharding.batch_rows``, ``make_cache(dp=)``), and
``serve`` on a world larger than the model axis, against the JAX
package's serve and prefill steps under its launcher's placement, on the
CPU.

Gloo ranks spawned once a layout (``torch_mp_ranks.job_dp_serve``: start
method ``spawn``, a file store, no TCP port): 2 at (2, 1) and 4 at
(2, 2).  They serve the reduced fp32 configs of StarCoder2-3B (the tied
table, every bias), Qwen3-8B, Qwen2-7B (``qkv_bias``), InternVL2-2B (the
image prefix in the fused prefill), Moonlight (dropless; capacity, whose
drops are the global batch's; 6 experts, which do not divide (2, 2)'s 4
ranks: ``'ep'`` falls back to ``'mp'`` with the hidden dimensions on
``'data'``), DeepSeek-V3 (MLA's plain and absorbed decode), Mamba2-370M,
Zamba2-7B and Whisper-large-v3, on weights of the JAX tree's shapes
drawn with numpy, every bias and norm random, carried across by
``convert.params_from_jax(..., mesh=, coords=, cfg=)``.  Batch 4 splits
into 2 rows a data row; batch 3 does not divide, and each data row then
serves the whole batch.

The reference is JAX's jitted ``make_serve_step`` and
``make_prefill_step`` (``attn_impl="chunked"``) with the parameters
placed by ``param_pspecs`` on a ``("data", "model")`` mesh of the same
layout, in one child process on 4 virtual CPU devices, computed once a
module beside the ranks.  Logits within ``TOL`` (1e-5) of the largest
logit (fp32: the same products, the model group's sums in another
order), greedy tokens equal; the ranks of one data row bitwise equal.
"""
from __future__ import annotations

import dataclasses
import functools
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
LAYOUTS = {"2x1": (2, 1), "2x2": (2, 2)}
JAX_CHILDREN = 3  # the references' runs, split over children side by side
# case -> (arch, MoE overrides)
CASES = {
    "starcoder2": ("starcoder2-3b", {}),
    "qwen3": ("qwen3-8b", {}),
    "qwen2": ("qwen2-7b", {}),
    "internvl2": ("internvl2-2b", {}),
    "moonlight": ("moonshot-v1-16b-a3b", {}),
    "moonlight_capacity": ("moonshot-v1-16b-a3b", {"capacity_factor": 1.0}),
    "moonlight_e6": ("moonshot-v1-16b-a3b", {"n_experts": 6}),
    "deepseek": ("deepseek-v3-671b", {}),
    "mamba2": ("mamba2-370m", {}),
    "zamba2": ("zamba2-7b", {}),
    "whisper": ("whisper-large-v3", {}),
}
# the cases also served at batch 3, which does not divide over 2 data rows
WHOLE_BATCH = ("starcoder2", "moonlight_capacity")
# the cases whose one-process cache ``convert.cache_from_jax`` places
CONVERT_CACHE = ("starcoder2", "deepseek", "mamba2", "whisper")
JITTER = {"scale": 1.0, "bias": 0.0, "q_norm": 1.0, "k_norm": 1.0,
          "kv_norm": 1.0, "bq": 0.0, "bk": 0.0, "bv": 0.0, "bo": 0.0,
          "b_up": 0.0, "b_down": 0.0, "router_bias": 0.0}
LAUNCHER = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
            "--dist-backend", "gloo", "--batch", "4", "--prompt-len", "8",
            "--gen", "4"]
MAIN = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
        "--dist-backend", "gloo", "--batch", "4", "--prompt-len", "8",
        "--gen", "4"]


def _cfgs(case):
    arch, moe_kw = CASES[case]
    jcfg, cfg = jreduced(jconfigs.get(arch)), reduced(configs.get(arch))
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_kw))
    return jcfg, dataclasses.replace(cfg, attn_impl="flash")


def _batches(case):
    return (BATCH, 3) if case in WHOLE_BATCH else (BATCH,)


@functools.cache
def _case(case):
    """Weights of the JAX tree's shapes drawn with numpy (a matrix normal
    by fan-in ** -0.5, JITTER's leaves about their value), the prompt, a
    VLM's patches and Whisper's frames, for the largest batch."""
    jcfg, cfg = _cfgs(case)
    tree = jax.eval_shape(lambda k: jget_model(jcfg).init_params(k, jcfg),
                          jax.random.key(0))
    rng = np.random.default_rng(13)

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
                   np.int32), gen=GEN, batches=_batches(case))
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_width, cfg.d_model)).astype(np.float32)
    return out


# JAX's serve and prefill steps under param_pspecs on a (dp, mp) mesh of
# 4 virtual CPU devices, in a child process
_JAX_CHILD = ranks.JAX_SERVE_CHILD


@functools.cache
def _run():
    """(JAX's references by (case, layout, batch); each layout's ranks'
    results): the JAX child and the two spawns side by side, once a
    module."""
    tmp = tempfile.mkdtemp(prefix="dp_serve")
    cases = {c: _case(c) for c in CASES}
    runs = [(c, lay, b) for c in CASES for lay in LAYOUTS.values()
            for b in _batches(c)]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    children = []
    for i in range(JAX_CHILDREN):
        with open(os.path.join(tmp, f"in{i}.pkl"), "wb") as f:
            pickle.dump(({c: dict(arch=CASES[c][0], moe_kw=CASES[c][1],
                                  gen=GEN, **{k: v for k, v in
                                              cases[c].items() if k in (
                                                  "jparams", "prompt",
                                                  "patches", "frames")})
                          for c in CASES}, runs[i::JAX_CHILDREN]), f)
        children.append(subprocess.Popen(
            [sys.executable, "-c", _JAX_CHILD,
             os.path.join(tmp, f"in{i}.pkl"),
             os.path.join(tmp, f"out{i}.pkl")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def spawn(name):
        dp, mp = LAYOUTS[name]
        return ranks.spawn(
            dp * mp, mp, "job_dp_serve", os.path.join(tmp, name),
            cases=cases,
            launchers={"starcoder2": LAUNCHER + ["--model-parallel",
                                                 str(mp)]},
            main=MAIN + ["--model-parallel", str(mp)],
            convert_cache=CONVERT_CACHE)

    with ThreadPoolExecutor(len(LAYOUTS)) as pool:  # both layouts at once
        res = dict(zip(LAYOUTS, pool.map(spawn, LAYOUTS)))
    want = {}
    for i, child in enumerate(children):
        _, err = child.communicate(timeout=900)
        assert child.returncode == 0, err[-3000:]
        with open(os.path.join(tmp, f"out{i}.pkl"), "rb") as f:
            want.update(pickle.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    return want, res


def _close_to_largest(got, want, what):
    want = np.asarray(want, np.float32)
    real = want > -1e29  # the padded vocabulary's NEG_INF columns
    scale = float(np.abs(np.where(real, want, 0)).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _rows(layout, case, batch, key="decode"):
    """The layout's ranks' results for the case at ``batch``, by data
    row: [(rows, [the row's ranks' results])]."""
    dp, mp = LAYOUTS[layout]
    res = _run()[1][layout]
    return [(res[d * mp][case][batch]["rows"],
             [res[d * mp + m][case][batch][key] for m in range(mp)])
            for d in range(dp)]


def _joined(layout, case, batch, field, key="decode"):
    """A field of the data rows' results joined over their rows (the
    whole batch's); where each row served the whole batch, row 0's."""
    parts = _rows(layout, case, batch, key)
    if parts[0][0] == (0, batch):
        return parts[0][1][0][field]
    if isinstance(parts[0][1][0][field], list):
        return [np.concatenate([p[1][0][field][t] for p in parts])
                for t in range(len(parts[0][1][0][field]))]
    return np.concatenate([p[1][0][field] for p in parts])


RUNS = [(lay, c, b) for lay in LAYOUTS for c in CASES for b in _batches(c)]


@pytest.mark.parametrize("layout, case, batch", RUNS)
def test_decode_matches_jax_placement(layout, case, batch):
    """The data rows' decode logits, joined over their rows, within TOL
    of JAX's under the launcher's placement at every step, the greedy
    tokens equal; batch 4 splits into 2 rows a data row (each rank's
    cache holds its row's), batch 3 runs whole on each."""
    want = _run()[0][(case, LAYOUTS[layout], batch)]
    logits = _joined(layout, case, batch, "logits")
    tokens = _joined(layout, case, batch, "tokens")
    assert len(logits) == PROMPT + GEN
    for t in range(PROMPT + GEN):
        _close_to_largest(logits[t], want["logits"][t],
                          f"{layout} {case} step {t}")
        np.testing.assert_array_equal(tokens[t], want["tokens"][t])
    for rows, results in _rows(layout, case, batch):
        share = BATCH // 2 if batch == BATCH else batch
        assert rows[1] - rows[0] == share
        assert all(r["cache_batch"] == share for r in results)


@pytest.mark.parametrize("layout, case, batch", RUNS)
def test_prefill_matches_jax_placement(layout, case, batch):
    """The fused prefill on each data row's rows (a VLM's behind its
    rows' patches, Whisper's on its rows' frames), joined, within TOL of
    JAX's, its greedy tokens equal."""
    want = _run()[0][(case, LAYOUTS[layout], batch)]
    parts = _rows(layout, case, batch)
    if parts[0][0] == (0, batch):  # each data row served the whole batch
        parts = parts[:1]
    for key, ref in (("logits", "prefill"), ("tokens", "prefill_tokens")):
        got = np.concatenate([p[1][0]["prefill"][key] for p in parts])
        if key == "logits":
            _close_to_largest(got, want[ref], f"{layout} {case} prefill")
        else:
            np.testing.assert_array_equal(got, want[ref])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_absorbed_decode_matches_jax_plain(layout):
    """DeepSeek-V3's absorbed decode on the gathered leaves within TOL of
    JAX's plain decode over the prompt (the port's absorbed branch
    computes the plain function, ``tests/test_torch_mla.py``)."""
    want = _run()[0][("deepseek", LAYOUTS[layout], BATCH)]
    logits = _joined(layout, "deepseek", BATCH, "logits", key="absorbed")
    assert len(logits) == PROMPT
    for t in range(PROMPT):
        _close_to_largest(logits[t], want["logits"][t],
                          f"{layout} absorbed step {t}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_model_rows_agree_bitwise(layout, case):
    """The ranks of one data row (its model group) return bitwise equal
    logits, tokens, expert selections and prefills."""
    for batch in _batches(case):
        for _, results in _rows(layout, case, batch):
            for r in results[1:]:
                for key in ("logits", "tokens"):
                    for a, b in zip(results[0][key], r[key]):
                        np.testing.assert_array_equal(a, b)
                for key in ("logits", "tokens"):
                    np.testing.assert_array_equal(
                        results[0]["prefill"][key], r["prefill"][key])
                if "selection" in r:
                    for layer, sel in results[0]["selection"].items():
                        np.testing.assert_array_equal(sel,
                                                      r["selection"][layer])


def _data_gathers(cfg) -> int:
    """A decode step's gathers over the data group: one a layer (each
    family's stack; Whisper's decoder), and the tables: a tied table's
    one, else the embedding (with Zamba2's shared block, Whisper's
    positions) and the unembedding."""
    return cfg.n_layers + (1 if cfg.tie_embeddings else 2)


def _model_sums(cfg) -> int:
    """A decode step's model-group sums (as ``test_torch_tp_serve*``):
    the embedding, then two a layer (Zamba2 two an application of its
    shared block besides; Whisper's decoder three a layer)."""
    if cfg.family == "encdec":
        return 3 * cfg.n_layers + 1
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        return 2 * cfg.n_layers + 2 * zamba2.n_shared_applications(cfg) + 1
    return 2 * cfg.n_layers + 1


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_collectives_and_blocks(layout, case):
    """Each rank holds exactly its 2-D blocks (``local_state_dict`` on
    the mesh, and ``convert.params_from_jax(..., mesh=, coords=, cfg=)``
    bitwise), a decode step runs ``_data_gathers`` gathers over the data
    group (``_model_sums`` sums and 1 gather over a model axis of 2), and
    no gathered weight outlives its layer: at each gather one layer's
    leaves are alive at most, after the decode none."""
    cfg = _case(case)["cfg"]
    dp, mp = LAYOUTS[layout]
    for rank, res in enumerate(_run()[1][layout]):
        o = res[case]
        assert o["blocks_equal"], (layout, case, rank)
        for batch in _batches(case):
            d = o[batch]["decode"]
            steps = d["steps"]
            assert d["data_gathers"] == _data_gathers(cfg) * steps
            assert d["sums"] == (_model_sums(cfg) * steps if mp > 1 else 0)
            assert d["gathers"] == (steps if mp > 1 else 0)
            assert d["alive_at_gather"] == 1 and d["alive_after"] == 0
            # the prefill: one gather a layer (Whisper's encoder and
            # decoder) and the tables
            enc = cfg.n_encoder_layers if cfg.family == "encdec" else 0
            assert d["prefill"]["data_gathers"] == cfg.n_layers + enc + (
                1 if cfg.tie_embeddings else 2)


@pytest.mark.parametrize("case", ["starcoder2", "mamba2", "moonlight"])
def test_a_rank_holds_its_blocks_bytes(case):
    """A rank's weights are its 2-D blocks: under a quarter of the whole
    model's bytes at (2, 2) beside the whole leaves, and each leaf's
    block at (2, 1) half a ``'dp'`` dimension; the gathered shapes
    (``DataShards.shapes``) are the (1, mp) rank's blocks."""
    cfg = _case(case)["cfg"]
    shapes = models.leaf_shapes(cfg)
    whole = 4 * sum(int(np.prod(s)) for s in shapes.values())
    for layout, (dp, mp) in LAYOUTS.items():
        m = sharding.MeshShape(("data", "model"), (dp, mp))
        specs = sharding.param_pspecs(shapes, m)
        tp = sharding.MeshShape(("data", "model"), (1, mp))
        for rank, res in enumerate(_run()[1][layout]):
            o = res[case]
            held = o["weights_bytes"]
            assert held == 4 * sum(int(np.prod(s))
                                   for s in o["block_shapes"].values())
            assert held < whole / (dp * mp) * 1.1, (layout, held, whole)
            if cfg.ssm is None:
                assert o["block_shapes"] == {
                    k: sharding.local_shape(shapes[k], specs[k], m)
                    for k in shapes}
                if cfg.moe is None:  # the experts' ids differ by layout
                    want = {k: sharding.local_shape(
                        shapes[k], sharding.param_pspecs(shapes, tp)[k], tp)
                        for k in shapes}
                    assert o["ds_shapes"] == want


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CONVERT_CACHE)
def test_cache_from_jax_gives_a_data_rows_rows(layout, case):
    """``convert.cache_from_jax(tree, mesh=, coords=, cfg=)`` of the whole
    batch's cache after the prompt gives each rank its data row's rows
    (and its model column's heads, an SSM rank's conv channels, MLA's
    latent whole): the shapes of the rank's own ``make_cache(dp=, mp=)``
    and, within TOL of the largest value, its values after its rows'
    prompt."""
    for rank, res in enumerate(_run()[1][layout]):
        o = res[case]["cache"]
        assert all(a == b for a, b in o["shapes"]), o["shapes"]
        assert all(a[1] == BATCH // 2 for a, _ in o["shapes"]
                   if len(a) > 3)
        assert o["gap"] <= TOL, (rank, o["gap"])


def test_expert_ids_in_both_ep_layouts():
    """A rank's experts: 8 experts divide (2, 2)'s 4 ranks, so rank (d, m)
    holds chunk 2 d + m and its column runs chunks m and 2 + m; 6 do not,
    so ``'ep'`` falls back to ``'mp'`` and column m runs experts 3 m ..
    3 m + 2; on (2, 1) every rank's column runs all of them."""
    m22 = sharding.MeshShape(("data", "model"), (2, 2))
    m21 = sharding.MeshShape(("data", "model"), (2, 1))
    for E, entry, want in ((8, ("data", "model"), [[0, 1, 4, 5],
                                                   [2, 3, 6, 7]]),
                           (6, "model", [[0, 1, 2], [3, 4, 5]])):
        for d in range(2):
            for mm in range(2):
                assert sharding.expert_ids(E, entry, m22, (d, mm)) == want[mm]
    assert sharding.expert_ids(8, ("data", "model"), m21, (1, 0)) == list(
        range(8))
    shapes = {"moe_layers.moe.w_gate": (1, 8, 64, 32)}
    assert sharding.param_pspecs(shapes, m22)[
        "moe_layers.moe.w_gate"][1] == ("data", "model")
    shapes = {"moe_layers.moe.w_gate": (1, 6, 64, 32)}
    assert sharding.param_pspecs(shapes, m22)[
        "moe_layers.moe.w_gate"] == (None, "model", "data", None)
    for case, want in (("moonlight", [[0, 1, 4, 5], [2, 3, 6, 7]]),
                       ("moonlight_e6", [[0, 1, 2], [3, 4, 5]])):
        for rank, res in enumerate(_run()[1]["2x2"]):
            assert res[case]["expert_ids"] == want[rank % 2]
        for res in _run()[1]["2x1"]:
            assert res[case]["expert_ids"] is None  # all of them


@pytest.mark.parametrize("layout", LAYOUTS)
def test_capacity_drops_over_the_global_batch_only_where_it_splits(layout):
    """``models.local_model(..., batch=)`` gives an MoE rank its data
    group for the capacity drops where the batch splits over the data
    rows (4 at dp 2), and none where each row serves the whole batch
    (3): there the row's drops are the whole batch's already.  A model
    with no experts has none."""
    for rank, res in enumerate(_run()[1][layout]):
        for case in CASES:
            moe = CASES[case][0] in ("moonshot-v1-16b-a3b",
                                     "deepseek-v3-671b")
            for batch in _batches(case):
                assert res[case][batch]["global_drops"] == (
                    moe and batch == BATCH), (rank, case, batch)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_launcher_serves_on_data_ranks(layout):
    """``serve_lm`` on the started world at ``--model-parallel`` mp: each
    data row serves 2 of the 4 prompt rows, every rank returns the whole
    batch's tokens, prompt and prompt logits, those of one process
    (logits within TOL), and the whole batch's tokens/s (its tokens over
    the slowest decode in the rank's data group) beside the data row's
    own; rank 0 alone prints; a rank's cache holds its rows; a decode
    step gathers a layer's blocks once a layer plus the tied table."""
    dp, mp = LAYOUTS[layout]
    cfg = reduced(configs.get("starcoder2-3b"))
    one = serve.serve_lm(serve.parse_args(LAUNCHER),
                         reduced(configs.get("starcoder2-3b")))
    res = [r["launchers"]["starcoder2"] for r in _run()[1][layout]]
    for r, o in enumerate(res):
        np.testing.assert_array_equal(o["tokens"], one["tokens"])
        np.testing.assert_array_equal(o["prompt"], one["prompt"].numpy())
        _close_to_largest(o["prompt_logits"], one["prompt_logits"].numpy(),
                          f"{layout} rank {r} prompt logits")
        group = res[r % mp::mp]  # the rank's data group
        slowest = max(sum(x["step_s"]) for x in group)
        assert o["tokens_per_s"] == pytest.approx(
            4 * o["steps"] / slowest, rel=1e-12)
        assert o["row_tokens_per_s"] == pytest.approx(
            2 * o["steps"] / sum(o["step_s"]), rel=1e-12)
        assert (o["model_parallel"], o["data_parallel"]) == (mp, dp)
        assert o["rows"] == ((r // mp) * 2, (r // mp) * 2 + 2)
        assert o["collectives"]["data_gathers"] == cfg.n_layers + 1
        assert o["collectives"]["sums"] == (
            2 * cfg.n_layers + 1 if mp > 1 else 0)
        assert o["cache_bytes"] == 2 * cfg.n_layers * 2 * 12 * (
            cfg.n_kv_heads // mp) * cfg.head_dim * 4
        assert o["peak_bytes"] is None  # the CPU has no allocator peak
        assert o["prefill_gap"]["gap"] <= o["prefill_gap"]["tol"]
    assert f"mesh (data {dp}, model {mp})" in res[0]["out"]
    assert res[0]["out"].count("smoke:") == 1
    assert all(o["out"] == "" for o in res[1:])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_main_serves_mamba2_on_the_world(layout):
    """``launch.serve.main([... "--model-parallel", mp, "--dist-backend",
    "gloo"])`` on the started world exits 0, rank 0 printing the mesh and
    the fused prefill's check, and ends the group."""
    dp, mp = LAYOUTS[layout]
    res = [r["main"] for r in _run()[1][layout]]
    assert all(o["code"] == 0 and not o["group_left"] for o in res)
    assert f"mesh (data {dp}, model {mp})" in res[0]["out"]
    assert "smoke: fused prefill == sequential decode" in res[0]["out"]


def test_refusals_on_a_data_axis():
    """The (world / mp, mp) layouts serve; a world that is no multiple of
    mp, and the conv family on any world, are refused (JAX's serve_conv
    builds no mesh)."""
    cfg = reduced(configs.get("starcoder2-3b"))
    assert serve.tp_refusal(cfg, 2, world=4) is None
    assert serve.tp_refusal(cfg, 1, world=4) is None
    assert "multiple of 2" in serve.tp_refusal(cfg, 2, world=3)
    assert "builds no mesh" in serve.tp_refusal(
        reduced(configs.get("atacworks")), 1, world=2)
    with pytest.raises(ValueError, match="builds no mesh"):
        serve.main(["--arch", "atacworks", "--smoke", "--device", "cpu",
                    "--model-parallel", "2"])
