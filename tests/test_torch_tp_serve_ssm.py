"""Tensor-parallel serving of the port's ssm, hybrid and encoder-decoder
families (Mamba2, Zamba2, Whisper: ``models.local_model``, the
segment-aligned SSM blocks of ``models/sharding.py``, the ``tp=`` paths
of ``mamba2.py``, ``zamba2.py`` and ``whisper.py``, ``serve
--model-parallel``) against the JAX package's single-device decode and
prefill, on the CPU.

Two gloo ranks at (1, 2), spawned once a module (``torch_mp_ranks``:
start method ``spawn``, a file store, no TCP port), serve the reduced
fp32 configs of Mamba2-370M (16 SSM heads of 8, one group), the same
with 2 groups (B and C split by groups instead of whole), Zamba2-7B (the
shared block applied twice, 4 heads over 2 KV heads) and Whisper-large-v3
(every bias, the cross-attention, the learned positions) on weights of
the JAX tree's shapes drawn with numpy, every bias, norm and SSM vector
random.  Each rank holds its blocks only.  Whisper's cross K/V come from
the same frames on both sides: ``fill_cross_cache`` on the ranks, JAX's
``encode`` and ``cross_kv`` on its cache (as ``test_torch_whisper.py``).
Decode steps (teacher-forced over the prompt, then greedy) and the fused
prefill (the port's ``attn_impl="flash"`` path: the wrapper's plain
version on CPU tensors, on a rank's heads; the depthwise conv's on a
rank's channels) are held against JAX's jitted ``make_serve_step`` and
``make_prefill_step`` on the same weights: logits within ``TOL`` (1e-5)
of the largest logit, greedy tokens equal.  The two ranks' logits and
tokens are bitwise equal.  The launcher serves each family over the two
ranks as one process does.
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
from repro.models import whisper as jwhisper
from repro.train import serve_step as jserve_step
from repro_torch import configs, convert, models
from repro_torch.configs.base import reduced
from repro_torch.launch import serve
from repro_torch.models import mamba2, sharding, zamba2

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import torch_mp_ranks as ranks  # noqa: E402

TOL = 1e-5
BATCH, PROMPT, GEN = 2, 8, 4
# case -> (arch, SSM overrides)
CASES = {
    "mamba2": ("mamba2-370m", {}),
    "mamba2_groups": ("mamba2-370m", {"n_groups": 2}),
    "zamba2": ("zamba2-7b", {}),
    "whisper": ("whisper-large-v3", {}),
}
# the 1-D leaves made random about their value (every stacked (L, n)
# leaf, the SSM's vectors among them, is drawn as a matrix)
JITTER = {"scale": 1.0, "bias": 0.0, "bq": 0.0, "bk": 0.0, "bv": 0.0,
          "bo": 0.0, "b_up": 0.0, "b_down": 0.0}
LAUNCHERS = {
    case: ["--arch", CASES[case][0], "--smoke", "--device", "cpu",
           "--batch", "2", "--prompt-len", "8", "--gen", "4",
           "--model-parallel", "2"]
    for case in ("mamba2", "zamba2", "whisper")}
ROW_PARALLEL = {"mamba2": "out_proj", "mamba2_groups": "out_proj",
                "zamba2": "shared.wo", "whisper": "dec_layers.cross.wo"}


def _cfgs(case):
    arch, ssm_kw = CASES[case]
    jcfg, cfg = jreduced(jconfigs.get(arch)), reduced(configs.get(arch))
    if ssm_kw:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, **ssm_kw))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, **ssm_kw))
    return jcfg, dataclasses.replace(cfg, attn_impl="flash")


@functools.cache
def _case(case):
    """Weights of the JAX tree's shapes and dtypes drawn with numpy (a
    matrix normal by fan-in ** -0.5, JITTER's leaves about their value,
    other vectors normal), the prompt and Whisper's frames."""
    jcfg, cfg = _cfgs(case)
    tree = jax.eval_shape(lambda k: jget_model(jcfg).init_params(k, jcfg),
                          jax.random.key(0))
    rng = np.random.default_rng(5)

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
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_width, cfg.d_model)).astype(np.float32)
    return out


@functools.cache
def _ranks():
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return ranks.spawn(2, 2, "job_tp_serve", tmp,
                           cases={c: _case(c) for c in CASES},
                           launchers=LAUNCHERS)


@functools.cache
def _jax(case):
    """JAX's single-device decode over the prompt then ``GEN`` greedy
    steps (each fed its own token; Whisper's on the cross K/V of the
    case's frames), and its fused prefill."""
    jcfg, _ = _cfgs(case)
    c = _case(case)
    p = jax.tree.map(jnp.asarray, c["jparams"])
    step = jax.jit(jserve_step.make_serve_step(jcfg))
    cache = jserve_step.make_cache(jcfg, BATCH, PROMPT + GEN,
                                   dtype=jnp.float32)
    out = {}
    batch = {"tokens": jnp.asarray(c["prompt"])}
    if "frames" in c:
        frames = jnp.asarray(c["frames"])
        enc = jwhisper.encode(p, jcfg, frames)
        k, v = jax.vmap(lambda lp: jwhisper.cross_kv(lp, enc, jcfg))(
            p["dec_layers"]["cross"])
        cache = dict(cache, cross_k=k, cross_v=v)
        out["cross"] = dict(cross_k=np.asarray(k), cross_v=np.asarray(v))
        batch["frames"] = frames
    logits, tokens = [], []
    tok = jnp.asarray(c["prompt"][:, :1])
    for t in range(PROMPT + GEN):
        if t < PROMPT:
            tok = jnp.asarray(c["prompt"][:, t:t + 1])
        tok, cache, lg = step(p, cache, tok, jnp.int32(t))
        logits.append(np.asarray(lg))
        tokens.append(np.asarray(tok))
    ptok, plog = jax.jit(jserve_step.make_prefill_step(jcfg))(p, batch)
    return dict(out, logits=logits, tokens=tokens, prefill=np.asarray(plog),
                prefill_tokens=np.asarray(ptok))


def _close_to_largest(got, want, what, tol=TOL):
    want = np.asarray(want, np.float32)
    real = want > -1e29  # the padded vocabulary's NEG_INF columns
    scale = float(np.abs(np.where(real, want, 0)).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _sums_a_step(cfg):
    """The group's sums a decode step: the embedding, then Mamba2's two
    a layer (the gated norm, ``out_proj``), Zamba2's shared block two an
    application (``wo``, ``w_down``), Whisper's decoder three a layer
    (self-attention, cross-attention, MLP)."""
    if cfg.family == "encdec":
        return 3 * cfg.n_layers + 1
    n_app = (zamba2.n_shared_applications(cfg) if cfg.family == "hybrid"
             else 0)
    return 2 * cfg.n_layers + 2 * n_app + 1


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_jax(case):
    """Each rank's decode logits at every step within TOL of JAX's
    single-device decode, the greedy tokens equal; a step runs
    ``_sums_a_step`` sums and 1 gather of the logits."""
    want = _jax(case)
    cfg = _case(case)["cfg"]
    for r, res in enumerate(_ranks()):
        got = res[case]["decode"]
        assert got["steps"] == PROMPT + GEN
        for t in range(PROMPT + GEN):
            _close_to_largest(got["logits"][t], want["logits"][t],
                              f"{case} rank {r} step {t}")
            np.testing.assert_array_equal(got["tokens"][t], want["tokens"][t])
        assert got["sums"] == _sums_a_step(cfg) * got["steps"]
        assert got["gathers"] == got["steps"]


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax(case):
    """The fused prefill on each rank's heads and conv channels within
    TOL of JAX's, its greedy tokens equal."""
    want = _jax(case)
    for r, res in enumerate(_ranks()):
        got = res[case]["prefill"]
        _close_to_largest(got["logits"], want["prefill"],
                          f"{case} rank {r} prefill")
        np.testing.assert_array_equal(got["tokens"], want["prefill_tokens"])


def test_fill_cross_cache_on_ranks_is_jaxs_heads():
    """Whisper's ``fill_cross_cache`` on a rank: its H/2 heads of JAX's
    cross K/V from the same frames, within TOL of the largest; the
    encoder's two sums a layer (attention, MLP) and no gather."""
    want = _jax("whisper")["cross"]
    cfg = _case("whisper")["cfg"]
    for r, res in enumerate(_ranks()):
        fill = res["whisper"]["fill"]
        assert fill["sums"] == 2 * cfg.n_encoder_layers
        assert fill["gathers"] == 0
        for k, w in want.items():
            h = w.shape[3] // 2
            assert fill["cross"][k].shape == w[:, :, :, :h].shape
            _close_to_largest(fill["cross"][k], w[:, :, :, r * h:(r + 1) * h],
                              f"rank {r} {k}")


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree_bitwise(case):
    """The two ranks' logits and tokens are bitwise equal (every rank
    takes the same greedy token), and their row-parallel weights are
    different blocks."""
    a, b = (res[case] for res in _ranks())
    for key in ("decode", "prefill"):
        for k in a[key]:
            if isinstance(a[key][k], list):
                for x, y in zip(a[key][k], b[key][k]):
                    np.testing.assert_array_equal(x, y, err_msg=f"{key}.{k}")
            elif isinstance(a[key][k], np.ndarray):
                np.testing.assert_array_equal(a[key][k], b[key][k])
    keys = [k for k in a["weights"] if k.endswith(ROW_PARALLEL[case])]
    assert keys and not any(np.array_equal(a["weights"][k], b["weights"][k])
                            for k in keys)


def _rank_numel(cfg, shapes, mp):
    """The values a rank holds: each leaf's block under JAX's specs, an
    SSM model's fused leaves their segment-aligned blocks."""
    m = sharding.MeshShape(("data", "model"), (1, mp))
    total = 0
    for key, spec in sharding.param_pspecs(shapes, m).items():
        shape = shapes[key]
        name = key.split(".")[-1]
        if cfg.ssm is not None and name in sharding.SSM_SEGMENTS:
            shape = (*shape[:-1], sharding.ssm_local_width(cfg, name, mp))
        else:
            shape = sharding.local_shape(shape, spec, m)
        total += int(np.prod(shape))
    return total


@pytest.mark.parametrize("case", CASES)
def test_rank_holds_its_blocks(case):
    """A rank's weights are its blocks and nothing more: its values
    number the whole model's less the split leaves' other blocks (B and
    C whole on every rank where one group cannot split), and its fused
    SSM leaves are the segment-aligned blocks of the whole."""
    c = _case(case)
    cfg = c["cfg"]
    full = models.init_model(cfg)
    full.load_state_dict(convert.params_from_jax(c["jparams"]))
    shapes = {k: tuple(p.shape) for k, p in full.state_dict().items()}
    for r, res in enumerate(_ranks()):
        w = res[case]["weights"]
        assert set(w) == set(shapes)
        assert sum(a.size for a in w.values()) == _rank_numel(cfg, shapes, 2)
        assert sum(a.size for a in w.values()) < sum(
            int(np.prod(s)) for s in shapes.values())
        for key, t in full.state_dict().items():
            name = key.split(".")[-1]
            if cfg.ssm is not None and name in sharding.SSM_SEGMENTS:
                want = sharding.segment_block(
                    t, sharding.ssm_segments(cfg, name, 2), 2, r)
                np.testing.assert_array_equal(w[key], want.numpy(), key)


@pytest.mark.parametrize("case", list(LAUNCHERS))
def test_launcher_serves_over_two_ranks(case):
    """``serve_lm`` with ``--model-parallel 2`` on the started world: both
    ranks return the same tokens and prompt logits, the same as one
    process's; rank 0 alone prints; the collectives a step, a rank's
    weight bytes (its blocks) and cache bytes (its heads and channels)."""
    argv = LAUNCHERS[case]
    cfg = reduced(configs.get(CASES[case][0]))
    one = serve.serve_lm(serve.parse_args(argv[:-2]), cfg)
    a, b = (res["launchers"][case] for res in _ranks())
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["prompt_logits"], b["prompt_logits"])
    np.testing.assert_array_equal(a["tokens"], one["tokens"])
    _close_to_largest(a["prompt_logits"], one["prompt_logits"].numpy(),
                      f"{case} launcher prompt logits")
    assert "model-parallel 2" in a["out"] and a["out"].count("smoke:") == 1
    assert b["out"] == ""
    assert a["collectives"]["sums"] == _sums_a_step(cfg)
    assert a["collectives"]["gathers"] == 1
    assert a["prefill_gap"]["gap"] <= a["prefill_gap"]["tol"]
    full = models.init_model(cfg)
    shapes = {k: tuple(p.shape) for k, p in full.state_dict().items()}
    assert a["weights_bytes"] == 4 * _rank_numel(cfg, shapes, 2)
    whole = serve.make_cache(cfg, 2, 12, dtype=torch.float32)
    half = serve.make_cache(cfg, 2, 12, dtype=torch.float32, mp=2)
    assert a["cache_bytes"] == serve._nbytes(sharding.tree_leaves(half))
    assert a["cache_bytes"] < serve._nbytes(sharding.tree_leaves(whole))


# --- the blocks, the norm and the refusals, in one process ------------------

@pytest.mark.parametrize("mp", (2, 4))
@pytest.mark.parametrize("groups", (1, 4))
@pytest.mark.parametrize("name", sorted(sharding.SSM_SEGMENTS))
def test_segment_blocks_reassemble(name, groups, mp):
    """Each rank's segment-aligned block of a fused SSM leaf (or of the
    cache's conv state) holds its share of every split segment and every
    whole one entire: the ranks' shares, joined segment by segment,
    are the leaf exactly, and each rank's width is
    ``ssm_local_width``."""
    cfg = reduced(configs.get("mamba2-370m"))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=groups))
    segs = sharding.ssm_segments(cfg, name, mp)
    width = sum(w for w, _ in segs)
    t = torch.arange(3 * width, dtype=torch.float32).reshape(3, width)
    blocks = [sharding.segment_block(t, segs, mp, r) for r in range(mp)]
    assert all(b.shape == (3, sharding.ssm_local_width(cfg, name, mp))
               for b in blocks)
    start, local, pieces = 0, 0, []
    for w, split in segs:
        n = w // mp if split else w
        parts = [b[:, local:local + n] for b in blocks]
        if split:
            pieces.append(torch.cat(parts, -1))
        else:
            assert all(torch.equal(p, parts[0]) for p in parts)
            pieces.append(parts[0])
        start, local = start + w, local + n
    assert torch.equal(torch.cat(pieces, -1), t)
    # one group stays whole; four split by groups
    assert [s for _, s in segs].count(False) == (2 if groups == 1 else 0)


class _OtherRank:
    """A stand-in model group of two ranks whose sum adds the other
    rank's partial (precomputed), as the all-reduce does."""

    size = 2

    def __init__(self, other):
        self.other = other

    def sum(self, x):
        return x + self.other


def test_rank_gated_norm_is_the_one_process_norm():
    """Mamba2's gated RMS norm on a rank's channels, its sum of squares
    summed over the group and divided by the whole width, equals the
    one-process norm's columns of that rank (fp32 sums in another
    order); without the sum, each rank's mean over its own half is far
    from it."""
    cfg = reduced(configs.get("mamba2-370m"))
    gen = torch.Generator().manual_seed(7)
    y, z = (torch.randn((2, 5, 128), generator=gen) for _ in range(2))
    y[..., 64:] *= 3.0  # the halves' mean squares differ
    scale = 1.0 + 0.1 * torch.randn(128, generator=gen)
    whole = mamba2.gated_norm(y, z, scale, cfg, torch.float32)
    gz = y * torch.nn.functional.silu(z)
    ss = [(gz[..., h] ** 2).sum(-1, keepdim=True)
          for h in (slice(0, 64), slice(64, 128))]
    for r, h in enumerate((slice(0, 64), slice(64, 128))):
        got = mamba2.gated_norm(y[..., h], z[..., h], scale[h], cfg,
                                torch.float32, _OtherRank(ss[1 - r]))
        torch.testing.assert_close(got, whole[..., h], rtol=1e-6, atol=1e-6)
        alone = mamba2.gated_norm(y[..., h], z[..., h], scale[h], cfg,
                                  torch.float32)
        assert (alone - whole[..., h]).abs().max() > 0.1


@pytest.mark.parametrize("arch", ("mamba2-370m", "zamba2-7b",
                                  "whisper-large-v3"))
@pytest.mark.parametrize("mp", (2, 4))
def test_the_families_are_served(arch, mp):
    """``tp_refusal`` passes the ssm, hybrid and encdec families at their
    published widths over 2 and 4 ranks, and the reduced configs over
    2."""
    assert serve.tp_refusal(configs.get(arch), mp, world=mp) is None
    assert serve.tp_refusal(reduced(configs.get(arch)), 2, world=2) is None


@pytest.mark.parametrize("arch, mp, ssm, match", [
    ("whisper-large-v3", 3, {}, "4 heads do not divide over 3"),
    ("mamba2-370m", 32, {}, "16 SSM heads do not divide over 32"),
    ("mamba2-370m", 8, {"n_groups": 4},
     "4 SSM groups do not divide over 8"),
])
def test_refused_ssm_and_encdec_layouts_raise(arch, mp, ssm, match):
    """Heads (Whisper at mp 3), SSM heads and SSM groups that do not
    divide raise their message, naming ROADMAP.md's item, before any
    group starts."""
    cfg = reduced(configs.get(arch))
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm))
    args = serve.parse_args(["--arch", arch, "--device", "cpu",
                             "--model-parallel", str(mp)])
    with pytest.raises(ValueError, match=match) as e:
        serve.serve_lm(args, cfg)
    assert serve.TP_ITEM in str(e.value)


def test_published_ssm_heads_that_do_not_divide_are_refused():
    """Zamba2-7B's 112 SSM heads over 32 ranks (its 32 attention heads,
    KV heads and vocabulary divide) are refused."""
    why = serve.tp_refusal(configs.get("zamba2-7b"), 32)
    assert "112 SSM heads do not divide over 32" in why
    assert serve.TP_ITEM in why


def test_rank_caches_hold_their_heads_and_channels():
    """``make_cache(mp=2)`` of each family: an SSM layer's conv state of
    the rank's x channels and whole B and C, its H/2 heads of SSM state;
    Zamba2's KV/2 heads a slot; Whisper's KV/2 and H/2 heads."""
    m2 = reduced(configs.get("mamba2-370m"))
    d_inner, H, conv_dim = mamba2.dims(m2)
    c = serve.make_cache(m2, 2, 8, dtype=torch.float32, mp=2)
    GN = conv_dim - d_inner
    assert c["conv"].shape[-1] == d_inner // 2 + GN
    assert c["ssm"].shape[2] == H // 2
    zb = reduced(configs.get("zamba2-7b"))
    c = serve.make_cache(zb, 2, 8, dtype=torch.float32, mp=2)
    assert c["k"].shape[3] == zb.n_kv_heads // 2
    assert c["mamba"]["ssm"].shape[2] == mamba2.dims(zb)[1] // 2
    wh = reduced(configs.get("whisper-large-v3"))
    c = serve.make_cache(wh, 2, 8, dtype=torch.float32, mp=2)
    assert c["k"].shape[3] == wh.n_kv_heads // 2
    assert c["cross_k"].shape[3] == wh.n_heads // 2
