"""The port's dry-run (``repro_torch.launch.specs``, ``launch/dryrun.py``
and the counting half of ``repro_torch.roofline.analysis``) on the CPU:

  * the cell specs against the JAX package's (``repro.launch.specs``):
    ``SHAPES``, ``input_specs``, ``applicable`` and ``pick_accum`` for
    every arch x shape, equal;
  * ``probe_plan``, ``extrapolate``, ``roofline_terms`` (JAX's constants
    passed in), ``flash_correction`` and ``ssd_scan_correction`` against
    JAX's on the same inputs: equal (floats to 1e-12 relative: the same
    formulas in another order);
  * the probes are exact: for a reduced model of each family on a (2, 2)
    mesh, ``extrapolate`` over the probe plan gives the full depth's
    count (FLOPs, bytes, collective bytes) exactly, and the peak beyond
    the arguments does not grow with depth;
  * the products-only count of a dense cell equals the closed form
    exactly, and a rank's argument bytes equal its blocks'
    (``local_state_dict`` of the whole model) exactly;
  * the live-bytes tracker gives the known peak of a hand-written
    sequence; each wrapper's ``meta`` branch gives its plain version's
    shapes and reports the closed-form work, launching nothing;
  * the ``--all`` run's record set on a cut of the archs: statuses and
    reasons as JAX's.

Counts are integers carried in floats: equal exactly, unless said."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro.configs import get as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import SUBQUADRATIC as JSUB
from repro.launch import specs as jspecs
from repro.roofline import analysis as janalysis
from repro_torch import configs, models
from repro_torch.configs.base import SHAPES, SUBQUADRATIC, ShapeConfig
from repro_torch.kernels import conv1d_brgemm as k
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import dp_size, make_production_mesh
from repro_torch.models import sharding
from repro_torch.roofline import analysis, flops

ARCHS = dryrun.ARCHS + ["atacworks"]


def test_shapes_and_subquadratic_equal_jax():
    assert {k_: dataclasses.astuple(v) for k_, v in SHAPES.items()} == {
        k_: dataclasses.astuple(v) for k_, v in JSHAPES.items()}
    assert SUBQUADRATIC == JSUB
    assert dryrun.SHAPE_NAMES == list(JSHAPES)


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh(multi):
    mesh = make_production_mesh(multi_pod=multi)
    assert mesh.axis_names == (("pod", "data", "model") if multi
                               else ("data", "model"))
    assert mesh.size == (512 if multi else 256)
    assert dp_size(mesh) == (32 if multi else 16)
    # the data row of the last data rank: pod major
    last = {a: mesh.shape[a] - 1 for a in mesh.axis_names}
    assert sharding.data_index(mesh, last) == dp_size(mesh) - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch):
    """input_specs (names, shapes, dtypes), applicable and pick_accum of
    every shape equal JAX's; pick_accum reads the mesh's names and sizes
    only, so JAX's takes the port's MeshShape."""
    cfg, jcfg = configs.get(arch), jget(arch)
    for name, shape in SHAPES.items():
        got = specs.input_specs(cfg, shape)
        want = jspecs.input_specs(jcfg, JSHAPES[name])
        assert {k_: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k_, t in got.items()} == {
            k_: (tuple(s.shape), str(s.dtype)) for k_, s in want.items()}
        assert all(t.device.type == "meta" for t in got.values())
        assert specs.applicable(cfg, shape) == jspecs.applicable(
            jcfg, JSHAPES[name])
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            assert specs.pick_accum(cfg, shape, mesh) == jspecs.pick_accum(
                jcfg, JSHAPES[name], mesh)


@pytest.mark.parametrize("multi", [False, True])
def test_batch_rows_split_over_pod_and_data(multi):
    """A rank's batch: its data row's share where the global batch
    divides over (pod, data) (JAX's batch_structs), else all of it."""
    mesh = make_production_mesh(multi_pod=multi)
    cfg = configs.get("qwen3-8b")
    dp = dp_size(mesh)
    coords = {a: mesh.shape[a] - 1 for a in mesh.axis_names}
    for name, shape in SHAPES.items():
        b = specs.batch_structs(cfg, shape, mesh, coords)
        n = shape.global_batch // dp if shape.global_batch % dp == 0 \
            else shape.global_batch
        assert all(t.shape[0] == n for t in b.values()), name
        rows = specs.batch_rows(shape, mesh, coords)
        assert rows.stop - rows.start == n


def _jax_probe_view(plan):
    return [(dataclasses.astuple(p.shape), p.accum, p.cfg.n_layers,
             p.cfg.n_encoder_layers, p.cfg.moe.first_dense_layers
             if p.cfg.moe else None) for p in plan]


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_plan_equal_jax(arch):
    cfg, jcfg = configs.get(arch), jget(arch)
    for name, shape in SHAPES.items():
        for accum in (1, 4):
            if shape.kind != "train" and accum > 1:
                continue
            got = analysis.probe_plan(cfg, shape, accum)
            want = janalysis.probe_plan(jcfg, JSHAPES[name], accum)
            assert got[1:] == want[1:], (name, accum)
            if cfg.family == "conv":  # the config itself (its fields differ)
                assert [p.cfg for p in got[0]] == [cfg]
                assert [p.cfg for p in want[0]] == [jcfg]
                continue
            assert _jax_probe_view(got[0]) == _jax_probe_view(want[0])


def _close(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1.0)


def test_extrapolate_and_terms_equal_jax():
    g = torch.Generator().manual_seed(0)
    keys = ("flops", "bytes", "bytes_raw", "coll_bytes")
    for rows, full in (([[1, 1], [1, 2]], [1, 30]),
                       ([[1, 1, 1], [1, 1, 2], [1, 2, 1]], [1, 3, 58]),
                       ([[1, 1, 1], [1, 2, 1], [1, 1, 2], [1, 2, 2]],
                        [1, 4, 9])):
        pm = [{k_: float(torch.randint(1, 10 ** 9, (), generator=g))
               for k_ in keys} for _ in rows]
        got, want = (analysis.extrapolate(pm, rows, full),
                     janalysis.extrapolate(pm, rows, full))
        assert set(got) == set(want) and all(
            _close(got[k_], want[k_]) for k_ in want)
    m = dict(flops=3.1e15, bytes=2.2e12, coll_bytes=4.4e10)
    for mf, mb in ((1e17, 0.0), (5e14, 8e14)):
        got = analysis.roofline_terms(
            m, 256, mf, mb, peak_flops=janalysis.PEAK_FLOPS,
            hbm_bw=janalysis.HBM_BW, link_bw=janalysis.ICI_BW)
        want = janalysis.roofline_terms(m, 256, mf, mb)
        assert got["dominant"] == want["dominant"]
        assert all(_close(got[k_], want[k_]) for k_ in want
                   if k_ != "dominant")


@pytest.mark.parametrize("arch", ["starcoder2-3b", "mamba2-370m",
                                  "zamba2-7b", "deepseek-v3-671b"])
def test_corrections_equal_jax(arch):
    cfg, jcfg = configs.get(arch), jget(arch)
    for flash in (False, True):
        if flash:
            cfg = dataclasses.replace(cfg, attn_impl="flash")
            jcfg = dataclasses.replace(jcfg, attn_impl="flash")
        for name, shape in SHAPES.items():
            for fn in ("flash_correction", "ssd_scan_correction"):
                got = getattr(analysis, fn)(cfg, shape, 256)
                want = getattr(janalysis, fn)(jcfg, JSHAPES[name], 256)
                assert got.keys() == want.keys()
                assert all(_close(got[k_], want[k_]) for k_ in want), fn


def test_axis_rates():
    """(16, 16): the model axis spans two 8-card nodes, the data axis 16;
    a model axis of 8 stays in its node."""
    single = make_production_mesh()
    assert analysis.axis_rate(single, "model") == analysis.NIC_BW
    assert analysis.axis_rate(single, "data") == analysis.NIC_BW
    small = sharding.MeshShape(("data", "model"), (32, 8))
    assert analysis.axis_rate(small, "model") == analysis.NVLINK_BW
    assert analysis.axis_rate(small, ("data",)) == analysis.NIC_BW
    multi = make_production_mesh(multi_pod=True)
    assert analysis.axis_rate(multi, "pod,data") == analysis.NIC_BW
    m = dict(flops=0.0, bytes=0.0, coll_bytes=9e9,
             coll_by_axis={"model": 4.5e9, "data": 4.5e9})
    t = analysis.roofline_terms(m, 256, 1.0, mesh=small)
    assert _close(t["collective_s"], 4.5e9 / 450e9 + 4.5e9 / 50e9)


# --- counting one rank -------------------------------------------------------

MESH22 = sharding.MeshShape(("data", "model"), (2, 2))
# a reduced model of each family, deep enough for every probe, and the
# depth keys its probe plan varies
FAMILIES = {
    "dense": ("qwen3-8b", dict(n_layers=5)),
    "ssm": ("mamba2-370m", dict(n_layers=5)),
    "hybrid": ("zamba2-7b", dict(n_layers=7)),
    "moe": ("moonshot-v1-16b-a3b", dict(n_layers=5)),
    "mla": ("deepseek-v3-671b", dict(n_layers=4)),
    "encdec": ("whisper-large-v3", dict(n_layers=3, n_encoder_layers=3)),
    "vlm": ("internvl2-2b", dict(n_layers=3)),
}
SMALL_SHAPES = [ShapeConfig("p", "prefill", 32, 4),
                ShapeConfig("d", "decode", 32, 4)]


def _cfg(family):
    arch, over = FAMILIES[family]
    return configs.reduced(configs.get(arch), **over)


@pytest.mark.parametrize("shape", SMALL_SHAPES, ids=lambda s: s.kind)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_probes_are_exact(family, shape):
    cfg = _cfg(family)
    full, _ = dryrun.count_cell(cfg, shape, MESH22)
    got, _, probes = dryrun.probed(cfg, shape, MESH22)
    assert len(probes) >= 2
    for key in ("flops", "dot_flops", "bytes", "coll_bytes"):
        assert got[key] == full[key], key
    assert got["coll_by_axis"] == pytest.approx(full["coll_by_axis"],
                                                rel=1e-12)
    assert got["arg_bytes"] == full["arg_bytes"]
    assert got["param_bytes"] == full["param_bytes"]
    # a served rank keeps no activation across layers
    assert got["peak_bytes"] == full["peak_bytes"]
    assert {n: v["calls"] for n, v in got["kernels"].items()} == {
        n: v["calls"] for n, v in full["kernels"].items()}


@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-3b", "qwen2-7b"])
def test_products_of_a_dense_prefill_equal_the_closed_form(arch):
    """The rank's products on a (4, 2) mesh: per layer Q, K, V at the
    rank's heads, the chunked attention's full (T, T) scores and P.V, wo,
    the MLP's column block; then the last position's logits block."""
    mesh = sharding.MeshShape(("data", "model"), (4, 2))
    cfg = configs.reduced(configs.get(arch))
    shape = ShapeConfig("p", "prefill", 64, 4)
    m, meta = dryrun.count_cell(cfg, shape, mesh)
    B, T, D, hd = 1, 64, cfg.d_model, cfg.head_dim
    H, KV = meta["heads"]
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    per = (2 * B * T * D * (H + 2 * KV) * hd + 4 * B * H * T * T * hd
           + 2 * B * T * H * hd * D + mult * 2 * B * T * D * cfg.d_ff // 2)
    assert m["dot_flops"] == cfg.n_layers * per + 2 * B * D * \
        cfg.padded_vocab // 2
    assert m["flops"] > m["dot_flops"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rank_blocks_equal_local_state_dict(family):
    """``models.rank_model`` builds, from shapes alone, the blocks that
    ``sharding.local_state_dict`` cuts from the whole model, on every
    rank of a (2, 2) mesh; the dry-run's parameter bytes are theirs."""
    cfg = _cfg(family)
    whole = models.init_model(cfg, seed=0)
    shape = SMALL_SHAPES[0]
    for d in range(2):
        for m_ in range(2):
            coords = {"data": d, "model": m_}
            want = sharding.local_state_dict(whole, MESH22, coords, cfg=cfg)
            got = models.rank_shapes(cfg, MESH22, coords)
            assert got == {k_: tuple(v.shape) for k_, v in want.items()}
            cell = specs.build_cell(cfg, shape, MESH22, coords)
            assert analysis.tensor_bytes(cell.args[0]) == sum(
                v.numel() * v.element_size() for v in want.values())
            assert {k_: p.dtype for k_, p in
                    cell.args[0].state_dict().items()} == {
                k_: v.dtype for k_, v in want.items()}


def test_rank_model_draws_on_a_device():
    """On a real device with a seed the rank's blocks are drawn there,
    finite, by the leaves' distributions (ones, zeros, normals), the same
    for the same seed."""
    cfg = _cfg("ssm")
    coords = {"data": 1, "model": 1}
    g = sharding.counting_groups(MESH22, coords)
    a, b = (models.rank_model(cfg, MESH22, coords, device="cpu", seed=3,
                              model_group=g["model"], data_group=g["data"])
            for _ in range(2))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k_], sb[k_]) for k_ in sa)
    assert all(bool(torch.isfinite(v).all()) for v in sa.values())
    assert torch.equal(sa["final_norm.scale"],
                       torch.ones_like(sa["final_norm.scale"]))
    assert not sa["layers.mixer.conv_b"].any()
    # A_log: log of the rank's heads' global indices
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    want = torch.log(torch.arange(1, H + 1, dtype=torch.float32))[H // 2:]
    assert torch.equal(sa["layers.mixer.A_log"][0], want)


def test_live_bytes_tracker_peak():
    """A hand-written sequence: x (1,000 fp32) is an argument; a and b
    4,000 bytes each, a view none, the cat 8,000, the sum 4: the most
    alive at once is b and the cat, 12,000 bytes."""
    def seq(x):
        a = x * 2
        b = a + 1
        del a
        c = b.view(10, 100)
        d = torch.cat([c.flatten(), b])
        del d
        return b.sum()

    for device in ("meta", "cpu"):
        x = torch.empty(1000, device=device)
        m = analysis.count_step(seq, (x,))
        assert m["peak_bytes"] == 12000, device
        assert m["arg_bytes"] == 4000
        # mul, add, cat and sum: outputs 1,000, 1,000 and 2,000 elements,
        # the sum's 1,000 inputs
        assert m["flops"] == 1000 + 1000 + 1000
        assert m["bytes"] == 4000 + (4000 + 4000) + (4000 + 4000) \
            + (8000 + 8000) + (4000 + 4)


def test_counter_counts_products_inside_composites():
    a = torch.empty(3, 5, 7, device="meta")
    b = torch.empty(7, 11, device="meta")
    m = analysis.count_step(lambda a, b: torch.matmul(a, b), (a, b))
    assert m["dot_flops"] == 2 * 3 * 5 * 7 * 11


def _report(fn, *args, **kw):
    heard = []

    class L:
        def kernel(self, *r):
            heard.append(r)

    with kmeta.listening(L()):
        out = fn(*args, **kw)
    return out, heard


def test_meta_branches_of_the_wrappers():
    """Each of the six wrappers on ``meta``: its plain version's shapes
    and dtypes (on CPU tensors of the same shapes), one report of the
    closed-form work and the operand and output bytes, no launch."""
    g = torch.Generator().manual_seed(0)

    def both(shape, dtype=torch.float32):
        t = torch.randn(shape, generator=g).to(dtype)
        return t, t.to("meta")

    launches = {f: f.launches for f in (
        k.conv1d_fwd, k.conv1d_bwd_weight, k.depthwise_conv1d_fwd,
        k.depthwise_conv1d_bwd_weight, fa.flash_fwd, fa.flash_bwd)}
    N, C, K, S, d, Q = 2, 3, 4, 5, 2, 16
    W = Q + (S - 1) * d
    (x, xm), (w, wm), (b, bm) = both((N, C, W)), both((S, K, C)), both((K,))
    cases = []
    want, _ = k.conv1d_fwd(x, w, bias=b, dilation=d, save_preact=True), None
    got, heard = _report(k.conv1d_fwd, xm, wm, bias=bm, dilation=d,
                         save_preact=True)
    cases.append((want, got, heard, "conv1d_fwd",
                  flops.conv1d_flops(N, C, K, S, Q),
                  kmeta.nbytes(x, w, b, *want)))
    (go, gom) = both((N, K, Q))
    want = k.conv1d_bwd_weight(x, go, S=S, dilation=d, with_dbias=True)
    got, heard = _report(k.conv1d_bwd_weight, xm, gom, S=S, dilation=d,
                         with_dbias=True)
    cases.append((want, got, heard, "conv1d_bwd_weight",
                  flops.conv1d_flops(N, C, K, S, Q) + N * K * Q,
                  kmeta.nbytes(x, go, *want)))
    (wd, wdm), (bd, bdm) = both((S, C)), both((C,))
    want = k.depthwise_conv1d_fwd(x, wd, bias=bd, dilation=d,
                                  activation="silu")
    got, heard = _report(k.depthwise_conv1d_fwd, xm, wdm, bias=bdm,
                         dilation=d, activation="silu")
    cases.append((want, got, heard, "depthwise_conv1d_fwd",
                  flops.conv1d_flops(N, C, 1, S, Q),
                  kmeta.nbytes(x, wd, bd, want)))
    (gd, gdm) = both((N, C, Q))
    want = k.depthwise_conv1d_bwd_weight(x, gd, S=S, dilation=d)
    got, heard = _report(k.depthwise_conv1d_bwd_weight, xm, gdm, S=S,
                         dilation=d)
    cases.append((want, got, heard, "depthwise_conv1d_bwd_weight",
                  flops.conv1d_flops(N, C, 1, S, Q),
                  kmeta.nbytes(x, gd, want)))
    B, T, KV, G, hd = 2, 24, 2, 3, 16
    (q, qm), (kk, km), (v, vm) = (both((B, T, KV, G, hd)),
                                  both((B, T, KV, hd)), both((B, T, KV, hd)))
    want = fa.flash_fwd(q, kk, v, causal=True)
    got, heard = _report(fa.flash_fwd, qm, km, vm, causal=True)
    cases.append((want, got, heard, "flash_fwd",
                  flops.flash_fwd_flops(B, T, T, KV * G, hd, True),
                  kmeta.nbytes(q, kk, v, *want)))
    o, lse = want
    (do, dom) = both((B, T, KV, G, hd))
    want = fa.flash_bwd(q, kk, v, o, lse, do, causal=True)
    got, heard = _report(fa.flash_bwd, qm, km, vm, o.to("meta"),
                         lse.to("meta"), dom, causal=True)
    cases.append((want, got, heard, "flash_bwd",
                  3.5 * flops.flash_fwd_flops(B, T, T, KV * G, hd, True),
                  kmeta.nbytes(q, kk, v, o, lse, do, *want)))
    for want, got, heard, name, fl, nb in cases:
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(t.shape), t.dtype) for t in got] == [
            (tuple(t.shape), t.dtype) for t in want], name
        assert all(t.device.type == "meta" for t in got)
        assert heard == [(name, fl, nb)], name
    # the causal flash forward's closed form is the model count's
    cfg = configs.get("starcoder2-3b")
    assert flops.flash_fwd_flops(4, 4096, 4096, cfg.n_heads, cfg.head_dim) \
        * cfg.n_layers == flops._attn_seq_flops(cfg, 4, 4096)
    assert all(f.launches == n for f, n in launches.items())


def test_counting_group_records_and_fills():
    g = sharding.CountingGroup(4, rank=2, axis="model")
    t = torch.arange(6, dtype=torch.float32).view(2, 3)
    parts = [torch.empty_like(t) for _ in range(4)]
    g.all_gather(parts, t)
    assert all(torch.equal(p, t) for p in parts)
    out = torch.empty(4 * 6)
    g.all_gather_into_tensor(out, t.flatten())
    assert torch.equal(out.view(4, 6), t.flatten().expand(4, 6))
    red = torch.empty(6)
    g.reduce_scatter_tensor(red, torch.arange(24, dtype=torch.float32))
    assert torch.equal(red, torch.arange(12, 18, dtype=torch.float32))
    g.all_reduce(t)
    assert g.calls == [("all-gather", "model", 24), ("all-gather", "model",
                                                     24),
                       ("reduce-scatter", "model", 96),
                       ("all-reduce", "model", 24)]
    mg = sharding.ModelGroup(g)
    assert (mg.size, mg.rank) == (4, 2)
    with pytest.raises(ValueError):
        sharding.CountingGroup(2, rank=2)


def test_dryrun_cli_records(tmp_path):
    """``main`` over two archs and every shape on both meshes: JAX's
    statuses and reasons, a language model's train cell skipped naming
    queue A item 9, the records' keys, and a second run served from the
    file."""
    out = tmp_path / "d.json"
    argv = ["--arch", "mamba2-370m", "--out", str(out)]
    assert dryrun.main(argv) == 0
    db = json.loads(out.read_text())
    assert len(db) == 8
    for key, rec in db.items():
        arch, shape, mesh = key.split("|")
        if shape == "train_4k":
            assert rec["status"] == "skip" and "item 9" in rec["why"]
            continue
        assert rec["status"] == "ok", key
        assert rec["n_chips"] == (256 if mesh == "single" else 512)
        assert rec["memory"]["fits"] is True
        assert rec["terms"]["dominant"] in ("compute", "memory",
                                            "collective")
        assert rec["per_device"]["kernels"].get(
            "depthwise_conv1d_fwd", {}).get("calls", 0) == (
            48 if shape == "prefill_32k" else 0)
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape", "long_500k",
                        "--mesh", "single", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())["starcoder2-3b|long_500k|single"]
    assert rec == dict(arch="starcoder2-3b", shape="long_500k",
                       mesh="single", status="skip",
                       why=jspecs.applicable(
                           jget("starcoder2-3b"), JSHAPES["long_500k"])[1])
