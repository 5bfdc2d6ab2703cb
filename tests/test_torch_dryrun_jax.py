"""A dry-run rank's argument bytes against the JAX package's placement,
each JAX side in a subprocess (its device count is set before JAX
starts, as ``repro/launch/dryrun.py`` sets it):

  * at production scale, with no compile: on 512 placeholder devices,
    for every language-model arch x serving shape (JAX's ``applicable``)
    on both production meshes, the bytes of
    ``NamedSharding(mesh, spec).shard_shape(leaf.shape)`` over the leaves
    of JAX's ``build_cell`` arguments (``eval_shape`` only);
  * the reduced configs of ``tests/test_dryrun_machinery.py`` on a (4, 2)
    mesh of 8 devices the same way, and one compiled cell, whose
    ``memory_analysis().argument_size_in_bytes`` they must equal.

The port's rank (``launch/specs.py build_cell``, the mesh's origin)
holds exactly JAX's bytes under JAX's rules, except for the known
divergences, which the test computes leaf by leaf (the port's block
against JAX's even block under the same spec) and states:

  * an SSM rank's fused ``in_proj``, ``conv_w``, ``conv_b`` and its
    cache's conv state hold B and C whole (``sharding.segment_block``);
  * the attention's leaves take head-aligned blocks
    (``sharding.head_blocks``): where the KV heads do not divide the
    model axis a rank holds whole KV heads (replicated) and its query
    heads' block, and its cache's K and V (and Whisper's cross K and V)
    hold whole heads where JAX splits head_dim;
  * an MLA rank's cache holds the ``c_kv`` latent whole, where JAX
    splits it on ``'model'``;
  * an SSM rank's recurrent state is fp32 (``mamba2.init_block_state``:
    JAX's decode returns it in fp32 from its first step on), where JAX's
    Mamba2 cache takes the dry-run's bf16 (its Zamba2 cache keeps fp32);
  * JAX's decode takes ``pos`` as a 4-byte int32 argument, the port as a
    Python int.

Every other leaf, and the totals under JAX's rules as the port computes
them (``sharding.param_pspecs``, ``cache_pspecs``), equal JAX's
exactly."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs, models
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding
from repro_torch.roofline import analysis
from repro_torch.train.serve_step import make_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's argument bytes a cell: "params", "cache:<leaf name>" (summed over
# the tree), "batch:<name>" (a decode's tokens "batch:2", pos "batch:3")
_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(n)d"
import json, re
import jax, numpy as np
from repro import configs
from repro.configs.base import SHAPES, ShapeConfig, reduced
from repro.launch.mesh import compat_make_mesh, make_production_mesh
from repro.launch.specs import applicable, build_cell, lower_cell
from repro.roofline import analysis as ra


def groups(cell, kind):
    out = {}
    for i, arg in enumerate(cell.args):
        for path, leaf in jax.tree_util.tree_flatten_with_path(arg)[0]:
            n = int(np.prod(leaf.sharding.shard_shape(leaf.shape))) \
                * leaf.dtype.itemsize
            names = re.findall(r"'([^']+)'", jax.tree_util.keystr(path))
            g = ("params" if i == 0 else "cache:" + names[-1]
                 if i == 1 and kind == "decode"
                 else "batch:" + (names[-1] if names else str(i)))
            out[g] = out.get(g, 0) + n
            if g.startswith("cache:"):
                out["itemsize:" + g[6:]] = leaf.dtype.itemsize
    return out


out = {}
for mesh_name, arch, shape_name, kind, seq, batch in %(cells)s:
    if mesh_name == "reduced":
        cfg = reduced(configs.get(arch))
        mesh = compat_make_mesh((4, 2), ("data", "model"))
        shape = ShapeConfig(shape_name, kind, seq, batch)
    else:
        cfg = configs.get(arch)
        mesh = make_production_mesh(multi_pod=mesh_name == "multi")
        shape = SHAPES[shape_name]
    if not applicable(cfg, shape)[0]:
        continue
    out["|".join((arch, shape_name, mesh_name))] = groups(
        build_cell(cfg, shape, mesh), shape.kind)
for arch, shape_name, kind, seq, batch in %(compiled)s:
    cfg = reduced(configs.get(arch))
    mesh = compat_make_mesh((4, 2), ("data", "model"))
    lowered, _ = lower_cell(cfg, ShapeConfig(shape_name, kind, seq, batch),
                            mesh)
    compiled = lowered.compile()
    out["compiled|" + arch + "|" + shape_name] = dict(
        argument_size_in_bytes=compiled.memory_analysis()
        .argument_size_in_bytes,
        flops=ra.compile_metrics(compiled)["flops"])
print("JSON:" + json.dumps(out))
"""


def _run_jax(n_devices, cells, compiled=()):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD % dict(n=n_devices, cells=repr(cells),
                                             compiled=repr(list(compiled)))],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("JSON:"))
    return json.loads(line[5:])


def _nbytes(shape, dtype) -> int:
    return int(torch.Size(shape).numel()) * dtype.itemsize


def _walk(tree, name=None):
    """(leaf name, tensor) of a cache tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, k)
    else:
        yield name, tree


def _port_groups(cfg, shape, mesh, itemsize):
    """The port's rank at the origin: its bytes by JAX's groups, and the
    divergences from JAX's even blocks (in JAX's dtypes, ``itemsize`` of
    each cache leaf name), leaf by leaf."""
    cell = specs.build_cell(cfg, shape, mesh)
    origin = {a: 0 for a in mesh.axis_names}
    rank = models.rank_shapes(cfg, mesh, origin)
    leaves = models.leaf_spec(cfg)
    pspecs = sharding.param_pspecs(models.leaf_shapes(cfg), mesh)
    got, even, div = {}, {}, {"ssm": 0, "heads": 0, "cache heads": 0,
                              "cache conv": 0, "c_kv": 0, "ssm state": 0}
    for k, (shape_, _, _, dtype) in leaves.items():
        mine = _nbytes(rank[k], dtype)
        jaxs = _nbytes(sharding.local_shape(shape_, pspecs[k], mesh), dtype)
        got["params"] = got.get("params", 0) + mine
        even["params"] = even.get("params", 0) + jaxs
        name = k.split(".")[-1]
        if mine != jaxs:
            if cfg.ssm is not None and name in sharding.SSM_SEGMENTS:
                div["ssm"] += mine - jaxs
            elif sharding.leaf_heads(cfg, k):
                div["heads"] += mine - jaxs
            else:
                raise AssertionError(f"{k}: {mine} bytes against JAX's "
                                     f"{jaxs} with no known divergence")
    assert got["params"] == analysis.tensor_bytes(cell.args[0])
    if shape.kind == "decode":
        model, cache, tokens, _ = cell.args
        whole = make_cache(cfg, shape.global_batch, shape.seq_len,
                           dtype=torch.bfloat16, device="meta")
        cspecs = sharding.cache_pspecs(whole, mesh, shape.global_batch)
        for (name, t), (_, w), (_, s) in zip(_walk(cache), _walk(whole),
                                             _walk(cspecs)):
            key = "cache:" + name
            mine = t.numel() * t.element_size()
            jaxs = int(torch.Size(sharding.local_shape(
                w.shape, s, mesh)).numel()) * itemsize[name]
            got[key] = got.get(key, 0) + mine
            even[key] = even.get(key, 0) + jaxs
            if mine == jaxs:
                continue
            kind = {"k": "cache heads", "v": "cache heads",
                    "cross_k": "cache heads", "cross_v": "cache heads",
                    "conv": "cache conv", "c_kv": "c_kv",
                    # the state's dtype, not its block
                    "ssm": "ssm state"}.get(name)
            assert kind is not None, (name, mine, jaxs)
            div[kind] += mine - jaxs
        got["batch:2"] = even["batch:2"] = tokens.numel() * 4
        even["batch:3"] = 4   # JAX's pos, an int32 argument
    else:
        for name, t in cell.args[1].items():
            got["batch:" + name] = even["batch:" + name] = \
                t.numel() * t.element_size()
    return got, even, div


def _itemsizes(groups) -> dict:
    return {k[9:]: v for k, v in groups.items() if k.startswith("itemsize:")}


def _check(key, cfg, mesh, jax_groups, got, even, div):
    """JAX's groups equal the port's computation of JAX's even blocks;
    the port's bytes are those plus the divergences (less JAX's pos)."""
    assert even == {k: v for k, v in jax_groups.items()
                    if not k.startswith("itemsize:")}, key
    mp = mesh.shape["model"]
    ssm = cfg.ssm is not None
    assert (div["ssm"] > 0) == ssm and (div["cache conv"] > 0) == (
        ssm and "cache:conv" in got), (key, div)
    assert (div["ssm state"] > 0) == (
        "cache:ssm" in got and jax_groups["itemsize:ssm"] == 2), key
    assert (div["c_kv"] > 0) == ("cache:c_kv" in got and mp > 1), key
    if cfg.n_heads and cfg.mla is None and cfg.n_kv_heads % mp == 0 \
            and cfg.n_heads % mp == 0:
        assert div["heads"] == div["cache heads"] == 0, (key, div)
    total = sum(got.values())
    assert total == sum(even.values()) - even.get("batch:3", 0) + sum(
        div.values()), key
    return total


LM_ARCHS = dryrun.ARCHS
SERVING = ("prefill_32k", "decode_32k", "long_500k")


def test_argument_bytes_match_jax_at_production_scale(capsys):
    cells = [(m, a, s, None, None, None) for m in ("single", "multi")
             for a in LM_ARCHS for s in SERVING]
    jax_out = _run_jax(512, cells)
    seen = 0
    stated = []
    for mesh_name in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=mesh_name == "multi")
        for arch in LM_ARCHS:
            cfg = configs.get(arch)
            for s in SERVING:
                key = f"{arch}|{s}|{mesh_name}"
                if not specs.applicable(cfg, SHAPES[s])[0]:
                    assert key not in jax_out
                    continue
                got, even, div = _port_groups(cfg, SHAPES[s], mesh,
                                             _itemsizes(jax_out[key]))
                total = _check(key, cfg, mesh, jax_out[key], got, even, div)
                stated.append(f"{key}: {total} bytes, divergences "
                              + json.dumps({k: v for k, v in div.items()
                                            if v}))
                seen += 1
    assert seen == 44 == len(jax_out)
    with capsys.disabled():
        print("\n" + "\n".join(stated))


REDUCED_ARCHS = ["qwen3-8b", "mamba2-370m", "moonshot-v1-16b-a3b",
                 "whisper-large-v3", "zamba2-7b", "internvl2-2b",
                 "atacworks"]
REDUCED_SHAPES = (("p", "prefill", 64, 4), ("d", "decode", 64, 8))


def test_reduced_cells_match_jax_and_memory_analysis(capsys):
    """The archs of tests/test_dryrun_machinery.py on a (4, 2) mesh: the
    argument bytes of each serving cell as above, and JAX's compiled
    qwen3-8b decode's argument_size_in_bytes (pos included) equal to the
    port's rank's plus 4; JAX's compile_metrics FLOPs beside the port's
    count (reported, not gated: XLA counts what its fusions keep, the
    port every eager operation)."""
    mesh = sharding.MeshShape(("data", "model"), (4, 2))
    cells = [("reduced", a, *s) for a in REDUCED_ARCHS
             for s in REDUCED_SHAPES]
    compiled = [("qwen3-8b", *REDUCED_SHAPES[1]),
                ("qwen3-8b", *REDUCED_SHAPES[0])]
    jax_out = _run_jax(8, cells, compiled)
    lines = []
    for arch in REDUCED_ARCHS:
        cfg = configs.reduced(configs.get(arch))
        for name, kind, seq, batch in REDUCED_SHAPES:
            shape = ShapeConfig(name, kind, seq, batch)
            key = f"{arch}|{name}|reduced"
            if not specs.applicable(cfg, shape)[0]:
                assert key not in jax_out and cfg.family == "conv"
                continue
            got, even, div = _port_groups(cfg, shape, mesh,
                                          _itemsizes(jax_out[key]))
            _check(key, cfg, mesh, jax_out[key], got, even, div)
    for arch, name, kind, seq, batch in compiled:
        cfg = configs.reduced(configs.get(arch))
        shape = ShapeConfig(name, kind, seq, batch)
        m, _ = dryrun.count_cell(cfg, shape, mesh)
        j = jax_out[f"compiled|{arch}|{name}"]
        assert j["argument_size_in_bytes"] == m["arg_bytes"] + (
            4 if kind == "decode" else 0)
        lines.append(f"{arch} {kind} (4, 2): JAX compile_metrics flops "
                     f"{j['flops']:.4e}, the port's count {m['flops']:.4e} "
                     f"(products {m['dot_flops']:.4e})")
    with capsys.disabled():
        print("\n" + "\n".join(lines))


@pytest.mark.parametrize("shape", [ShapeConfig("d", "decode", 32, 4)],
                         ids=["decode"])
def test_counts_are_the_same_on_every_data_row(shape):
    """A (2, 2) mesh's ranks of one model column count the same work
    (their rows differ, not their shapes)."""
    cfg = configs.reduced(configs.get("qwen3-8b"))
    mesh = sharding.MeshShape(("data", "model"), (2, 2))
    a, _ = dryrun.count_cell(cfg, shape, mesh, {"data": 0, "model": 0})
    b, _ = dryrun.count_cell(cfg, shape, mesh, {"data": 1, "model": 0})
    assert {k: a[k] for k in ("flops", "bytes", "coll_bytes", "arg_bytes")
            } == {k: b[k] for k in ("flops", "bytes", "coll_bytes",
                                    "arg_bytes")}
