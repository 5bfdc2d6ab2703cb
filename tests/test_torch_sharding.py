"""The port's placement rules (``repro_torch.models.sharding``) against
the JAX package's ``repro/models/sharding.py``, in-process, on no devices.

For every config the JAX package registers, its parameter tree's shapes
come from ``jax.eval_shape`` of ``init_params``; the JAX rules read a
stand-in mesh that has only ``axis_names`` and ``shape``, and the port's
read a ``MeshShape`` of the same names and sizes, on the meshes (1, 2),
(2, 2), (16, 16) and (2, 16, 16).  The logical specs and the mesh specs
must be equal key by key (a JAX spec as ``tuple(PartitionSpec)``), as
must the cache specs (at a batch that divides the data axes and one that
does not) and the batch spec.  The blocks ``local_state_dict`` gives each
coordinate of (1, 2) and (2, 2) on the reduced fp32 configs must be the
numpy slices of JAX's tree that JAX's ``NamedSharding`` gives the device
there: a JAX child on 4 virtual devices computes the slices
(``devices_indices_map``) once a module.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.core import blocks as jblocks
from repro.models import get_model as jget_model
from repro.models import sharding as jshd
from repro.train import serve_step as jserve_step
from repro_torch import configs, convert
from repro_torch.configs.base import reduced
from repro_torch.models import sharding, transformer
from repro_torch.train import serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tuple(jconfigs.names())
LM_ARCHS = tuple(a for a in ARCHS if jconfigs.get(a).family != "conv")
MESHES = {"1x2": (("data", "model"), (1, 2)),
          "2x2": (("data", "model"), (2, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
# the meshes the blocks are checked on (the JAX child's 4 devices)
BLOCK_MESHES = ("1x2", "2x2")


class _JaxMesh:
    """What JAX's rules read of a mesh: its axis names and sizes."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _key(path) -> str:
    return ".".join(jshd._key_name(k) for k in path)


def _flat(tree, is_leaf=None) -> dict:
    return {_key(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _is_spec(x):
    return isinstance(x, (tuple, P)) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


@functools.cache
def _jax_shapes(arch: str):
    cfg = jconfigs.get(arch)
    init = (jblocks.init_params if cfg.family == "conv"
            else jget_model(cfg).init_params)
    return jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_jaxs(arch, mesh):
    """Logical and mesh specs of every leaf equal JAX's; a transformer's
    leaves (the port's own spec) have JAX's keys and shapes."""
    tree = _jax_shapes(arch)
    shapes = _shapes(tree)
    jmesh = _JaxMesh(*MESHES[mesh])
    want_logical = _flat(jshd.logical_param_specs(tree), is_leaf=_is_spec)
    want = {k: tuple(v) for k, v in _flat(
        jshd.param_pspecs(tree, jmesh), is_leaf=_is_spec).items()}
    assert sharding.logical_param_specs(shapes) == want_logical
    got = sharding.param_pspecs(shapes, sharding.MeshShape(*MESHES[mesh]))
    assert got == want
    cfg = configs.get(arch)
    if cfg.family in ("dense", "moe", "vlm"):
        assert {k: v[0] for k, v in transformer._leaf_spec(cfg).items()} \
            == shapes


@pytest.mark.parametrize("experts, mesh, bound", [
    (8, (1, 2), True), (8, (2, 2), True), (6, (2, 2), False),
    (8, (1, 3), False)])
def test_ep_binds_or_falls_back_as_jaxs(experts, mesh, bound):
    """The expert stacks' ``ep`` binds the combined (data, model) axes
    when the expert count divides them (dropping ``dp``), else falls back
    to ``mp``; without shapes it degrades to ``mp``."""
    jcfg = jreduced(jconfigs.get("moonshot-v1-16b-a3b"))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=experts))
    tree = jax.eval_shape(lambda k: jget_model(jcfg).init_params(k, jcfg),
                          jax.random.key(0))
    names = ("data", "model")
    want = {k: tuple(v) for k, v in _flat(jshd.param_pspecs(
        tree, _JaxMesh(names, mesh)), is_leaf=_is_spec).items()}
    m = sharding.MeshShape(names, mesh)
    got = sharding.param_pspecs(_shapes(tree), m)
    assert got == want
    key = "moe_layers.moe.w_gate"
    assert got[key] == ((None, ("data", "model"), None, None) if bound
                        else (None, "model", "data", None))
    degraded = sharding.to_mesh_specs(
        sharding.logical_param_specs(_shapes(tree)), m)
    assert degraded[key] == (None, "model", "data", None)
    want_degraded = jshd.to_mesh_specs(jshd.logical_param_specs(tree),
                                       _JaxMesh(names, mesh))
    assert degraded == {k: tuple(v) for k, v in _flat(
        want_degraded, is_leaf=_is_spec).items()}


@pytest.mark.parametrize("batch", (32, 3))
@pytest.mark.parametrize("mesh", ("2x2", "16x16", "2x16x16"))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_are_jaxs(arch, mesh, batch):
    """``cache_pspecs`` of the port's cache tree (made on the ``meta``
    device at full width) equal JAX's of its own, at a batch that divides
    the data axes and one that does not; the trees have the same keys
    and shapes."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    jcache = jax.eval_shape(lambda: jserve_step.make_cache(
        jcfg, batch, 16, dtype=jax.numpy.float32))
    cache = serve_step.make_cache(cfg, batch, 16, dtype=torch.float32,
                                  device="meta")
    flat = {k: tuple(v.shape) for k, v in _flat(cache).items()}
    assert flat == _shapes(jcache)
    want = {k: tuple(v) for k, v in _flat(jshd.cache_pspecs(
        jcache, _JaxMesh(*MESHES[mesh]), batch), is_leaf=_is_spec).items()}
    got = sharding.cache_pspecs(cache, sharding.MeshShape(*MESHES[mesh]),
                                batch)
    assert _flat(got, is_leaf=_is_spec) == want


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_spec_is_jaxs(mesh):
    assert sharding.batch_pspec(sharding.MeshShape(*MESHES[mesh])) == \
        tuple(jshd.batch_pspec(_JaxMesh(*MESHES[mesh])))


def test_mla_cache_keeps_the_latent_whole():
    """JAX's ``cache_pspecs`` splits MLA's latent ``c_kv`` on its rank
    dimension; a tensor-parallel rank of the port keeps it whole (each of
    its heads reads all of it), and k/v of a GQA model hold the block the
    spec gives them."""
    m = sharding.MeshShape(("data", "model"), (1, 2))
    ds = reduced(configs.get("deepseek-v3-671b"))
    whole = serve_step.make_cache(ds, 2, 8, dtype=torch.float32)
    rank = serve_step.make_cache(ds, 2, 8, dtype=torch.float32, mp=2)
    spec = sharding.cache_pspecs(whole, m, 2)
    assert spec["moe"]["c_kv"] == (None, "data", None, "model")
    assert sharding.local_shape(whole["moe"]["c_kv"].shape,
                                spec["moe"]["c_kv"], m) != \
        tuple(rank["moe"]["c_kv"].shape)
    assert rank["moe"]["c_kv"].shape == whole["moe"]["c_kv"].shape
    sc = reduced(configs.get("starcoder2-3b"))
    whole = serve_step.make_cache(sc, 2, 8, dtype=torch.float32)
    rank = serve_step.make_cache(sc, 2, 8, dtype=torch.float32, mp=2)
    spec = sharding.cache_pspecs(whole, m, 2)
    for k in ("k", "v"):
        assert tuple(rank["dense"][k].shape) == sharding.local_shape(
            whole["dense"][k].shape, spec["dense"][k], m)


def test_local_block_tiles_and_refuses_uneven():
    """The blocks of a (2, 2) mesh tile the tensor, an axis tuple splits
    its dimension data-major, and a dimension that does not divide
    raises."""
    m = sharding.MeshShape(("data", "model"), (2, 2))
    t = torch.arange(4 * 6).reshape(4, 6)
    spec = ("data", "model")
    got = torch.cat([torch.cat([sharding.local_block(t, spec, m, (d, c))
                                for c in range(2)], 1) for d in range(2)], 0)
    assert torch.equal(got, t)
    rows = [sharding.local_block(t, (("data", "model"), None), m,
                                 {"data": d, "model": c})
            for d in range(2) for c in range(2)]
    assert torch.equal(torch.cat(rows), t)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_block(torch.zeros(3, 4), ("model", None), m, (0, 0))
    with pytest.raises(ValueError, match="off the mesh"):
        sharding.local_block(t, spec, m, (2, 0))


_JAX_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro import configs
from repro.configs.base import reduced
from repro.core import blocks
from repro.models import get_model
from repro.models import sharding as shd
archs, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for arch in archs:
    cfg = reduced(configs.get(arch))
    init = blocks.init_params if cfg.family == "conv" else \
        get_model(cfg).init_params
    tree = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
    for name, (axes, sizes) in meshes.items():
        mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(
            sizes), axes)
        specs = shd.param_pspecs(tree, mesh)
        flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_s = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        blocks_ = {}
        for (path, leaf), spec in zip(flat_t, flat_s):
            key = ".".join(shd._key_name(k) for k in path)
            m = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            for dev, idx in m.items():
                pos = np.argwhere(mesh.devices == dev)[0].tolist()
                blocks_.setdefault(",".join(map(str, pos)), {})[key] = [
                    [s.start, s.stop] for s in idx]
        out[f"{arch}/{name}"] = blocks_
print(json.dumps(out))
"""


@functools.cache
def _jax_blocks() -> dict:
    """``"arch/mesh" -> {"d,m": {key: [[start, stop], ...]}}``: the index
    ranges of each leaf that JAX's sharding gives the device at each
    coordinate, from a JAX child on 4 virtual devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD, json.dumps(ARCHS),
         json.dumps({m: MESHES[m] for m in BLOCK_MESHES})],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@functools.cache
def _reduced_tree(arch):
    """The reduced config's tree of JAX's shapes, each leaf numbered
    0, 1, ... in fp32 (exact), so a wrong slice cannot match."""
    cfg = jreduced(jconfigs.get(arch))
    init = (jblocks.init_params if cfg.family == "conv"
            else jget_model(cfg).init_params)
    tree = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
    return jax.tree.map(lambda t: np.arange(
        np.prod(t.shape), dtype=np.float32).reshape(t.shape), tree)


@pytest.mark.parametrize("mesh", BLOCK_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_state_dict_is_jaxs_slice(arch, mesh):
    """Every coordinate's ``local_state_dict`` (the port's state dict of
    the reduced fp32 config, converted from a JAX tree of its shapes)
    holds exactly the slice of that tree that JAX's spec gives that
    device."""
    tree = _reduced_tree(arch)
    flat = _flat(tree)
    sd = convert.params_from_jax(tree)
    m = sharding.MeshShape(*MESHES[mesh])
    want = _jax_blocks()[f"{arch}/{mesh}"]
    assert len(want) == m.size
    for pos, ranges in want.items():
        coords = tuple(int(c) for c in pos.split(","))
        got = sharding.local_state_dict(sd, m, coords)
        assert set(got) == set(ranges) == set(flat)
        for key, rng in ranges.items():
            ref = flat[key][tuple(slice(a, b) for a, b in rng)]
            np.testing.assert_array_equal(got[key].numpy(), ref,
                                          err_msg=f"{key} at {pos}")


@pytest.mark.parametrize("arch", ("starcoder2-3b", "deepseek-v3-671b"))
def test_convert_gives_a_ranks_blocks(arch):
    """``params_from_jax`` and ``cache_from_jax`` given a mesh and
    coordinates hold the rank's blocks: the parameters'
    ``local_state_dict``; the cache's k/v the KV/mp heads of the rank
    (``make_cache(mp=)``'s shapes), an MLA latent whole."""
    m = sharding.MeshShape(("data", "model"), (1, 2))
    tree = _reduced_tree(arch)
    sd = convert.params_from_jax(tree)
    jcache = jax.eval_shape(lambda: jserve_step.make_cache(
        jreduced(jconfigs.get(arch)), 2, 8, dtype=jax.numpy.float32))
    jcache = jax.tree.map(lambda t: np.arange(
        np.prod(t.shape), dtype=np.float32).reshape(t.shape), jcache)
    whole = _flat(convert.cache_from_jax(jcache))
    cfg = reduced(configs.get(arch))
    shapes = {k: tuple(v.shape) for k, v in _flat(serve_step.make_cache(
        cfg, 2, 8, dtype=torch.float32, mp=2)).items()}
    for c in range(2):
        got = convert.params_from_jax(tree, mesh=m, coords=(0, c))
        want = sharding.local_state_dict(sd, m, (0, c))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        cache = _flat(convert.cache_from_jax(jcache, mesh=m, coords=(0, c)))
        assert {k: tuple(v.shape) for k, v in cache.items()} == shapes
        for k, t in cache.items():
            if k.endswith((".k", ".v")):
                n = t.shape[3]
                assert torch.equal(t, whole[k][:, :, :, c * n:(c + 1) * n])
            else:
                assert torch.equal(t, whole[k]), k
