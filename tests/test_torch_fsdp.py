"""FSDP training of the port's language models on the ``'data'`` axis
(``models.fsdp_model``, ``models/sharding.py DataShards``, the FSDP
branch of ``train/data_parallel.py``, the step's norm over blocks,
checkpoints, ``convert.train_state_from_jax(..., group=)`` and the
launcher's ``path=fsdp``) against the JAX package's launcher placement,
and ``convert``'s segment-aligned blocks of a tensor-parallel SSM rank.

The JAX side runs in child processes on 2 virtual CPU devices: for the
reduced fp32 config of each language-model family (dense StarCoder2, ssm
Mamba2, hybrid Zamba2, moe Moonlight with its experts on ``'ep'``, mla
DeepSeek-V3, encdec Whisper, vlm InternVL2) it places the parameters as
its launcher's ``_build_state`` does on a ``(2, 1)`` ``("data",
"model")`` mesh and the batch on ``batch_pspec``, and runs its jitted
``make_train_step`` (the GSPMD path) for 2 steps.  The port's side is one
spawn of 2 gloo ranks (``torch_fsdp_ranks``) that trains the same
weights on the same global batches, each rank on its half.  The weights
are drawn with numpy in the JAX tree's shapes, every norm and bias
random.

Tolerances: losses within rtol 1e-5, every parameter after 2 steps
within 1e-5 absolute (fp32 sums in another order and over ranks; lr
1e-3); each rank's blocks, and its first gradient's blocks against the
whole-parameter data-parallel path's on the same rank, bitwise (a sum of
two does not depend on its order); the elastic drill within
``chip_smoke.py``'s EL_RTOL and EL_ATOL.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import get_model as jget_model
from repro_torch import configs, convert, models
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import reduced
from repro_torch.data import synthetic
from repro_torch.models import sharding
from repro_torch.train.train_step import init_state

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_fsdp_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"dense": "starcoder2-3b", "ssm": "mamba2-370m",
         "hybrid": "zamba2-7b", "moe": "moonshot-v1-16b-a3b",
         "mla": "deepseek-v3-671b", "encdec": "whisper-large-v3",
         "vlm": "internvl2-2b"}
BATCH, SEQ, STEPS, LR = 4, 32, 2, 1e-3
KW = dict(peak_lr=LR, warmup_steps=2, total_steps=STEPS)
TOL = 1e-5
EL_RTOL, EL_ATOL = 1e-3, 1e-4  # chip_smoke.py's elastic drill
# Whisper's self-attention K bias: its exact gradient is zero (the softmax
# ignores q . bk), so both packages step it on rounding noise, which AdamW
# turns into steps of up to lr of either sign: held within 2 lr a step,
# as test_torch_whisper.py holds it
ZERO_GRAD = ("enc_layers.attn.bk", "dec_layers.attn.bk")
# the 1-D leaves made random about their value (as test_torch_tp_serve_ssm)
JITTER = {"scale": 1.0, "bias": 0.0, "bq": 0.0, "bk": 0.0, "bv": 0.0,
          "bo": 0.0, "b_up": 0.0, "b_down": 0.0}
PROMPT, GEN = 6, 4  # the tensor-parallel Mamba2 rank's decode
# the JAX references in two children side by side (about 25 s each)
JAX_CHILDREN = (("hybrid", "encdec", "vlm", "dense"),
                ("ssm", "moe", "mla", "moe_capacity"))
# cases beside CASES' families: (arch, MoE overrides); Moonlight's
# capacity dispatch drops assignments ranked over the global batch
EXTRA = {"moe_capacity": ("moonshot-v1-16b-a3b", {"capacity_factor": 1.0})}
# the cases whose JAX child also returns the first gradient
WITH_GRAD = ("moe_capacity",)
LAUNCH = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
          "--dist-backend", "gloo", "--steps", "6", "--batch", "4",
          "--seq", "16", "--ckpt-every", "2"]


@functools.cache
def _case(name):
    """The case's weights in the JAX tree's shapes, drawn with numpy (a
    matrix normal by fan-in ** -0.5, JITTER's leaves about their value,
    other vectors normal), and STEPS global batches as numpy."""
    arch, moe_kw = EXTRA.get(name, (CASES.get(name), {}))
    jcfg, cfg = jreduced(jconfigs.get(arch)), reduced(configs.get(arch))
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    tree = jax.eval_shape(lambda k: jget_model(jcfg).init_params(k, jcfg),
                          jax.random.key(0))
    rng = np.random.default_rng(11)

    def draw(path, t):
        base = JITTER.get(path[-1].key)
        a = rng.standard_normal(t.shape)
        if base is not None:
            a = base + 0.1 * a
        elif len(t.shape) > 1:
            a = a * t.shape[-2] ** -0.5
        return a.astype(t.dtype)

    batches = [{k: np.asarray(v.float() if torch.is_tensor(v) else v)
                for k, v in synthetic.make_batch(cfg, BATCH, SEQ,
                                                 seed=100 + i).items()}
               for i in range(STEPS)]
    return dict(arch=arch, moe_kw=moe_kw, cfg=cfg,
                jparams=jax.tree_util.tree_map_with_path(draw, tree),
                batches=batches)


_JAX_CHILD = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import pickle
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.configs.base import reduced
from repro.launch.mesh import compat_make_mesh
from repro.models import sharding as shd
from repro.train.losses import make_loss_fn
from repro.train.train_step import init_state, make_train_step

with open(sys.argv[1], "rb") as f:
    cases, kw = pickle.load(f)
assert len(jax.devices()) == 2
mesh = compat_make_mesh((2, 1), ("data", "model"))
named = lambda s: jax.sharding.NamedSharding(mesh, s)
out = {}
for name, (arch, moe_kw, jparams, batches, grad) in cases.items():
    cfg = reduced(configs.get(arch))
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    with mesh:  # the launcher's _build_state, then its loop
        params = jax.tree.map(jnp.asarray, jparams)
        params = jax.tree.map(lambda p, s: jax.device_put(p, named(s)),
                              params, shd.param_pspecs(params, mesh))
        state = init_state(params)
        batches = [{k: jax.device_put(jnp.asarray(v),
                                      named(shd.batch_pspec(mesh)))
                    for k, v in b.items()} for b in batches]
        # compiled once: each step's state is moved back to the placement
        # the executable takes (data movement only), not compiled again
        step = jax.jit(make_train_step(cfg, **kw)).lower(
            state, batches[0]).compile()
        placement = step.input_shardings[0][0]
        if grad:  # the first gradient, on the launcher's placement
            g = jax.jit(jax.grad(lambda p, b: make_loss_fn(cfg)(p, b)[0]))(
                state.params, batches[0])
            out[name + "/grad"] = jax.tree.map(np.asarray, g)
        losses = []
        for b in batches:
            state, m = step(jax.device_put(state, placement), b)
            losses.append(float(m["loss"]))
    out[name] = (losses, jax.tree.map(np.asarray, state.params))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the folder, JAX's losses and final parameters a case, every
    rank's results): the JAX child and the spawned ranks run side by
    side, once a module."""
    tmp = str(tmp_path_factory.mktemp("fsdp"))
    cases = {name: _case(name) for name in (*CASES, *EXTRA)}
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = []
    for i, names in enumerate(JAX_CHILDREN):
        with open(os.path.join(tmp, f"in{i}.pkl"), "wb") as f:
            pickle.dump(({n: (cases[n]["arch"], cases[n]["moe_kw"],
                              cases[n]["jparams"], cases[n]["batches"],
                              n in WITH_GRAD) for n in names}, KW), f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _JAX_CHILD,
             os.path.join(tmp, f"in{i}.pkl"),
             os.path.join(tmp, f"out{i}.pkl")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    ssm = _case("ssm")
    rng = np.random.default_rng(3)
    parts = [(f"parity_{n}", "part_parity", dict(
        arch=c["arch"], jparams=c["jparams"], batches=c["batches"], kw=KW))
        for n, c in cases.items() if n in CASES]
    cap = cases["moe_capacity"]
    parts += [("capacity", "part_capacity", dict(
        arch=cap["arch"], moe_kw=cap["moe_kw"], jparams=cap["jparams"],
        batch=cap["batches"][0]))]
    parts += [(f"convert_state_{n}", "part_convert_state", dict(
        arch=cases[n]["arch"], jparams=cases[n]["jparams"]))
        for n in ("moe", "ssm")]
    parts += [(f"property_{n}", "part_property", dict(
        arch=cases[n]["arch"], jparams=cases[n]["jparams"],
        batch=cases[n]["batches"][0])) for n in ("dense", "ssm")]
    parts += [("checkpoint", "part_checkpoint", dict(
        arch=ssm["arch"], jparams=ssm["jparams"], batch=ssm["batches"][0],
        kw=KW)),
        ("convert_ssm", "part_convert_ssm", dict(
            jparams=ssm["jparams"], gen=GEN, prompt=rng.integers(
                0, ssm["cfg"].vocab_size, (2, PROMPT)).astype(np.int64))),
        ("launcher", "part_launcher", dict(runs=[
            ("plain", LAUNCH + ["--ckpt-dir", os.path.join(tmp, "ck0")]),
            ("fault", LAUNCH + ["--ckpt-dir", os.path.join(tmp, "ck1"),
                                "--faults", "device_loss@3:1"])]))]
    res = ranks.spawn(2, os.path.join(tmp, "ranks"), parts=parts)
    jax_out = {}
    for i, proc in enumerate(procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(os.path.join(tmp, f"out{i}.pkl"), "rb") as f:
            jax_out.update(pickle.load(f))
    return tmp, jax_out, res


def _part(run, label):
    res = run[2]
    for r, o in enumerate(res):
        assert "error" not in o[label], f"rank {r}:\n{o[label]['error']}"
    return [o[label] for o in res]


# --- the placement --------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_blocks_are_jax_placement(run, name):
    """Each rank holds exactly ``local_state_dict`` of the whole leaves on
    the (2, 1) mesh: every ``'dp'`` dimension halved (an MoE stack's
    experts split on ``'ep'``), the other leaves whole, about half of
    the parameters a rank."""
    cfg = _case(name)["cfg"]
    shapes = models.leaf_shapes(cfg)
    specs = sharding.param_pspecs(shapes, sharding.fsdp_mesh(2))
    total = sum(np.prod(s) for s in shapes.values())
    for o in _part(run, f"parity_{name}"):
        assert all(o["blocks_equal"].values())
        assert o["block_shapes"] == {k: sharding.local_shape(
            shapes[k], specs[k], sharding.fsdp_mesh(2)) for k in shapes}
        held = sum(np.prod(s) for s in o["block_shapes"].values())
        assert 0.5 * total <= held < 0.6 * total, (held, total)
    if cfg.moe is not None:  # 8 experts: 4 whole ones a rank, as JAX's
        key = "moe_layers.moe.w_gate"
        assert specs[key] == (None, ("data", "model"), None, None)
        assert o["block_shapes"][key][1] == cfg.moe.n_experts // 2


@pytest.mark.parametrize("arch", [a for a in configs.names()
                                  if configs.get(a).family != "conv"])
def test_every_language_model_places_on_data_ranks(arch):
    """Every registered language model's full config places on 2, 4 and 8
    data ranks: each leaf splits one dimension at most, evenly, and a rank
    holds between 1/dp and 1/dp plus the whole leaves of the parameters
    (the whole leaves: norms, biases, SSM vectors, Mamba2's conv taps)."""
    shapes = models.leaf_shapes(configs.get(arch))
    total = sum(int(np.prod(s)) for s in shapes.values())
    for dp in (2, 4, 8):
        specs, dims = sharding.fsdp_dims(shapes, dp)
        whole = sum(int(np.prod(shapes[k])) for k, d in dims.items()
                    if d is None)
        held = sum(int(np.prod(sharding.local_shape(
            shapes[k], specs[k], sharding.fsdp_mesh(dp)))) for k in shapes)
        assert held == whole + (total - whole) // dp, (arch, dp)
        assert whole < 0.01 * total, (arch, dp, whole, total)


@pytest.mark.parametrize("name", CASES)
def test_gradient_blocks_are_bitwise_the_whole_paths(run, name):
    """The first gradient's blocks (gathered in the forward,
    reduce-scattered in the backward) are bitwise this rank's blocks of
    the whole-parameter data-parallel gradient (all-reduced), the loss
    bitwise the same."""
    for o in _part(run, f"parity_{name}"):
        assert o["grad_mismatch"] == []
        assert o["grad_losses"][0] == o["grad_losses"][1]


@pytest.mark.parametrize("name", CASES)
def test_steps_match_jax_fsdp(run, name):
    """2 steps of the port's FSDP train step on 2 gloo ranks against
    JAX's jitted step on 2 devices with the launcher's placement: the
    losses within rtol 1e-5 (the same on both ranks), every parameter's
    blocks within 1e-5 of JAX's (Whisper's K biases: ZERO_GRAD)."""
    _, jax_out, _ = run
    jlosses, jfinal = jax_out[name]
    want = convert.params_from_jax(jfinal)
    res = _part(run, f"parity_{name}")
    assert res[0]["losses"] == res[1]["losses"]
    for r, o in enumerate(res):
        np.testing.assert_allclose(o["losses"], jlosses, rtol=TOL)
        blocks = sharding.local_state_dict(want, sharding.fsdp_mesh(2),
                                           (r, 0))
        assert set(o["params"]) == set(blocks)
        for k, p in o["params"].items():
            np.testing.assert_allclose(
                p, blocks[k].numpy(), rtol=0, err_msg=f"{name} {k}",
                atol=2 * STEPS * LR if k in ZERO_GRAD else TOL)


@pytest.mark.parametrize("name", CASES)
def test_moments_are_blocks(run, name):
    """Both AdamW moments are held as the parameters' blocks: a rank's
    parameter and moment bytes are its blocks' (4 + 4 + 4 bytes an fp32
    parameter)."""
    for o in _part(run, f"parity_{name}"):
        assert o["moment_shapes"] == {k: (s, s) for k, s in
                                      o["block_shapes"].items()}
        held = sum(int(np.prod(s)) for s in o["block_shapes"].values())
        assert o["state_bytes"] == 12 * held


@pytest.mark.parametrize("name", ["moe", "ssm"])
def test_train_state_from_jax_gives_blocks(run, name):
    """``convert.train_state_from_jax(state, cfg, mesh=, coords=)``: the
    data rank's blocks of the parameters and of both moments, the count
    and the step whole."""
    for o in _part(run, f"convert_state_{name}"):
        assert o == dict(params=True, moments=True, count=3, step=3)


def test_capacity_dispatch_drops_over_the_global_batch(run):
    """Moonlight with ``capacity_factor=1.0`` on 2 FSDP ranks: each rank
    keeps exactly the assignments JAX's step keeps of the global batch
    (every assignment ranked behind those of the lower data ranks, the
    capacity of the global token count), so the loss is within rtol 1e-5
    of JAX's first step and every first-gradient block within 1e-5 of
    JAX's gradient on the launcher's placement; a rank's dispatch that
    ranked its own rows alone would drop other tokens."""
    _, jax_out, _ = run
    jlosses, _ = jax_out["moe_capacity"]
    jgrad = convert.params_from_jax(jax_out["moe_capacity/grad"])
    res = _part(run, "capacity")
    assert res[0]["loss"] == res[1]["loss"]
    for r, o in enumerate(res):
        np.testing.assert_allclose(o["loss"], jlosses[0], rtol=TOL)
        blocks = sharding.local_state_dict(jgrad, sharding.fsdp_mesh(2),
                                           (r, 0))
        assert set(o["grads"]) == set(blocks)
        for k, g in o["grads"].items():
            np.testing.assert_allclose(g, blocks[k].numpy(), rtol=0,
                                       atol=TOL, err_msg=k)
        assert o["dropped"] > 0  # the capacity binds on this batch


# --- the FSDP property and the collectives ---------------------------------

@pytest.mark.parametrize("name", ["dense", "ssm"])
def test_one_layer_alive_and_collective_counts(run, name):
    """Under remat, at every gather at most one layer's gathered leaves
    are alive, beside the embedding's; a gradient gathers 2 x layers +
    the tables' (the embedding, and an untied unembedding) and
    reduce-scatters layers + the tables'; a rank handed whole leaves
    where it expects blocks raises."""
    cfg = _case(name)["cfg"]
    tables = 1 if cfg.tie_embeddings else 2
    for o in _part(run, f"property_{name}"):
        assert max(layer for layer, _ in o["alive"]) == 1, o["alive"]
        assert max(other for _, other in o["alive"]) <= tables
        assert o["gathers"] == 2 * cfg.n_layers + tables
        assert o["scatters"] == cfg.n_layers + tables
        assert "a whole leaf where a block is expected" in o["whole_leaf"]


# --- checkpoints, the launcher and elastic recovery ------------------------

def test_checkpoint_moves_between_layouts(run):
    """A checkpoint written by 2 FSDP ranks (rank 0 writes the whole
    arrays) restores into 2 ranks' blocks equal to the saved ones, and
    into one process whole, equal to the arrays the ranks gather."""
    tmp = run[0]
    res = _part(run, "checkpoint")
    assert all(o["restored_equal"] and o["step"] == 1 for o in res)
    assert res[0]["written"] == ["step_00000001"]
    cfg = _case("ssm")["cfg"]
    state = init_state(models.model_class(cfg)(cfg, {
        k: torch.zeros(s) for k, s in models.leaf_shapes(cfg).items()}))
    state = Checkpointer(os.path.join(tmp, "ranks", "ckpt_fsdp")).restore(
        state)
    whole = res[0]["whole"]
    for k, p in state.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), whole[k])
        np.testing.assert_array_equal(state.opt.m[k].numpy(),
                                      whole[f"m.{k}"])


def test_launcher_takes_the_fsdp_path(run):
    """``launch.train`` on a world of 2 with mp 1 trains a language
    model FSDP (``path=fsdp``): each rank's summary holds its blocks'
    bytes, under 60% of the whole state's, and the same losses."""
    res = _part(run, "launcher")
    plain = [o["plain"] for o in res]
    assert "dp=2 path=fsdp" in plain[0]["out"]
    cfg = reduced(configs.get("starcoder2-3b"))
    whole = 12 * sum(int(np.prod(s))
                     for s in models.leaf_shapes(cfg).values())
    for o in plain:
        s = o["summary"]
        assert (s["path"], s["dp"], s["status"]) == ("fsdp", 2, "done")
        assert 0.5 * whole <= s["state_bytes"] < 0.6 * whole
        assert s["fsdp"]["gathers"] > 0 and s["fsdp"]["scatters"] > 0
    assert plain[0]["summary"]["losses"] == plain[1]["summary"]["losses"]


def test_elastic_recovery_to_one_rank(run):
    """``--faults device_loss@3:1 --ckpt-dir`` on 2 FSDP ranks: rank 1
    leaves, rank 0 restores the step-2 checkpoint into whole leaves and
    trains on at dp 1 with accumulation 2; its losses equal the
    uninterrupted run's within the drill's tolerances."""
    res = _part(run, "launcher")
    plain, fault = res[0]["plain"]["summary"], res[0]["fault"]["summary"]
    assert res[1]["fault"]["summary"]["status"] == "lost"
    assert fault["status"] == "done" and fault["path"] == "single"
    assert [(h["dp"], h["accum"]) for h in fault["mesh_history"]] == [
        (2, 1), (1, 2)]
    assert fault["recoveries"][0]["restore_step"] == 2
    assert "elastic: recovered dp=2 -> dp=1" in res[0]["fault"]["out"]
    np.testing.assert_allclose(fault["losses"], plain["losses"],
                               rtol=EL_RTOL, atol=EL_ATOL)


# --- convert's tensor-parallel SSM rank --------------------------------------

def test_convert_gives_an_ssm_rank_its_segment_blocks(run):
    """A reduced Mamba2 rank at mp 2 built from ``convert.params_from_jax
    (..., mesh=, coords=, cfg=)``, its cache from ``cache_from_jax(...,
    cfg=)``, holds the blocks ``models.local_model`` gives it and decodes
    like that rank (and the one process): logits within 1e-5 of the
    largest."""
    for o in _part(run, "convert_ssm"):
        assert o["blocks_equal"]
        assert o["cache_shapes"][0] == o["cache_shapes"][1]
        for loaded, local, one in o["logits"]:
            scale = float(np.abs(one).max())
            np.testing.assert_allclose(loaded, local, rtol=0,
                                       atol=TOL * scale)
            np.testing.assert_allclose(loaded, one, rtol=0,
                                       atol=TOL * scale)

