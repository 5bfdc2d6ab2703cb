"""The port's model-axis (tensor-parallel) path (``repro_torch``:
``launch/mesh.py``'s ``init_mesh``, ``kernels/reduce.py``'s
``ModelReducer``, the ``model_reduce`` threading of ``kernels/ops.py``,
the model half of ``kernels/sharded.py``, ``blocks._mp_apply``, the 2D
``make_sharded_grad_fn``, the launcher's ``--model-parallel`` and the
tuner's ``model_shards`` / ``--mp``) against the JAX package on the CPU.

Two tiers, as ``tests/test_model_parallel.py``:

  * in one process, over a model group of one rank: the wrappers against
    the plain ops, the refusals, the tuner's local-K keys, the preset
    views, the launcher's indivisible world and the tune CLI's ``--mp``;
  * gloo ranks on the CPU (``torch_mp_ranks.spawn``), 2 ranks as (data
    1, model 2) and 4 ranks as (2, 2), on the reduced AtacWorks config
    (C=K=8, S=9, dilation 8, 25 layers) with the JAX package's initial
    weights and random non-zero biases, global batch 4 x 256; against
    JAX's ``make_sharded_grad_fn`` and ``make_train_step`` on a (2, 2)
    host mesh of 4 virtual devices, in a child process, and against
    JAX's single-device gradient.

Tolerances (fp32): the loss within rtol 1e-5 and each of the 50
gradients within ``GRAD_TOL`` = 1e-5 of its leaf's largest value against
JAX (25 layers of sums taken in another order, over ranks and filter
blocks; the bound of ``test_torch_data_parallel.py``); the ranks'
gradients bitwise equal (every rank ends with the same all-reduced
sums); one train step within rtol 1e-3 (loss) and 1e-5 (parameters) of
JAX's (``test_8dev_train_step_equivalence``'s bounds).  The chunked dx
sum is held bitwise to the unchunked one: on CPU tensors the kernel
wrapper's plain version computes each column of a range as it does the
whole width (checked here, not assumed), and a sum of two ranks does not
depend on the order.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.core import blocks as jblocks
from repro.train.losses import make_loss_fn as jmake_loss_fn
from repro_torch import configs, convert, tune
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.kernels import sharded as sh
from repro_torch.launch import mesh
from repro_torch.models import init_model
from repro_torch.train.train_step import init_state

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, WIDTH = 4, 256
GRAD_TOL = 1e-5
BF16_TOL = 3e-2


def _close_to_largest(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _operands(seed=0, N=4, C=8, K=8, S=3, W=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, C, W)).astype(np.float32),
            (0.1 * rng.standard_normal((S, K, C))).astype(np.float32),
            (0.1 * rng.standard_normal(K)).astype(np.float32))


# --- in one process: a model group of one rank ----------------------------

@pytest.fixture
def groups(tmp_path):
    """A started world of one rank: (its data group, a model group of one
    rank); ended after the test."""
    data = mesh.init_data_group("gloo", f"file://{tmp_path}/store", 1, 0)
    try:
        yield data, dist.new_group([0])
    finally:
        mesh.destroy()


@pytest.mark.parametrize("backend", ["ref", "library"])
def test_model_sharded_conv1d_matches_plain(groups, backend):
    """Output and gradients through ``model_sharded_conv1d`` over a model
    group of one rank are the plain op's (JAX's
    ``test_model_sharded_conv1d_matches_plain`` and
    ``..._grads_match_plain``)."""
    data, model = groups
    x, w, b = _operands()

    def run(fn, **kw):
        xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
        y = fn(xt, wt, bias=bt, activation="relu", dilation=2,
               padding="SAME", backend=backend, **kw)
        (y ** 2).sum().backward()
        return [t.detach().numpy() for t in (y, xt.grad, wt.grad, bt.grad)]

    got = run(sh.model_sharded_conv1d, group=data, model_group=model)
    for a, c in zip(got, run(ops.conv1d)):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)


def test_model_sharded_depthwise_matches_plain(groups):
    data, model = groups
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 8, 64)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((4, 8))).astype(
        np.float32))
    ys = sh.model_sharded_depthwise_conv1d(x, w, group=data,
                                           model_group=model,
                                           activation="silu")
    y1 = ops.depthwise_conv1d(x, w, activation="silu")
    np.testing.assert_allclose(ys.numpy(), y1.numpy(), rtol=1e-5, atol=1e-5)


def test_model_sharded_needs_a_model_group(groups):
    x, w, _ = (torch.from_numpy(a) for a in _operands())
    with pytest.raises(ValueError, match="no model group"):
        sh.model_sharded_conv1d(x, w, group=groups[0], model_group=None)
    with pytest.raises(ValueError, match="sum a gradient twice"):
        sh.model_sharded_conv1d(x, w, group=groups[0],
                                model_group=groups[1],
                                model_reduce=groups[1])


def test_depthwise_model_reduce_rejected(groups):
    """Channel groups have no model-axis contraction: asking for a dx sum
    is an error, not a silent no-op."""
    x, w = torch.ones(2, 8, 32), torch.ones(3, 8)
    with pytest.raises(ValueError, match="no model-axis contraction"):
        ops.depthwise_conv1d(x, w, model_reduce=groups[1])


def test_unfused_model_parallel_forward_refused(monkeypatch):
    """A model group of 2 (its size stood in) refuses the unfused path,
    with a data reduce or without one."""
    cfg = reduced(configs.get("atacworks"))
    model = blocks.init_params(cfg)
    monkeypatch.setattr(blocks, "mp_size", lambda g: 2)
    for gra in (None, object()):
        with pytest.raises(ValueError, match="requires the fused path"):
            blocks.forward(model, cfg, torch.ones(1, 64), fused=False,
                           model_group=object(), grad_reduce=gra)


def test_localized_problem_keys_use_local_filters():
    prob = tune.ConvProblem(N=8, C=8, K=8, S=3, dilation=2, Q=128,
                            dtype="float32")
    local = prob.localized(model_shards=2)
    assert (local.N, local.C, local.K) == (8, 8, 4)  # dense: C stays full
    assert "|K4|" in local.key("cpu")
    both = prob.localized(4, model_shards=2)
    assert (both.N, both.K) == (2, 4)
    with pytest.raises(ValueError, match="filters"):
        tune.ConvProblem(N=8, C=15, K=15, S=3, dilation=2, Q=128,
                         dtype="float32").localized(model_shards=2)
    with pytest.raises(ValueError, match="model_shards"):
        prob.localized(model_shards=0)
    dw = tune.ConvProblem(N=8, C=8, K=8, S=3, dilation=2, Q=128,
                          dtype="float32",
                          depthwise=True).localized(model_shards=4)
    assert (dw.C, dw.K) == (2, 2)
    with pytest.raises(ValueError, match="channel groups"):
        tune.ConvProblem(N=8, C=6, K=6, S=3, dilation=2, Q=128,
                         dtype="float32",
                         depthwise=True).localized(model_shards=4)


def test_model_sharded_preset_views():
    from repro_torch.tune.presets import model_sharded_shapes
    cells = [dict(N=4, C=8, K=8, S=3, dilation=2, Q=128),
             dict(N=4, C=15, K=15, S=51, dilation=8, Q=1000)]
    views = list(model_sharded_shapes(cells, 2))
    assert [(v, p["C"], p["K"]) for v, p in views] == [
        ("local-K", 8, 4), ("local-C", 4, 8)]


def test_launcher_rejects_indivisible_world(monkeypatch):
    """A world of one rank cannot form model rows of 3 (JAX's
    ``test_launcher_rejects_indivisible_device_count``)."""
    from repro_torch.launch import train
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="does not divide the 1 rank"):
        train.main(["--arch", "atacworks", "--smoke", "--device", "cpu",
                    "--model-parallel", "3"])


def test_tune_entrypoints_thread_model_shards(tmp_path):
    cache = tune.TuneCache(str(tmp_path / "cache.json"))
    tune.tune(N=4, C=8, K=8, S=3, dilation=2, Q=128, dtype="float32",
              model_shards=2, device="cpu", cache=cache, measure=False)
    assert [k for k in cache.keys()] and all("|K4|" in k
                                             for k in cache.keys())
    plan = tune.get_plan(N=4, C=8, K=8, S=3, dilation=2, Q=128,
                         dtype="float32", model_shards=2, device="cpu",
                         cache=cache)
    assert sorted(plan) == ["bwd_data", "bwd_weight", "fwd"]
    assert plan["fwd"].source == "cache"  # the local-K key was found


def test_tune_cli_threads_mp(tmp_path, capsys):
    """``--mp 2``: the fp32 AtacWorks cells (C=K=15) are skipped, the bf16
    ones (C=K=16) tuned at their local-K and local-C views."""
    from repro_torch.tune.__main__ import main
    path = str(tmp_path / "c.json")
    assert main(["--figset", "atacworks", "--device", "cpu", "--mp", "2",
                 "--passes", "fwd", "--cache", path]) == 0
    out = capsys.readouterr().out
    assert "neither K=15 nor C=15 divides over mp=2" in out
    assert " mp=2:local-K " in out and " mp=2:local-C " in out
    keys = list(tune.TuneCache(path).keys())
    assert keys and all("|C16|K8|" in k or "|C8|K16|" in k
                        for k in keys), keys


# --- gloo ranks against JAX -----------------------------------------------

_JAX_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.configs.base import reduced
from repro.launch.mesh import make_grid_mesh
from repro.train.data_parallel import make_sharded_grad_fn
from repro.train.train_step import init_state, make_train_step

with open(sys.argv[1], "rb") as f:
    jparams, batch, train_batch = pickle.load(f)
cfg = reduced(configs.get("atacworks"))
assert len(jax.devices()) == 4
grid = make_grid_mesh(2, 2)
params = jax.tree.map(jnp.asarray, jparams)
(loss, aux), grads = jax.jit(make_sharded_grad_fn(cfg, grid))(params, batch)
s, m = jax.jit(make_train_step(cfg, total_steps=10, mesh=grid))(
    init_state(params), train_batch)
with open(sys.argv[2], "wb") as f:
    pickle.dump(dict(loss=float(loss),
                     aux={k: float(v) for k, v in aux.items()},
                     grads=jax.tree.map(np.asarray, grads),
                     train_loss=float(m["loss"]),
                     train_params=jax.tree.map(np.asarray, s.params)), f)
"""


@pytest.fixture(scope="module")
def jparams():
    """The JAX package's initial parameters of the reduced config with
    random non-zero biases, as numpy."""
    cfg = jreduced(jconfigs.get("atacworks"))
    tree = jax.tree.map(np.asarray,
                        jblocks.init_params(jax.random.key(0), cfg))
    rng = np.random.default_rng(3)

    def with_bias(p):
        return {"w": p["w"], "b": (0.1 * rng.standard_normal(p["b"].shape)
                                   ).astype(np.float32)}

    return {"stem": with_bias(tree["stem"]),
            "res": [{k: with_bias(v) for k, v in blk.items()}
                    for blk in tree["res"]],
            "head_signal": with_bias(tree["head_signal"]),
            "head_peak": with_bias(tree["head_peak"])}


@pytest.fixture(scope="module")
def runs(jparams, tmp_path_factory):
    """JAX's (2, 2) gradients and train step (a child process, started
    first) beside the port's on (1, 2) and (2, 2) gloo ranks: the plain
    version, the Function path unchunked, with 3 dx column ranges and
    with 2 width ranges to each data sum, the bf16 gradients, one train
    step; and JAX's single-device gradient here."""
    tmp = tmp_path_factory.mktemp("mp")
    batch = synthetic.atacseq_batch(np.random.default_rng(11), BATCH, WIDTH)
    train_batch = synthetic.atacseq_batch(np.random.default_rng(12), BATCH,
                                          WIDTH)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((jparams, batch, train_batch), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CHILD, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = {world: ranks.spawn(world, 2, "job_grads", tmp / f"r{world}",
                                   jparams=jparams, batch=batch,
                                   chunks=(1, 3), train_batch=train_batch)
                for world in (2, 4)}
    finally:
        _, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        jax_out = pickle.load(f)
    jfn = jmake_loss_fn(jreduced(jconfigs.get("atacworks")))
    one = jax.grad(lambda p: jfn(p, batch)[0])(
        jax.tree.map(jax.numpy.asarray, jparams))
    return dict(port=port, jax=jax_out,
                single=convert.params_from_jax(jax.tree.map(np.asarray, one)))


def _names():
    return [k for k, _ in blocks.init_params(
        reduced(configs.get("atacworks"))).named_parameters()]


@pytest.mark.parametrize("world,path", [(2, "ref"), (2, "function1"),
                                        (4, "ref"), (4, "function1"),
                                        (4, "function3"),
                                        (4, "function_g2")])
def test_mp_grads_match_jax(runs, world, path):
    """Every rank's loss, aux and 50 gradients against JAX's
    ``make_sharded_grad_fn`` on the (2, 2) mesh and against JAX's
    single-device gradient; the ranks' gradients bitwise equal; nothing
    left in flight."""
    j = runs["jax"]
    jgrads = convert.params_from_jax(j["grads"])
    res = runs["port"][world]
    names = _names()
    got = res[0][path]
    np.testing.assert_allclose(got["loss"], j["loss"], rtol=1e-5)
    for k in ("mse", "bce"):
        np.testing.assert_allclose(got["aux"][k], j["aux"][k], rtol=1e-5)
    assert len(got["grads"]) == len(names) == 50
    for k, g in zip(names, got["grads"]):
        _close_to_largest(g, jgrads[k].numpy(), GRAD_TOL, k)
        _close_to_largest(g, runs["single"][k].numpy(), GRAD_TOL,
                          f"{k} (single device)")
    for r in res[1:]:
        assert r[path]["loss"] == got["loss"]
        for a, b in zip(r[path]["grads"], got["grads"]):
            np.testing.assert_array_equal(a, b)
    assert all(r[path]["pending"] == 0 for r in res)


@pytest.mark.parametrize("world", [2, 4])
def test_layout_and_collective_counts(runs, world):
    """Rank r sits at (r // 2, r % 2).  A step's collectives on the
    Function path: 23 all-gathers (stem and 22 body layers), 22 x chunks
    dx sums (the stem's input is data; the heads are not sharded), and
    71 parameter sums: every layer's fused (dw, dbias) over the data
    group (25), then the sharded layers' padded w and b blocks over the
    model group (46); 2 width ranges to each data sum make that 50 +
    46.  The plain version sums each parameter over the data group on
    its own (50 + 46)."""
    for r, out in enumerate(runs["port"][world]):
        assert out["layout"] == (r // 2, r % 2, world // 2, 2)
        for path, chunks, params in (("function1", 1, 71),
                                     ("function3", 3, 71),
                                     ("function_g2", 1, 96), ("ref", 1, 96)):
            assert out[path]["counts"] == dict(
                param_reduces=params, dx_reduces=22 * chunks,
                gathers=23), (path, out[path]["counts"])


# the leaves whose cotangent passes no dx sum: both heads (unsharded, on
# the loss) and the last body layer (fed by the heads' whole dx)
_NO_DX_SUM = ("head_signal.w", "head_signal.b", "head_peak.w", "head_peak.b",
              "res.10.conv2.w", "res.10.conv2.b")


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_grads_sum_in_jax_order(runs, world):
    """The bf16 model on the Function path, K-sharded: every gradient
    within BF16_TOL of its leaf's largest value of the one-process bf16
    gradient (JAX's bound for its sharded bf16 gradients,
    ``test_8dev_ksharded_grads``); the ranks' gradients bitwise equal.
    The leaves whose cotangent passes no dx sum are bitwise the
    data-parallel (no model axis) bf16 gradient on the same data group:
    a sharded block is summed over the data group in fp32 and cast once,
    then summed over the model group with zeros, as JAX does, not
    rounded to bf16 before its data sum."""
    names = _names()
    res = runs["port"][world]
    one = res[0]["bf16_one"]["grads"]
    got = res[0]["bf16"]
    for k, g, o in zip(names, got["grads"], one):
        _close_to_largest(g, o, BF16_TOL, k)
    for r in res:
        for a, b in zip(r["bf16"]["grads"], got["grads"]):
            np.testing.assert_array_equal(a, b)
        assert r["bf16"]["pending"] == 0
        for k, a, b in zip(names, r["bf16"]["grads"],
                           r["bf16_data_only"]["grads"]):
            if k in _NO_DX_SUM:
                np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_chunked_dx_sum_is_bitwise(runs, world):
    """Every gradient with 3 column ranges equals the unchunked one bit
    for bit."""
    for out in runs["port"][world]:
        for a, b in zip(out["function3"]["grads"], out["function1"]["grads"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_matches_jax(runs, world):
    """One ``make_train_step(group=, model_group=)`` step against JAX's
    ``make_train_step(mesh=(2, 2))`` from the same state and batch."""
    j = runs["jax"]
    want = convert.params_from_jax(j["train_params"])
    for out in runs["port"][world]:
        t = out["train"]
        assert abs(t["loss"] - j["train_loss"]) < 1e-3 * max(
            1.0, abs(j["train_loss"]))
        assert set(t["params"]) == set(want) and len(want) == 50
        for k, p in t["params"].items():
            np.testing.assert_allclose(p, want[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def op_runs(tmp_path_factory):
    rng = np.random.default_rng(5)
    ins = dict(x=rng.standard_normal((4, 8, 64)).astype(np.float32),
               w=(0.1 * rng.standard_normal((5, 8, 8))).astype(np.float32),
               b=(0.1 * rng.standard_normal(8)).astype(np.float32),
               wd=(0.1 * rng.standard_normal((4, 8))).astype(np.float32),
               bd=(0.1 * rng.standard_normal(8)).astype(np.float32))
    res = ranks.spawn(2, 2, "job_ops", tmp_path_factory.mktemp("ops"),
                      chunks=(1, 4), **ins)
    return ins, res


def test_layer_dx_chunked_is_bitwise_and_summed(op_runs):
    """One K-sharded layer (8 -> 8, S=5, d=2, each rank 4 filters) on the
    Function path: dx equals the unsharded layer's within fp32 rounding
    (the K contraction split in two and summed), 4 column ranges give
    the unchunked dx bit for bit, one dx sum a range."""
    ins, res = op_runs
    x = torch.from_numpy(ins["x"]).requires_grad_()
    y = ops.conv1d(x, torch.from_numpy(ins["w"]),
                   bias=torch.from_numpy(ins["b"]), activation="relu",
                   dilation=2, padding="SAME")
    (y ** 2).sum().backward()
    for r in res:
        _close_to_largest(r["dx1"], x.grad.numpy(), 1e-6, "dx")
        np.testing.assert_array_equal(r["dx4"], r["dx1"])
        assert r["dx1_counts"]["dx_reduces"] == 1
        assert r["dx4_counts"]["dx_reduces"] == 4
    np.testing.assert_array_equal(res[0]["dx1"], res[1]["dx1"])


@pytest.mark.parametrize("which", ["dense", "depthwise"])
def test_model_sharded_wrappers_on_two_ranks(op_runs, which):
    """Through ``model_sharded_conv1d`` each rank's output is the plain
    op's (all K, gathered) and its gradients the plain op's (dx summed
    over the model group, dw and dbias whole); through
    ``model_sharded_depthwise_conv1d`` each rank's output and gradients
    are its channel group's, with no model collective on any pass."""
    ins, res = op_runs
    x = torch.from_numpy(ins["x"]).requires_grad_()
    if which == "dense":
        w = torch.from_numpy(ins["w"]).requires_grad_()
        b = torch.from_numpy(ins["b"]).requires_grad_()
        y = ops.conv1d(x, w, bias=b, activation="relu", dilation=2,
                       padding="SAME")
    else:
        w = torch.from_numpy(ins["wd"]).requires_grad_()
        b = torch.from_numpy(ins["bd"]).requires_grad_()
        y = ops.depthwise_conv1d(x, w, bias=b, activation="silu")
    (y ** 2).sum().backward()
    for r, out in enumerate(res):
        got = out[which]
        if which == "dense":
            want = [y, x.grad, w.grad, b.grad]
            assert got["counts"]["gathers"] == 1
            assert got["counts"]["dx_reduces"] == 1
        else:
            blk = slice(4 * r, 4 * r + 4)
            want = [y[:, blk]]
            for g, dim in ((x.grad, 1), (w.grad, 1), (b.grad, 0)):
                z = torch.zeros_like(g)
                z.narrow(dim, 4 * r, 4).copy_(g.narrow(dim, 4 * r, 4))
                want.append(z)
            assert got["counts"]["gathers"] == 0
            assert got["counts"]["dx_reduces"] == 0
        for k, a, c in zip(("y", "dx", "dw", "db"), [got[k] for k in (
                "y", "dx", "dw", "db")], want):
            np.testing.assert_allclose(a, c.detach().numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_refusals_on_two_ranks(tmp_path):
    """AtacWorks' C=15 cannot split over mp=2: the 2D grad fn and the
    launcher say so in terms of conv_channels (JAX's messages); a
    language model is refused by the grad fn."""
    for r in ranks.spawn(2, 2, "job_refusals", tmp_path):
        assert "conv_channels=15" in r["gradfn_c15"]
        assert "conv_channels=15" in r["launch_c15"]
        assert "conv family only" in r["gradfn_ssm"]


def test_launcher_model_parallel_matches_one_process(tmp_path, monkeypatch):
    """``launch.train.run --model-parallel 2`` on two gloo ranks (the
    Function path) trains the reduced config as the single-process
    launcher does: losses and gradient norms within rtol 1e-5 (dx summed
    in another order), rank 0 alone prints and saves one whole
    checkpoint, the summary names mp."""
    from repro_torch.launch import train
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--arch", "atacworks", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "256", "--steps", "3"]
    plain = train.run(argv)
    res = ranks.spawn(2, 2, "job_launcher", tmp_path, argv=argv + [
        "--model-parallel", "2", "--model-reduce-chunks", "2",
        "--ckpt-dir", str(tmp_path / "ckpt")])
    lead = res[0]
    assert "mp=2 path=model_parallel" in lead["out"]
    assert res[1]["out"] == ""
    assert lead["ckpts"] == ["step_00000003"]
    assert (lead["summary"]["mp"], lead["summary"]["dp"]) == (2, 1)
    for r in res:
        for k in ("losses", "grad_norms"):
            np.testing.assert_allclose(r["summary"][k], plain[k], rtol=1e-5)
    assert res[0]["summary"]["losses"] == res[1]["summary"]["losses"]
    # the saved set is whole: it restores into the unsharded model
    state = Checkpointer(str(tmp_path / "ckpt")).restore(
        init_state(init_model(reduced(configs.get("atacworks")))))
    assert int(state.step) == 3
    assert state.params.res[0].conv1.w.shape == (9, 8, 8)
