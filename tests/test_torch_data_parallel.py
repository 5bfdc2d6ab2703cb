"""The port's data-parallel path (``repro_torch``: ``launch/mesh.py``, the
``grad_reduce`` threading of ``kernels/ops.py``, ``kernels/sharded.py``,
``train/data_parallel.py``, the data-parallel train step, loader and
launcher, the tuner's per-shard view) and the unfused forward and stream
step, against the JAX package on the CPU.

The ranks are gloo processes on the CPU (``torch_dp_ranks.spawn``: start
method ``spawn``, one thread each, a file store for the rendezvous).  The
model is the reduced AtacWorks config (C=8, S=9, dilation 8, 25 layers)
with the JAX package's initial weights and random non-zero biases; the
global batch is 4 x 256 from ``atacseq_batch``.  Each rank runs its
contiguous share.  The JAX side is ``make_sharded_grad_fn`` on the host
mesh at the global batch (its ``xla`` conv backend, the CPU default), and
``make_train_step(mesh=make_data_mesh(2))`` on two virtual devices in a
subprocess.

Tolerances (fp32): the loss and aux within rtol 1e-5, each gradient
within ``GRAD_TOL`` = 1e-5 of its leaf's largest value against JAX (25
layers of sums taken in another order and over shards); the ranks'
gradients bitwise equal (an all-reduce hands every rank the same sum);
a chunked reduce against the unchunked one within ``CHUNK_TOL`` = 1e-6 of
the largest value (the same products summed in another order, as JAX's
``test_8dev_chunked_psum_matches_single`` holds it at an fp32
tolerance, not bitwise); parameters after two steps within 1e-5 absolute
(lr 1e-3; see ``test_torch_training.py`` on AdamW's sign-like first
steps).
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.core import blocks as jblocks
from repro.core import streaming as jstreaming
from repro.launch.mesh import make_host_mesh
from repro.train.data_parallel import make_sharded_grad_fn as jsharded_grad
from repro_torch import configs, convert, tune
from repro_torch.configs.base import reduced
from repro_torch.core import blocks, streaming
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.kernels.sharded import sharded_conv1d
from repro_torch.launch import mesh
from repro_torch.train.data_parallel import make_sharded_grad_fn, shard_batch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, WIDTH = 4, 256
GRAD_TOL, CHUNK_TOL = 1e-5, 1e-6
LR = 1e-3


@pytest.fixture(scope="module")
def cfgs():
    return jreduced(jconfigs.get("atacworks")), reduced(
        configs.get("atacworks"))


@pytest.fixture(scope="module")
def jparams(cfgs):
    """The JAX package's initial parameters with random non-zero biases,
    as numpy."""
    tree = jax.tree.map(np.asarray,
                        jblocks.init_params(jax.random.key(0), cfgs[0]))
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
def batch():
    return synthetic.atacseq_batch(np.random.default_rng(11), BATCH, WIDTH)


@pytest.fixture(scope="module")
def jax_dp(cfgs, jparams, batch):
    """JAX's data-parallel gradients at the global batch: ((loss, aux),
    gradients as a state dict)."""
    fn = jax.jit(jsharded_grad(cfgs[0], make_host_mesh()))
    (loss, aux), grads = fn(jax.tree.map(jnp.asarray, jparams), batch)
    return (float(loss), {k: float(v) for k, v in aux.items()},
            convert.params_from_jax(jax.tree.map(np.asarray, grads)))


def _names(cfg):
    return [k for k, _ in blocks.init_params(cfg).named_parameters()]


def _close_to_largest(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _check_against_jax(res, jax_dp, names):
    jloss, jaux, jgrads = jax_dp
    np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)
    for k in ("mse", "bce"):
        np.testing.assert_allclose(res["aux"][k], jaux[k], rtol=1e-5)
    assert len(res["grads"]) == len(names) == 50
    for k, g in zip(names, res["grads"]):
        _close_to_largest(g, jgrads[k].numpy(), GRAD_TOL, k)


# --- the group ------------------------------------------------------------

def test_world_of_one_needs_no_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_data_group() is None
    assert (mesh.dp_size(None), mesh.dp_rank(None)) == (1, 0)
    done = []
    r = mesh.GradReducer(None)
    before = mesh.GradReducer.launches
    r.all_reduce_(torch.ones(3), lambda: done.append(1))
    assert done == [1] and r.pending == 0
    assert mesh.GradReducer.launches == before


@pytest.mark.parametrize("path", ["ref", "function"])
def test_world_of_one_matches_jax(cfgs, jparams, batch, jax_dp, path,
                                  monkeypatch):
    """``make_sharded_grad_fn`` with no group is the single-process
    gradient; it equals JAX's data-parallel gradient at the batch."""
    _, cfg = cfgs
    if path == "function":
        monkeypatch.setattr(ops, "conv1d", ranks.routed_conv1d)
    _, model = ranks.atac_model(jparams)
    fn = make_sharded_grad_fn(cfg, None)
    (loss, aux), grads = fn(model, ranks.tensors(batch))
    res = dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
               grads=[g.numpy() for g in grads])
    _check_against_jax(res, jax_dp, _names(cfg))


def test_shard_batch_takes_the_ranks_rows(monkeypatch):
    """A rank's share is its contiguous rows; a batch that does not divide
    is refused with JAX's message (a group of 2 stood in by its size and
    rank)."""
    from repro_torch.train import data_parallel
    assert shard_batch({"x": torch.arange(4)}, None)["x"].tolist() == [
        0, 1, 2, 3]
    monkeypatch.setattr(data_parallel, "dp_size", lambda g: 2)
    monkeypatch.setattr(data_parallel, "dp_rank", lambda g: 1)
    got = shard_batch({"x": torch.arange(4), "y": torch.arange(8).view(4, 2)},
                      object())
    assert got["x"].tolist() == [2, 3] and got["y"].tolist() == [[4, 5],
                                                                 [6, 7]]
    with pytest.raises(ValueError, match="batch 3 does not divide over 2"):
        shard_batch({"x": torch.ones(3)}, object())


def test_loader_ranks_slice_the_global_batch(cfgs):
    """Each rank's loader yields its contiguous rows of the global batch
    that the single-process loader draws from the same step seed."""
    _, cfg = cfgs
    loaders = [synthetic.SyntheticLoader(cfg, 4, 128, seed=5, start=2,
                                         rank=r, world=2) for r in range(2)]
    try:
        for i in range(2):
            want = synthetic.make_batch(cfg, 4, 128, seed=5 + 2 + i)
            got = [next(ld) for ld in loaders]
            for k in want:
                np.testing.assert_array_equal(
                    np.concatenate([g[k].numpy() for g in got]), want[k])
    finally:
        for ld in loaders:
            ld.close()
    with pytest.raises(ValueError, match="does not divide over 3"):
        synthetic.SyntheticLoader(cfg, 4, 128, rank=0, world=3)


def test_sharded_wrappers_need_a_group():
    """JAX's first error: no data axis (here: no data group)."""
    with pytest.raises(ValueError, match="no data-parallel group"):
        sharded_conv1d(torch.ones(2, 4, 16), torch.ones(3, 4, 4),
                       group=None)


# --- the tuner's per-shard view -------------------------------------------

def test_localized_problem_keys_use_local_batch(tmp_path):
    prob = tune.ConvProblem(N=8, C=8, K=8, S=3, dilation=2, Q=128,
                            dtype="float32")
    local = prob.localized(4)
    assert local.N == 2 and "|N2|" in local.key("cpu")
    with pytest.raises(ValueError, match="divide"):
        prob.localized(3)
    cache = tune.TuneCache(str(tmp_path / "c.json"))
    tune.tune(N=8, C=8, K=8, S=3, dilation=2, Q=128, dtype="float32",
              shards=4, device="cpu", cache=cache, measure=False)
    assert list(cache.keys()) == [local.key("cpu")]
    plan = tune.get_plan(N=2, C=8, K=8, S=3, dilation=2, Q=128,
                         dtype="float32", device="cpu", cache=cache)
    assert plan["fwd"].source == "cache"  # a rank's lookup at N / dp


def test_tune_cli_tunes_the_per_rank_view(tmp_path, capsys):
    from repro_torch.tune.__main__ import main
    path = str(tmp_path / "c.json")
    assert main(["--figset", "atacworks", "--device", "cpu", "--dp", "2",
                 "--passes", "fwd", "--cache", path]) == 0
    out = capsys.readouterr().out
    assert " dp=2 " in out
    keys = list(tune.TuneCache(path).keys())
    assert keys and all("|N2|" in k for k in keys), keys  # N 4 over 2


# --- the unfused forward and stream step ----------------------------------

def test_forward_unfused_matches_jax(cfgs, jparams, batch):
    """``forward_unfused``: outputs and all 50 gradients of the loss
    against JAX's ``forward_unfused`` (biases non-zero), and the fused
    forward within fp32 rounding of it."""
    jcfg, cfg = cfgs

    def jloss(p):
        s, pk = jblocks.forward_unfused(p, jcfg, batch["noisy"],
                                        backend="xla")
        return (s ** 2).mean() + (pk ** 2).mean(), (s, pk)

    (jl, (js, jp)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams))
    _, model = ranks.atac_model(jparams)
    x = torch.from_numpy(batch["noisy"])
    s, pk = blocks.forward_unfused(model, cfg, x)
    ((s ** 2).mean() + (pk ** 2).mean()).backward()
    assert s.dtype == pk.dtype == torch.float32
    _close_to_largest(s.detach().numpy(), js, 1e-5, "signal")
    _close_to_largest(pk.detach().numpy(), jp, 1e-5, "peak")
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg))
    for k, p in model.named_parameters():
        _close_to_largest(p.grad.numpy(), want[k].numpy(), GRAD_TOL, k)
    fs, fp = blocks.forward(model, cfg, x, fused=True)
    _close_to_largest(fs.detach().numpy(), s.detach().numpy(), 1e-5, "fused")
    us, _ = blocks.forward(model, cfg, x, fused=False)
    assert torch.equal(us, s)


def test_unfused_stream_step_matches_jax(cfgs, jparams):
    """Prefill then two stream steps with ``fused=False`` against JAX's
    ``streaming.prefill`` / ``stream_step(fused=False)``, biases
    non-zero; and against the unfused causal one-shot forward."""
    jcfg, cfg = cfgs
    x = np.random.default_rng(2).standard_normal((2, 96)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, jparams)
    (jsig, jpk), jst = jstreaming.prefill(jp, jcfg, x[:, :40], fused=False,
                                          backend="ref")
    jouts = [(jsig, jpk)]
    for lo, hi in ((40, 41), (41, 96)):
        out, jst = jstreaming.stream_step(jp, jcfg, jst, x[:, lo:hi],
                                          fused=False, backend="ref")
        jouts.append(out)
    _, model = ranks.atac_model(jparams)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        out, st = streaming.prefill(model, cfg, xt[:, :40], fused=False)
        outs = [out]
        for lo, hi in ((40, 41), (41, 96)):
            out, st = streaming.stream_step(model, cfg, st, xt[:, lo:hi],
                                            fused=False)
            outs.append(out)
        one = blocks.forward_unfused(model, cfg, xt, padding="CAUSAL")
    for (s, p), (js, jpk) in zip(outs, jouts):
        _close_to_largest(s.numpy(), np.asarray(js), 1e-5, "signal")
        _close_to_largest(p.numpy(), np.asarray(jpk), 1e-5, "peak")
    for got, want in zip((torch.cat([o[0] for o in outs], 1),
                          torch.cat([o[1] for o in outs], 1)), one):
        _close_to_largest(got.numpy(), want.numpy(), 1e-5, "one-shot")
    flat, jflat = jax.tree.leaves(st), jax.tree.leaves(jst)
    assert len(flat) == len(jflat) == 25
    for a, b in zip(flat, jflat):
        _close_to_largest(a.numpy(), np.asarray(b), 1e-5, "state")


# --- two and four ranks ---------------------------------------------------

@pytest.fixture(scope="module")
def dp_runs(jparams, batch, tmp_path_factory):
    """The reduced AtacWorks gradients on 2 and 4 gloo ranks: the plain
    version, and the Function path unchunked and chunked."""
    return {world: ranks.spawn(world, "job_atacworks",
                               tmp_path_factory.mktemp(f"dp{world}"),
                               jparams=jparams, batch=batch, chunks=chunks)
            for world, chunks in ((2, (1, 3, 4)), (4, (1, 3)))}


@pytest.mark.parametrize("world,path", [(2, "ref"), (2, "function1"),
                                        (4, "ref"), (4, "function1")])
def test_dp_grads_match_jax(cfgs, dp_runs, jax_dp, world, path):
    """Every rank's loss, aux and 50 gradients against JAX's
    ``make_sharded_grad_fn`` at the global batch; the ranks' gradients
    bitwise equal; no reduce left in flight."""
    res = dp_runs[world]
    _check_against_jax(res[0][path], jax_dp, _names(cfgs[1]))
    for r in res[1:]:
        assert r[path]["loss"] == res[0][path]["loss"]
        for a, b in zip(r[path]["grads"], res[0][path]["grads"]):
            np.testing.assert_array_equal(a, b)
    assert all(r[path]["pending"] == 0 for r in res)


@pytest.mark.parametrize("world,chunks", [(2, 3), (2, 4), (4, 3)])
def test_chunked_reduce_matches_unchunked(cfgs, dp_runs, world, chunks):
    """``grad_reduce_chunks``: the same gradients within fp32 rounding;
    one all-reduce per layer and width range, each layer's bwd-weight
    pass run once per range."""
    for r in dp_runs[world]:
        got, want = r[f"function{chunks}"], r["function1"]
        assert got["reduces"] == 25 * chunks
        for k, a, b in zip(_names(cfgs[1]), got["grads"], want["grads"]):
            _close_to_largest(a, b, CHUNK_TOL, k)


def test_reduce_counts(dp_runs):
    """The Function path reduces (dw, dbias) as one buffer a layer: 25 a
    rank a step; the plain version reduces each parameter: 50."""
    for world in (2, 4):
        for r in dp_runs[world]:
            assert r["function1"]["reduces"] == 25
            assert r["ref"]["reduces"] == 50


@pytest.fixture(scope="module")
def contract(jparams, batch, tmp_path_factory):
    return ranks.spawn(2, "job_reducer_contract",
                       tmp_path_factory.mktemp("contract"),
                       jparams=jparams, batch=batch)


def test_reduces_are_in_flight_in_the_backward_and_none_after(contract):
    """While the stem's input gradient runs (the backward's last layer)
    the later layers' reduces are still pending; after the gradient
    function returns none is."""
    for r in contract:
        assert r["pending_in_backward"] and r["pending_in_backward"][0] > 0
        assert r["pending_after"] == 0


def test_a_weight_reduced_twice_is_refused(contract):
    for r in contract:
        assert "all-reduced twice" in r["twice"]


def test_a_failed_backward_leaves_the_reducer_empty(contract):
    """A backward that raises after every layer's reduce was issued (a
    hook on the stem's weight, whose gradient comes last): the gradient
    function waits on the reduces and drops their claims, so nothing is
    pending and the next call gives the first call's gradients bitwise."""
    for r in contract:
        assert "injected failure" in r["failed"]
        assert r["pending_after_failure"] == 0
        assert len(r["grads_after_failure"]) == len(r["grads"]) == 50
        for a, b in zip(r["grads_after_failure"], r["grads"]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    rng = np.random.default_rng(1)
    ops_in = dict(
        x=rng.standard_normal((4, 8, 64)).astype(np.float32),
        w=(0.1 * rng.standard_normal((3, 4, 8))).astype(np.float32),
        b=(0.1 * rng.standard_normal(4)).astype(np.float32),
        wd=(0.1 * rng.standard_normal((4, 8))).astype(np.float32),
        bd=(0.1 * rng.standard_normal(8)).astype(np.float32))
    res = ranks.spawn(2, "job_sharded", tmp_path_factory.mktemp("sharded"),
                      uneven=True, **ops_in)
    return ops_in, res


@pytest.mark.parametrize("which", ["dense", "depthwise"])
def test_sharded_wrappers_match_the_plain_ops(sharded, which):
    """Each rank's output is its rows of the plain op's on the global
    batch; the w and bias gradients of ``.backward()`` through the
    wrapper are the plain op's (summed over the ranks)."""
    ins, res = sharded
    x = torch.from_numpy(ins["x"])
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
    for r, got in enumerate(res):
        got = got[which]
        np.testing.assert_allclose(got["y"], y[2 * r:2 * r + 2].detach(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["dw"], w.grad, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["db"], b.grad, rtol=1e-5, atol=1e-6)


def test_sharded_errors_match_jax(sharded):
    """Ranks with unequal batches get JAX's indivisible-batch error; a
    ``grad_reduce`` inside the wrapper (the double count JAX's docstring
    warns of) is refused."""
    for r in sharded[1]:
        assert "batch 5 does not divide over 2" in r["uneven"]
        assert "dp times" in r["double"]


def test_auto_plans_key_on_the_local_batch(batch, tmp_path):
    """Every ``backend="auto"`` plan of a data-parallel loss resolves at
    the rank's batch, N / dp, never the global N (JAX's
    ``test_localized_problem_keys_use_local_batch``)."""
    res = ranks.spawn(2, "job_auto_keys", tmp_path, batch=batch)
    assert [r["seen"] for r in res] == [[BATCH // 2]] * 2


def test_mamba2_whole_list_reduce_matches_one_process(tmp_path):
    """Reduced Mamba2 at two ranks, its gradient list all-reduced after
    the backward, against the single-process gradients at the global
    batch (fp32; loss within rtol 1e-5, gradients within 1e-5 of each
    leaf's largest value)."""
    from repro_torch.models import init_model
    cfg = reduced(configs.get("mamba2-370m"))
    b = synthetic.make_batch(cfg, 4, 40, seed=3)
    res = ranks.spawn(2, "job_mamba2", tmp_path, batch=b)
    model = init_model(cfg, seed=0)
    (loss, _), grads = make_sharded_grad_fn(cfg, None)(model,
                                                       ranks.tensors(b))
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        assert r["reduces"] == len(grads)
        for (k, _), a, g in zip(model.named_parameters(), r["grads"], grads):
            _close_to_largest(a, g.numpy(), 1e-5, k)


def test_launcher_at_two_ranks_saves_on_rank0_and_resumes(tmp_path):
    """``launch.train.run --dist-backend gloo`` over a 2-rank group on the
    CPU: rank 0 alone prints; the checkpoints land once; a run resumed
    from step 2 replays steps 2 and 3 as the first run did; the ranks
    agree on every loss.  On the Function path (``ops.Conv1dFunction`` on
    CPU tensors) the run issues 25 all-reduces a step, 75 with
    ``--grad-reduce-chunks 3``, and both runs' losses and gradient norms
    are the plain version's within rtol 1e-5 (the same sums in another
    order, then four AdamW steps)."""
    argv = ["--arch", "atacworks", "--smoke", "--device", "cpu", "--batch",
            "4", "--seq", "256", "--steps", "4", "--dist-backend", "gloo"]
    res = ranks.spawn(2, "job_launcher", tmp_path, argv=argv)
    first, again, function, chunked = res[0]["runs"]
    assert (first["reduces"], function["reduces"], chunked["reduces"]) == (
        50 * 4, 25 * 4, 75 * 4)
    for run in (function, chunked):
        for k in ("losses", "grad_norms"):
            np.testing.assert_allclose(run["summary"][k],
                                       first["summary"][k], rtol=1e-5)
    assert "dp=2 path=data_parallel" in first["out"]
    assert "step     3 loss" in first["out"]
    assert all(r["runs"][i]["out"] == "" for r in res[1:]
               for i in range(4))
    assert first["ckpts"] == ["step_00000002", "step_00000004"]
    assert first["summary"]["dp"] == 2
    assert again["summary"]["first_step"] == 2
    np.testing.assert_array_equal(again["summary"]["losses"],
                                  first["summary"]["losses"][2:])
    for r in res[1:]:
        for i in range(4):
            assert r["runs"][i]["summary"]["losses"] == res[0]["runs"][i][
                "summary"]["losses"]


def test_launcher_dist_backend_starts_a_group_of_one(monkeypatch, capsys):
    """``--dist-backend gloo`` outside ``torchrun`` starts a group of one
    rank (an in-process store): the run takes the data-parallel path and
    issues every reduce (the plain version's 50 a step), and its losses
    and gradient norms are the plain launcher's bitwise, since a sum over
    one rank is the identity.  The started group refuses another
    backend."""
    from repro_torch.launch import train
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--arch", "atacworks", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "256", "--steps", "2"]
    plain = train.run(argv)
    before = mesh.GradReducer.launches
    try:
        dp = train.run(argv + ["--dist-backend", "gloo"])
        reduces = mesh.GradReducer.launches - before
        with pytest.raises(ValueError, match="gloo group is already"):
            mesh.init_data_group("nccl")
    finally:
        mesh.destroy()
    assert "dp=1 path=data_parallel" in capsys.readouterr().out
    assert (plain["dp"], dp["dp"], reduces) == (1, 1, 50 * 2)
    assert dp["losses"] == plain["losses"]
    assert dp["grad_norms"] == plain["grad_norms"]


# --- against JAX's train step on a two-device mesh ------------------------

_JAX_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import pickle
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.configs.base import reduced
from repro.launch.mesh import make_data_mesh
from repro.train.train_step import init_state, make_train_step

with open(sys.argv[1], "rb") as f:
    jparams, batches, kw = pickle.load(f)
cfg = reduced(configs.get("atacworks"))
assert len(jax.devices()) == 2
step = jax.jit(make_train_step(cfg, mesh=make_data_mesh(2), **kw))
state = init_state(jax.tree.map(jnp.asarray, jparams))
losses = []
for b in batches:
    state, m = step(state, b)
    losses.append(float(m["loss"]))
with open(sys.argv[2], "wb") as f:
    pickle.dump((losses, jax.tree.map(np.asarray, state.params)), f)
"""


def test_train_steps_match_jax_two_device_mesh(jparams, tmp_path):
    """Two steps of the port's ``make_train_step(group=...)`` on two gloo
    ranks (the Function path) against JAX's ``make_train_step(mesh=
    make_data_mesh(2))`` on two virtual devices, from the same state on
    the same batches: losses within rtol 1e-5, every parameter within
    1e-5."""
    import pickle
    batches = [synthetic.atacseq_batch(np.random.default_rng(100 + i),
                                       BATCH, WIDTH) for i in range(2)]
    kw = dict(peak_lr=LR, warmup_steps=2, total_steps=2)
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump((jparams, batches, kw), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CHILD, str(tmp_path / "in.pkl"),
         str(tmp_path / "out.pkl")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    res = ranks.spawn(2, "job_train", tmp_path / "ranks", jparams=jparams,
                      batches=batches, kw=kw)
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        jlosses, jfinal = pickle.load(f)
    want = convert.params_from_jax(jfinal)
    for r in res:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        assert set(r["params"]) == set(want) and len(want) == 50
        for k, p in r["params"].items():
            np.testing.assert_allclose(p, want[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
