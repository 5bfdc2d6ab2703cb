"""Rank-side jobs of ``test_torch_data_parallel.py``: the port's
data-parallel path run by gloo ranks on the CPU.

Kept apart from the test module so that each spawned rank imports torch
and the port, not JAX.  ``spawn(world, job, tmp, **payload)`` starts
``world`` ranks (start method ``spawn``, one thread each, a file store
under ``tmp`` for the rendezvous, never a TCP port), runs the job named
``job`` in each with the started group and returns every rank's result
dict.
"""
from __future__ import annotations

import contextlib
import io
import os
import pickle

import numpy as np
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from repro_torch import configs, convert
from repro_torch.configs.base import reduced
from repro_torch.kernels import ops
from repro_torch.launch import mesh


_OPS_CONV1D = ops.conv1d


def routed_conv1d(x, w, *, padding="SAME", dilation=1, backend=None, **kw):
    """``ops.conv1d`` through ``ops.Conv1dFunction`` on CPU tensors (the
    path a CUDA tensor takes, each pass its plain version); a call that
    names a backend (the trainer's telemetry probe: ``"auto"``) goes to
    ``ops.conv1d`` itself."""
    if backend is not None:
        return _OPS_CONV1D(x, w, padding=padding, dilation=dilation,
                           backend=backend, **kw)
    lo, hi = ops._pad_amounts(w.shape[0], dilation, padding)
    return ops.fused_conv1d(F.pad(x, (lo, hi)).contiguous(), w.contiguous(),
                            dilation=dilation, **kw)


def kernel_path():
    ops.conv1d = routed_conv1d


def atac_model(jparams):
    from repro_torch.core import blocks
    cfg = reduced(configs.get("atacworks"))
    model = blocks.init_params(cfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    return cfg, model


def tensors(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _grads(cfg, model, batch, group, chunks=None):
    from repro_torch.train.data_parallel import make_sharded_grad_fn
    fn = make_sharded_grad_fn(cfg, group, grad_reduce_chunks=chunks)
    before = mesh.GradReducer.launches
    (loss, aux), grads = fn(model, batch)
    return dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                grads=[g.detach().numpy().copy() for g in grads],
                reduces=mesh.GradReducer.launches - before,
                pending=fn.reducer.pending)


# --- jobs: job(group, rank, world, tmp, **payload) -> dict ----------------

def job_atacworks(group, rank, world, tmp, *, jparams, batch, chunks):
    """The reduced AtacWorks gradients at this rank's share: the plain
    version (``ReduceGrad``) and the Function path at each chunk count."""
    from repro_torch.train.data_parallel import shard_batch
    local = shard_batch(tensors(batch), group)
    cfg, model = atac_model(jparams)
    out = {"ref": _grads(cfg, model, local, group)}
    kernel_path()
    for c in chunks:
        out[f"function{c}"] = _grads(cfg, model, local, group, chunks=c)
    return out


def job_reducer_contract(group, rank, world, tmp, *, jparams, batch):
    """The reducer's reduces are in flight during the backward and none is
    after the gradient function returns; a backward that raises once the
    reduces are issued leaves none in flight and no claim, so the next
    call runs; a weight fed to two convs under one reducer is refused."""
    from repro_torch.train.data_parallel import (make_sharded_grad_fn,
                                                 shard_batch)
    kernel_path()
    cfg, model = atac_model(jparams)
    local = shard_batch(tensors(batch), group)
    fn = make_sharded_grad_fn(cfg, group)
    seen = []
    stem = model.stem.forward

    def spy(x, **kw):  # the stem's input gradient is the last to run
        y = stem(x, **kw)
        y.register_hook(lambda g: seen.append(fn.reducer.pending))
        return y
    model.stem.forward = spy
    _, grads = fn(model, local)
    del model.stem.forward
    out = dict(pending_in_backward=seen, pending_after=fn.reducer.pending,
               grads=[g.numpy().copy() for g in grads])

    def fail(g):  # the stem's weight gradient comes after every reduce
        raise RuntimeError("injected failure")
    hook = model.stem.w.register_hook(fail)
    try:
        fn(model, local)
        out["failed"] = "no error"
    except RuntimeError as e:
        out["failed"] = str(e)
    hook.remove()
    out["pending_after_failure"] = fn.reducer.pending
    _, grads = fn(model, local)
    out["grads_after_failure"] = [g.numpy().copy() for g in grads]
    reducer = mesh.GradReducer(group)
    x = torch.randn(2, 4, 32)
    w = torch.randn(3, 4, 4, requires_grad=True)
    y = (ops.fused_conv1d(x, w, grad_reduce=reducer)
         + ops.fused_conv1d(x, w, grad_reduce=reducer))
    try:
        torch.autograd.grad(y.sum(), [w])
        out["twice"] = "no error"
    except RuntimeError as e:
        out["twice"] = str(e)
    reducer.wait()
    return out


def job_train(group, rank, world, tmp, *, jparams, batches, kw):
    """Steps of ``make_train_step(group=...)`` from the JAX state."""
    from repro_torch.train.data_parallel import shard_batch
    from repro_torch.train.train_step import init_state, make_train_step
    kernel_path()
    cfg, model = atac_model(jparams)
    state = init_state(model)
    step = make_train_step(cfg, group=group, **kw)
    losses = []
    for b in batches:
        state, m = step(state, shard_batch(tensors(b), group))
        losses.append(float(m["loss"]))
    return dict(losses=losses, params={
        k: p.detach().numpy().copy()
        for k, p in state.params.named_parameters()})


def job_sharded(group, rank, world, tmp, *, x, w, b, wd, bd, uneven):
    """``sharded_conv1d`` / ``sharded_depthwise_conv1d`` on this rank's
    share: the local outputs and the summed gradients; then the error of
    ranks with unequal batches and of ``grad_reduce`` in the body."""
    from repro_torch.kernels.sharded import (sharded_conv1d,
                                             sharded_depthwise_conv1d)
    from repro_torch.train.data_parallel import shard_batch
    out = {}
    xl = shard_batch({"x": torch.from_numpy(x)}, group)["x"]
    for name, fn, ww, bb, kw in (
            ("dense", sharded_conv1d, w, b,
             dict(activation="relu", dilation=2, padding="SAME")),
            ("depthwise", sharded_depthwise_conv1d, wd, bd,
             dict(activation="silu"))):
        wt = torch.from_numpy(ww).requires_grad_()
        bt = torch.from_numpy(bb).requires_grad_()
        y = fn(xl, wt, group=group, bias=bt, **kw)
        (y ** 2).sum().backward()  # .backward(): the wrapper's reduce waits
        out[name] = dict(y=y.detach().numpy(), dw=wt.grad.numpy(),
                         db=bt.grad.numpy())
    n = 2 + rank if uneven else 2
    try:
        sharded_conv1d(torch.ones(n, 4, 16), torch.ones(3, 4, 4),
                       group=group)
        out["uneven"] = "no error"
    except ValueError as e:
        out["uneven"] = str(e)
    try:
        sharded_conv1d(xl, torch.from_numpy(w), group=group,
                       grad_reduce=group)
        out["double"] = "no error"
    except ValueError as e:
        out["double"] = str(e)
    return out


def job_auto_keys(group, rank, world, tmp, *, batch):
    """The N every ``backend="auto"`` plan of a data-parallel loss looks
    up: the local batch."""
    from repro_torch import tune
    from repro_torch.core import blocks
    from repro_torch.train.data_parallel import shard_batch
    os.environ[tune.cache.ENV_CACHE_PATH] = os.path.join(tmp, f"c{rank}")
    seen = []
    orig = tune.get_plan

    def spy(**kw):
        seen.append(kw["N"])
        return orig(**kw)
    tune.get_plan = spy
    cfg = reduced(configs.get("atacworks"))
    model = blocks.init_params(cfg)
    reducer = mesh.GradReducer(group)
    loss, _ = blocks.loss_fn(model, cfg, shard_batch(tensors(batch), group),
                             backend="auto", grad_reduce=reducer)
    torch.autograd.grad(loss, list(model.parameters()))
    return dict(seen=sorted(set(seen)))


def job_mamba2(group, rank, world, tmp, *, batch):
    """Reduced Mamba2 gradients at this rank's share through the
    whole-list reduce."""
    from repro_torch.models import init_model
    from repro_torch.train.data_parallel import shard_batch
    cfg = reduced(configs.get("mamba2-370m"))
    model = init_model(cfg, seed=0)
    return _grads(cfg, model, shard_batch(tensors(batch), group), group)


def job_launcher(group, rank, world, tmp, *, argv):
    """``launch.train.run`` over the started group: a run with
    checkpoints, then one resumed from step 2 after the later ones are
    removed (the plain version), then on the Function path unchunked and
    with each layer reduced in 3 width ranges; each rank's printed lines
    and the all-reduces each run issued."""
    import shutil

    from repro_torch.launch import train
    ckpt = os.path.join(tmp, "ckpt")
    runs = []
    for extra in (["--ckpt-dir", ckpt, "--ckpt-every", "2"],
                  ["--ckpt-dir", ckpt, "--resume"], [],
                  ["--grad-reduce-chunks", "3"]):
        if len(runs) == 2:
            kernel_path()
        buf = io.StringIO()
        before = mesh.GradReducer.launches
        with contextlib.redirect_stdout(buf):
            summary = train.run(argv + extra)
        runs.append(dict(summary=summary, out=buf.getvalue(),
                         ckpts=sorted(os.listdir(ckpt)),
                         reduces=mesh.GradReducer.launches - before))
        torch.distributed.barrier(group)
        if rank == 0 and len(runs) == 1:
            shutil.rmtree(os.path.join(ckpt, "step_00000004"))
        torch.distributed.barrier(group)
    return dict(runs=runs)


def job_drills(group, rank, world, tmp, *, drills):
    """``launch.train.run`` once per ``(name, argv)`` of ``drills``, on
    the Function path, each over a generation 0 of all ``world`` ranks
    started from its own file store (a drill's regroups leave the ranks
    in different groups, or in none); each run's summary and this rank's
    printed lines, by name."""
    from repro_torch.launch import train
    kernel_path()
    out = {}
    for name, argv in drills:
        mesh.destroy()
        mesh.init_data_group("gloo", f"file://{tmp}/store_{name}", world,
                             rank)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = train.run(argv)
        out[name] = dict(summary=summary, out=buf.getvalue())
    return out


JOBS = {f.__name__: f for f in (job_atacworks, job_reducer_contract,
                                job_train, job_sharded, job_auto_keys,
                                job_mamba2, job_launcher, job_drills)}


def _rank_main(rank, world, tmp, job, payload):
    torch.set_num_threads(1)
    group = mesh.init_data_group("gloo", f"file://{tmp}/store", world, rank)
    try:
        out = JOBS[job](group, rank, world, tmp, **payload)
    finally:
        mesh.destroy()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(world: int, job: str, tmp, **payload) -> list[dict]:
    """Run ``job`` on ``world`` gloo ranks; every rank's result."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_rank_main, args=(world, tmp, job, payload),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
