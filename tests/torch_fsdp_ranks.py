"""Rank-side jobs of ``test_torch_fsdp.py``: the port's FSDP training of
the language models (``models.fsdp_model``, ``sharding.DataShards``,
the FSDP branch of ``make_sharded_grad_fn``, the step, checkpoints and
the launcher) run by two gloo ranks on the CPU, and the tensor-parallel
Mamba2 rank that ``convert`` loads.

Kept apart from the test module so that each spawned rank imports torch
and the port, not JAX.  ``spawn(world, tmp, **payload)`` starts
``world`` ranks (start method ``spawn``, one thread each, a file store
under ``tmp``), runs :func:`job` in each and returns every rank's result
dict.  Each part of the job records its error instead of raising, so a
part that fails on both ranks leaves the others to report.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pickle
import traceback
import weakref
from collections import namedtuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs, convert, models
from repro_torch.configs.base import reduced
from repro_torch.launch import mesh
from repro_torch.models import sharding

JaxOpt = namedtuple("JaxOpt", "m v count")
JaxState = namedtuple("JaxState", "params opt step")


def tensors(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _cfg(arch, **kw):
    return dataclasses.replace(reduced(configs.get(arch)), **kw)


def _whole(cfg, jparams):
    return models.model_class(cfg)(cfg, convert.params_from_jax(jparams))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# --- parts: part(group, rank, world, tmp, **kw) -> dict ---------------------

def part_parity(group, rank, world, tmp, *, arch, jparams, batches, kw):
    """One family: the rank's blocks against ``local_state_dict``, the
    FSDP gradient blocks against the whole-parameter path's on the first
    batch, then the train step's losses and final blocks from JAX's
    initial state (``convert.train_state_from_jax(..., group=)``)."""
    from repro_torch.train.data_parallel import (make_sharded_grad_fn,
                                                 shard_batch)
    from repro_torch.train.train_step import make_train_step
    cfg = _cfg(arch)
    whole = _whole(cfg, jparams)
    model = models.fsdp_model(whole, group)
    want = sharding.local_state_dict(whole, sharding.fsdp_mesh(world),
                                     (rank, 0))
    out = dict(block_shapes={k: tuple(p.shape)
                             for k, p in model.named_parameters()},
               blocks_equal={k: bool(torch.equal(p, want[k]))
                             for k, p in model.named_parameters()},
               split={k: model.ds.split(k) for k in want})
    fn = make_sharded_grad_fn(cfg, group)
    local = shard_batch(tensors(batches[0]), group)
    if cfg.moe is not None:  # the same loss: the global batch's statistics
        whole.data_group = group
    (lw, _), gw = fn(whole, local)
    (lf, _), gf = fn(model, local)
    names = [k for k, _ in model.named_parameters()]
    out["grad_mismatch"] = [k for k, a, b in zip(names, gw, gf)
                            if not torch.equal(model.ds.block(k, a), b)]
    out["grad_losses"] = (float(lw), float(lf))
    zeros = {k: np.zeros_like(v) for k, v in
             convert.params_from_jax(jparams).items()}
    jstate = JaxState(jparams, JaxOpt(zeros, zeros, np.int32(0)),
                      np.int32(0))
    state = convert.train_state_from_jax(jstate, cfg, group=group)
    step = make_train_step(cfg, group=group, **kw)
    losses = []
    for b in batches:
        state, m = step(state, shard_batch(tensors(b), group))
        losses.append(float(m["loss"]))
    out.update(losses=losses, params={k: _np(p) for k, p in
                                      state.params.named_parameters()},
               moment_shapes={k: (tuple(state.opt.m[k].shape),
                                  tuple(state.opt.v[k].shape))
                              for k in state.opt.m},
               state_bytes=sum(t.numel() * t.element_size() for t in (
                   *state.params.parameters(), *state.opt.m.values(),
                   *state.opt.v.values())))
    return out


def part_capacity(group, rank, world, tmp, *, arch, moe_kw, jparams,
                  batch):
    """Moonlight with the capacity dispatch (``moe_kw``) on the FSDP
    rank: the first gradient's blocks and the global loss; ``dropped``,
    the assignments the one-process dispatch drops of the global batch
    (so the capacity binds)."""
    from repro_torch.models import moe
    from repro_torch.train.data_parallel import (make_sharded_grad_fn,
                                                 shard_batch)
    cfg = _cfg(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    whole = _whole(cfg, jparams)
    model = models.fsdp_model(whole, group)
    (loss, _), grads = make_sharded_grad_fn(cfg, group)(
        model, shard_batch(tensors(batch), group))
    names = [k for k, _ in model.named_parameters()]
    whole.routing = moe.RoutingLog()
    with torch.no_grad():
        whole(tensors(batch)["tokens"])
    dropped = 0
    for layer in whole.routing.layers():
        experts, _ = whole.routing.selection(layer)
        counts = torch.bincount(experts.reshape(-1),
                                minlength=cfg.moe.n_experts)
        cap = moe.capacity(cfg, experts.shape[0] * experts.shape[1])
        dropped += int((counts - cap).clamp(min=0).sum())
    return dict(loss=float(loss), dropped=dropped,
                grads={k: _np(g) for k, g in zip(names, grads)})


def part_convert_state(group, rank, world, tmp, *, arch, jparams):
    """``train_state_from_jax`` with a mesh and coordinates: a data
    rank's blocks of the parameters and of random moments."""
    cfg = _cfg(arch)
    flat = convert.params_from_jax(jparams)
    rng = np.random.default_rng(7)
    m = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in flat.items()}
    v = {k: rng.random(v.shape).astype(np.float32) for k, v in flat.items()}
    jstate = JaxState(jparams, JaxOpt(m, v, np.int32(3)), np.int32(3))
    shape = sharding.fsdp_mesh(world)
    state = convert.train_state_from_jax(jstate, cfg, mesh=shape,
                                         coords=(rank, 0))
    want = {name: sharding.local_state_dict(
        {k: torch.from_numpy(a) for k, a in tree.items()}, shape, (rank, 0))
        for name, tree in (("m", m), ("v", v))}
    wparams = sharding.local_state_dict(flat, shape, (rank, 0))
    return dict(
        params=all(torch.equal(p, wparams[k])
                   for k, p in state.params.named_parameters()),
        moments=all(torch.equal(getattr(state.opt, n)[k], want[n][k])
                    for n in ("m", "v") for k in want[n]),
        count=int(state.opt.count), step=int(state.step))


def part_property(group, rank, world, tmp, *, arch, jparams, batch):
    """Under remat: the gathered leaves alive at each gather (a spy on
    ``DataShards._all_gather``), the gathers and scatters of one
    gradient, and a rank handed whole leaves where it expects blocks."""
    from repro_torch.train.data_parallel import (make_sharded_grad_fn,
                                                 shard_batch)
    cfg = _cfg(arch, remat=True)
    whole = _whole(cfg, jparams)
    model = models.fsdp_model(whole, group)
    ds = model.ds
    real = ds._all_gather
    groups: list = []  # (a layer's gather?, weak references to its leaves)
    seen: list = []  # after each gather: (layers', others') gathers alive

    def spy(keys, blocks):
        out = real(keys, blocks)
        groups.append((all(k.startswith(STACKS) for k in keys),
                       [weakref.ref(t) for t in out]))
        seen.append(tuple(
            sum(any(r() is not None for r in refs)
                for layer, refs in groups if layer == kind)
            for kind in (True, False)))
        return out

    ds._all_gather = spy
    fn = make_sharded_grad_fn(cfg, group)
    local = shard_batch(tensors(batch), group)
    before = ds.counts()
    fn(model, local)
    ds._all_gather = real
    out = dict(alive=seen, gathers=ds.gathers - before["gathers"],
               scatters=ds.scatters - before["scatters"])
    bad = type(whole)(cfg, dict(whole.state_dict()))
    bad.ds = ds
    try:
        fn(bad, local)
        out["whole_leaf"] = "no error"
    except ValueError as e:
        out["whole_leaf"] = str(e)
    return out


STACKS = ("dense_layers.", "moe_layers.", "enc_layers.", "dec_layers.",
          "layers.")


def part_checkpoint(group, rank, world, tmp, *, arch, jparams, batch, kw):
    """One FSDP step, a checkpoint of it (``save_async`` on every rank,
    rank 0 writing), restored into a fresh template of blocks; the whole
    arrays gathered for the one process to compare with."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.train.data_parallel import shard_batch
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = _cfg(arch)
    whole = _whole(cfg, jparams)
    state = init_state(models.fsdp_model(whole, group))
    state, _ = make_train_step(cfg, group=group, **kw)(
        state, shard_batch(tensors(batch), group))
    ckpt = Checkpointer(os.path.join(tmp, "ckpt_fsdp"))
    ckpt.save_async(state, 1)
    ckpt.wait()
    dist.barrier(group)
    fresh = init_state(models.fsdp_template(whole, cfg, group, "cpu"))
    fresh = ckpt.restore(fresh)
    ds = state.params.ds
    same = all(torch.equal(a, b) for a, b in zip(
        state.params.parameters(), fresh.params.parameters()))
    same &= all(torch.equal(state.opt.m[k], fresh.opt.m[k])
                and torch.equal(state.opt.v[k], fresh.opt.v[k])
                for k in state.opt.m)
    gathered = {k: _np(ds.whole(k, p)) for k, p in
                state.params.named_parameters()}
    gathered.update({f"m.{k}": _np(ds.whole(k, t))
                     for k, t in state.opt.m.items()})
    return dict(restored_equal=same, step=int(fresh.step),
                whole=gathered if rank == 0 else None,
                written=sorted(os.listdir(ckpt.directory)))


def part_convert_ssm(group, rank, world, tmp, *, jparams, prompt, gen):
    """A reduced Mamba2 rank at mp 2: its blocks from
    ``convert.params_from_jax(..., mesh=, coords=, cfg=)`` and its cache
    from ``cache_from_jax(..., cfg=)`` (the one process's after the
    prompt) against the rank ``models.local_model`` builds, decoding on
    from the prompt over its own cache: logits at each step."""
    from repro_torch.models import mamba2
    cfg = _cfg("mamba2-370m")
    whole = mamba2.Mamba2(cfg, convert.params_from_jax(jparams))
    shape, coords = mesh.make_host_mesh(model=world)
    _, model_group = mesh.init_mesh(1, world)
    loaded = models.place_rank(mamba2.Mamba2(cfg, convert.params_from_jax(
        jparams, mesh=shape, coords=coords, cfg=cfg)), shape, coords,
        model_group)
    ref = models.local_model(whole, shape, coords, model_group)
    out = dict(blocks_equal=all(torch.equal(a, b) for a, b in zip(
        loaded.state_dict().values(), ref.state_dict().values())))
    B, T = prompt.shape
    tokens = torch.from_numpy(prompt)
    with torch.inference_mode():
        one = mamba2.init_cache(cfg, B, T + gen)
        rc = mamba2.init_cache(cfg, B, T + gen, mp=world)
        for t in range(T):
            _, one = mamba2.decode_step(whole, one, tokens[:, t:t + 1], t)
            _, rc = mamba2.decode_step(ref, rc, tokens[:, t:t + 1], t)
        lc = convert.cache_from_jax({k: _np(v) for k, v in one.items()},
                                    mesh=shape, coords=coords, cfg=cfg)
        out["cache_shapes"] = ({k: tuple(v.shape) for k, v in lc.items()},
                               {k: tuple(v.shape) for k, v in rc.items()})
        tok = tokens[:, -1:]
        logits = []
        for t in range(T, T + gen):
            a, lc = mamba2.decode_step(loaded, lc, tok, t)
            b, rc = mamba2.decode_step(ref, rc, tok, t)
            w, one = mamba2.decode_step(whole, one, tok, t)
            logits.append((_np(a), _np(b), _np(w)))
            tok = w[:, -1].argmax(-1, keepdim=True)
    out["logits"] = logits
    return out


def part_launcher(group, rank, world, tmp, *, runs):
    """``launch.train.run`` once per ``(name, argv)``, each over a group
    of all ``world`` ranks started from its own file store (a fault's
    regroup leaves the ranks in different groups, or in none): the
    summary and this rank's printed lines, by name."""
    from repro_torch.launch import train
    out = {}
    for name, argv in runs:
        mesh.destroy()
        mesh.init_data_group("gloo", f"file://{tmp}/store_{name}", world,
                             rank)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = train.run(argv)
        out[name] = dict(summary=summary, out=buf.getvalue())
    return out


PARTS = {f.__name__: f for f in (part_parity, part_capacity,
                                 part_convert_state,
                                 part_property, part_checkpoint,
                                 part_convert_ssm, part_launcher)}


def job(group, rank, world, tmp, *, parts):
    """Each ``(label, part, kwargs)`` of ``parts`` in order: its result,
    or its error's traceback under ``"error"``."""
    out = {}
    for label, part, kw in parts:
        try:
            out[label] = PARTS[part](group, rank, world, tmp, **kw)
        except Exception:  # reported to the test, which fails on it
            out[label] = {"error": traceback.format_exc()}
        if part == "part_launcher":  # the launcher leaves other groups
            group = None
    return out


def _rank_main(rank, world, tmp, payload):
    torch.set_num_threads(1)
    group = mesh.init_data_group("gloo", f"file://{tmp}/store", world, rank)
    try:
        out = job(group, rank, world, tmp, **payload)
    finally:
        mesh.destroy()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(world: int, tmp, **payload) -> list[dict]:
    """Run :func:`job` on ``world`` gloo ranks; every rank's result."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_rank_main, args=(world, tmp, payload),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
