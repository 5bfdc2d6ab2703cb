"""Rank-side jobs of ``test_torch_model_parallel.py``,
``test_torch_tp_serve.py`` and ``test_torch_tp_serve_ssm.py``: the port's
tensor-parallel paths (AtacWorks training, the language models' serving)
run by gloo ranks on the CPU.

Kept apart from the test module so that each spawned rank imports torch
and the port, not JAX.  ``spawn(world, mp, job, tmp, **payload)`` starts
``world`` ranks (start method ``spawn``, one thread each, a file store
under ``tmp`` for the rendezvous, never a TCP port), lays them out as
(world / mp, mp) with ``launch.mesh.init_mesh``, runs the job named
``job`` in each with its data and model groups and returns every rank's
result dict.
"""
from __future__ import annotations

import contextlib
import copy
import io
import os
import pickle

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from repro_torch import configs, convert
from repro_torch.configs.base import reduced
from repro_torch.kernels import ops
from repro_torch.kernels import sharded as sh
from repro_torch.launch import mesh
from repro_torch.models import sharding

from torch_dp_ranks import atac_model, kernel_path, tensors


def _counts() -> dict:
    return dict(param_reduces=mesh.GradReducer.launches,
                dx_reduces=mesh.ModelReducer.launches,
                gathers=sh.ModelConcat.launches)


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _grads(cfg, model, batch, data, model_group, chunks=None,
           grad_chunks=None):
    from repro_torch.train.data_parallel import make_sharded_grad_fn
    fn = make_sharded_grad_fn(cfg, data, model_group=model_group,
                              model_reduce_chunks=chunks,
                              grad_reduce_chunks=grad_chunks)
    before = _counts()
    (loss, aux), grads = fn(model, batch)
    return dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                grads=[g.detach().float().numpy().copy() for g in grads],
                counts=_since(before),
                pending=fn.reducer.pending)


# --- jobs: job(data, model, rank, tmp, **payload) -> dict -----------------

def job_grads(data, model_group, rank, tmp, *, jparams, batch, chunks,
              train_batch):
    """The reduced AtacWorks gradients of this rank's data shard, K-sharded
    over its model group: the plain version, then the Function path at
    each dx chunk count and with 2 width ranges to each data sum; in bf16 on the Function path, K-sharded, over the
    data group alone, and (rank 0) in one process on the global batch;
    one train step from the same state."""
    import dataclasses

    from repro_torch.train.data_parallel import shard_batch
    from repro_torch.train.train_step import init_state, make_train_step
    local = shard_batch(tensors(batch), data)
    cfg, model = atac_model(jparams)
    out = {"ref": _grads(cfg, model, local, data, model_group)}
    kernel_path()
    for c in chunks:
        out[f"function{c}"] = _grads(cfg, model, local, data, model_group,
                                     chunks=c)
    out["function_g2"] = _grads(cfg, model, local, data, model_group,
                                grad_chunks=2)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    out["bf16"] = _grads(cfg16, model16, local, data, model_group)
    out["bf16_data_only"] = _grads(cfg16, model16, local, data, None)
    if rank == 0:
        out["bf16_one"] = _grads(cfg16, model16, tensors(batch), None, None)
    state = init_state(model)
    step = make_train_step(cfg, group=data, model_group=model_group,
                           total_steps=10)
    state, m = step(state, shard_batch(tensors(train_batch), data))
    out["train"] = dict(loss=float(m["loss"]), params={
        k: p.detach().numpy().copy()
        for k, p in state.params.named_parameters()})
    return out


def job_ops(data, model_group, rank, tmp, *, x, w, b, wd, bd, chunks):
    """One K-sharded layer's dx, unchunked and chunked, on the Function
    path; the sharded wrappers' outputs and gradients (the plain ops);
    the depthwise wrapper's collectives."""
    mp_, r = mesh.mp_size(model_group), mesh.mp_rank(model_group)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    out = {}
    k = wt.shape[1] // mp_
    w_l = wt[:, r * k:(r + 1) * k].contiguous()
    b_l = bt[r * k:(r + 1) * k].contiguous()
    for c in chunks:
        xx = xt.clone().requires_grad_()
        before = _counts()
        y = ops.fused_conv1d(F.pad(xx, (4, 4)), w_l, bias=b_l,
                             activation="relu", dilation=2,
                             model_reduce=model_group, model_reduce_chunks=c)
        (y ** 2).sum().backward()
        out[f"dx{c}"] = xx.grad.numpy().copy()
        out[f"dx{c}_counts"] = _since(before)
    for name, fn, ww, bb, kw in (
            ("dense", sh.model_sharded_conv1d, w, b,
             dict(activation="relu", dilation=2, padding="SAME")),
            ("depthwise", sh.model_sharded_depthwise_conv1d, wd, bd,
             dict(activation="silu"))):
        xx = torch.from_numpy(x).requires_grad_()
        wg = torch.from_numpy(ww).requires_grad_()
        bg = torch.from_numpy(bb).requires_grad_()
        before = _counts()
        y = fn(xx, wg, group=data, model_group=model_group, bias=bg, **kw)
        (y ** 2).sum().backward()
        out[name] = dict(y=y.detach().numpy(), dx=xx.grad.numpy(),
                         dw=wg.grad.numpy(), db=bg.grad.numpy(),
                         counts=_since(before))
    return out


def job_refusals(data, model_group, rank, tmp):
    """The errors of a model axis that cannot shard the config."""
    from repro_torch.launch import train
    from repro_torch.train.data_parallel import make_sharded_grad_fn
    out = {}
    for key, arch in (("c15", "atacworks"), ("ssm", "mamba2-370m")):
        try:
            make_sharded_grad_fn(configs.get(arch), data,
                                 model_group=model_group)
            out[f"gradfn_{key}"] = "no error"
        except ValueError as e:
            out[f"gradfn_{key}"] = str(e)
    try:
        train.run(["--arch", "atacworks", "--device", "cpu",
                   "--model-parallel", "2"])
        out["launch_c15"] = "no error"
    except SystemExit as e:
        out["launch_c15"] = str(e)
    return out


def job_launcher(data, model_group, rank, tmp, *, argv):
    """``launch.train.run`` with ``--model-parallel`` over the started
    world, on the Function path; its summary and printed lines."""
    from repro_torch.launch import train
    kernel_path()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train.run(argv)
    dist.barrier()
    return dict(summary=summary, out=buf.getvalue(),
                ckpts=sorted(os.listdir(os.path.join(tmp, "ckpt"))))


def _selection(log) -> dict:
    return {layer: log.selection(layer)[0].numpy().copy()
            for layer in log.layers()}


def _arch(argv) -> str:
    return argv[argv.index("--arch") + 1]


def job_tp_serve(data, model_group, rank, tmp, *, cases, launchers):
    """Tensor-parallel serving of each case's model (its JAX tree, the
    rank's blocks over the model group, ``models.local_model``): an
    encoder-decoder's cross K/V filled from the case's ``frames`` (the
    group's collectives counted), decode steps teacher-forced over
    ``prompt``, then ``gen`` greedy ones (logits, tokens, an MoE model's
    selection, the group's collectives a step), an MLA model's absorbed
    decode over the prompt, and the fused prefill (behind a VLM's
    ``patches``, with Whisper's ``frames``); then ``serve.serve_lm`` from
    each of ``launchers``' argv (``--smoke``: the arch's reduced
    config)."""
    from repro_torch.launch import serve
    from repro_torch.models import init_model, local_model, moe, whisper
    from repro_torch.train import serve_step
    mp_ = mesh.mp_size(model_group)
    shape, coords = mesh.make_host_mesh(model=mp_)
    out = {}
    for name, c in cases.items():
        cfg, prompt = c["cfg"], torch.from_numpy(c["prompt"])
        B, T = prompt.shape
        full = init_model(cfg)
        full.load_state_dict(convert.params_from_jax(c["jparams"]))
        model = local_model(full, shape, coords, model_group)
        res = dict(weights={k: p.detach().numpy().copy()
                            for k, p in model.named_parameters()})
        frames = (torch.from_numpy(c["frames"]) if "frames" in c else None)
        for absorb in ((False, True) if cfg.mla else (False,)):
            model.routing = moe.RoutingLog() if cfg.moe else None
            cache = serve_step.make_cache(cfg, B, T + c["gen"],
                                          dtype=torch.float32, mp=mp_)
            if frames is not None:
                before = model.tp.counts()
                whisper.fill_cross_cache(model, cache, frames)
                after = model.tp.counts()
                res["fill"] = dict(
                    cross={k: cache[k].numpy().copy()
                           for k in ("cross_k", "cross_v")},
                    sums=after["sums"] - before["sums"],
                    gathers=after["gathers"] - before["gathers"])
            step = serve_step.make_serve_step(cfg, absorb=absorb)
            logits, tokens = [], []
            before = model.tp.counts()
            tok = prompt[:, :1]
            for t in range(T + (0 if absorb else c["gen"])):
                tok = prompt[:, t:t + 1] if t < T else tok
                tok, cache, lg = step(model, cache, tok, t)
                logits.append(lg.numpy().copy())
                tokens.append(tok.numpy().copy())
            after = model.tp.counts()
            key = "absorbed" if absorb else "decode"
            res[key] = dict(logits=logits, tokens=tokens,
                            steps=len(logits),
                            sums=after["sums"] - before["sums"],
                            gathers=after["gathers"] - before["gathers"])
            if model.routing is not None:
                res[key]["selection"] = _selection(model.routing)
        model.routing = moe.RoutingLog() if cfg.moe else None
        batch = {"tokens": prompt}
        if "patches" in c:
            batch["patches"] = torch.from_numpy(c["patches"])
        if frames is not None:
            batch["frames"] = frames
        nxt, lg = serve_step.make_prefill_step(cfg)(model, batch)
        res["prefill"] = dict(logits=lg.numpy().copy(),
                              tokens=nxt.numpy().copy())
        if model.routing is not None:
            res["prefill"]["selection"] = _selection(model.routing)
        out[name] = res
    out["launchers"] = {}
    for name, argv in launchers.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = serve.serve_lm(serve.parse_args(argv),
                                   reduced(configs.get(_arch(argv))))
        out["launchers"][name] = dict(
            out=buf.getvalue(), tokens=stats["tokens"],
            prompt_logits=stats["prompt_logits"].numpy().copy(),
            **{k: stats[k] for k in ("model_parallel", "weights_bytes",
                                     "cache_bytes", "collectives", "coords",
                                     "prefill_gap")})
    return out


def _gathers_spy(ds):
    """Record each of ``ds``'s gathers: (a layer's?, weak references to
    the gathered tensors); ``seen`` the layers' gathers alive after each
    gather.  Returns (groups, seen, undo)."""
    import weakref
    real = ds._all_gather
    groups: list = []
    seen: list = []

    def spy(keys, blocks):
        out = real(keys, blocks)
        groups.append((all(k.startswith(LAYER_STACKS) for k in keys),
                       [weakref.ref(t) for t in out]))
        seen.append(sum(any(r() is not None for r in refs)
                        for layer, refs in groups if layer))
        return out

    ds._all_gather = spy
    return groups, seen, lambda: setattr(ds, "_all_gather", real)


LAYER_STACKS = ("dense_layers.", "moe_layers.", "enc_layers.", "dec_layers.",
                "layers.")


def _counts_of(group) -> dict:
    """A ModelGroup's or DataShards' counts, zeros for None."""
    if group is None:
        return dict(sums=0, gathers=0, scatters=0, seconds=0.0)
    return dict(dict(sums=0, scatters=0), **group.counts())


def _cache_layout(model) -> dict:
    """``make_cache``'s ``mp``, ``rank`` and ``dp`` of a rank's model."""
    return dict(mp=1 if model.tp is None else model.tp.size,
                rank=0 if model.tp is None else model.tp.rank,
                dp=1 if model.ds is None else model.ds.size)


def _dp_run(model, cfg, c, batch, rows, absorb):
    """One decode over the case's prompt rows ``rows`` of its first
    ``batch`` (teacher-forced, then ``gen`` greedy steps; an MLA model's
    absorbed decode over the prompt alone), and the fused prefill: the
    logits, tokens and the collectives of the decode's steps."""
    import gc

    from repro_torch.models import moe, whisper
    from repro_torch.train import serve_step
    prompt = torch.from_numpy(c["prompt"][:batch][rows])
    B, T = prompt.shape
    frames = (torch.from_numpy(c["frames"][:batch][rows])
              if "frames" in c else None)
    model.routing = moe.RoutingLog() if cfg.moe else None
    cache = serve_step.make_cache(cfg, batch, T + c["gen"],
                                  dtype=torch.float32, **_cache_layout(model))
    if frames is not None:
        whisper.fill_cross_cache(model, cache, frames)
    step = serve_step.make_serve_step(cfg, absorb=absorb)
    groups = seen = None
    if model.ds is not None:
        groups, seen, undo = _gathers_spy(model.ds)
    counts = [_counts_of(g) for g in (model.tp, model.ds)]
    logits, tokens = [], []
    tok = prompt[:, :1]
    for t in range(T + (0 if absorb else c["gen"])):
        tok = prompt[:, t:t + 1] if t < T else tok
        tok, cache, lg = step(model, cache, tok, t)
        logits.append(lg.numpy().copy())
        tokens.append(tok.numpy().copy())
    del lg
    gc.collect()
    after = [_counts_of(g) for g in (model.tp, model.ds)]
    res = dict(logits=logits, tokens=tokens, steps=len(logits),
               sums=after[0]["sums"] - counts[0]["sums"],
               gathers=after[0]["gathers"] - counts[0]["gathers"],
               data_gathers=after[1]["gathers"] - counts[1]["gathers"],
               cache_batch=next(sharding.tree_leaves(cache)).shape[1])
    if groups is not None:
        undo()
        res["alive_at_gather"] = max(seen)
        res["alive_after"] = sum(r() is not None for _, refs in groups
                                 for r in refs)
    if model.routing is not None:
        res["selection"] = _selection(model.routing)
    if absorb:
        return res
    model.routing = moe.RoutingLog() if cfg.moe else None
    pb = {"tokens": prompt}
    if "patches" in c:
        pb["patches"] = torch.from_numpy(c["patches"][:batch][rows])
    if frames is not None:
        pb["frames"] = frames
    before = _counts_of(model.ds)["gathers"]
    nxt, lg = serve_step.make_prefill_step(cfg)(model, pb)
    res["prefill"] = dict(
        logits=lg.numpy().copy(), tokens=nxt.numpy().copy(),
        data_gathers=_counts_of(model.ds)["gathers"] - before)
    model.routing = None
    return res


def _dp_cache(model, whole, cfg, c, rows, shape, coords):
    """``convert.cache_from_jax`` of the one process's cache after the
    prompt (the whole model on the case's whole batch) on the mesh,
    against the rank's own cache after its rows' prompt: the shapes of
    each leaf, and the largest difference over the cache's largest
    value."""
    from repro_torch.train import serve_step
    prompt = torch.from_numpy(c["prompt"])
    B, T = prompt.shape
    step = serve_step.make_serve_step(cfg)
    one = serve_step.make_cache(cfg, B, T, dtype=torch.float32)
    mine = serve_step.make_cache(cfg, B, T, dtype=torch.float32,
                                 **_cache_layout(model))
    for t in range(T):
        step(whole, one, prompt[:, t:t + 1], t)
        step(model, mine, prompt[rows, t:t + 1], t)
    got = convert.cache_from_jax(
        {k: (v.numpy() if torch.is_tensor(v) else
             {kk: vv.numpy() for kk, vv in v.items()})
         for k, v in one.items()}, mesh=shape, coords=coords, cfg=cfg)
    pairs = list(zip(sharding.tree_leaves(got), sharding.tree_leaves(mine)))
    scale = max(float(b.abs().max()) for _, b in pairs)
    return dict(shapes=[(tuple(a.shape), tuple(b.shape)) for a, b in pairs],
                gap=max(float((a - b).abs().max()) for a, b in pairs) / scale)


def job_dp_serve(data, model_group, rank, tmp, *, cases, launchers,
                 main=None, convert_cache=()):
    """Serving on the (world / mp, mp) mesh: each case's model (its JAX
    tree, ``models.local_model`` with the data group) at each of its
    batches, its data row's prompt rows (``sharding.batch_rows``) decoded
    and prefilled by ``_dp_run`` (plain and, for MLA, absorbed); the
    blocks against ``convert.params_from_jax(..., mesh=, coords=, cfg=)``
    and ``local_state_dict``; ``serve.serve_lm`` from each of
    ``launchers``' argv, then ``serve.main(main)`` (when given), which
    ends the group; for the cases in ``convert_cache``, ``_dp_cache``.
    On a data axis of one rank (dp 1) the model has no ``ds``: its
    ``ds_shapes`` are None and it gathers nothing over the data group."""
    from repro_torch import models
    from repro_torch.launch import serve
    mp_ = mesh.mp_size(model_group)
    shape, coords = mesh.make_host_mesh(model=mp_)
    dp = shape.shape["data"]
    out = {}
    for name, c in cases.items():
        cfg = c["cfg"]
        whole = models.model_class(cfg)(cfg, convert.params_from_jax(
            c["jparams"]))
        model = models.local_model(whole, shape, coords, model_group,
                                   data_group=data)
        loaded = convert.params_from_jax(c["jparams"], mesh=shape,
                                         coords=coords, cfg=cfg)
        want = sharding.local_state_dict(whole, shape, coords, cfg=cfg)
        held = model.state_dict()
        res = dict(
            blocks_equal=(set(held) == set(loaded) == set(want) and all(
                torch.equal(p, loaded[k]) and torch.equal(p, want[k])
                for k, p in held.items())),
            block_shapes={k: tuple(p.shape) for k, p in held.items()},
            weights_bytes=sum(p.numel() * p.element_size()
                              for p in model.parameters()),
            expert_ids=model.expert_ids if cfg.moe else None,
            ds_shapes=None if model.ds is None else dict(model.ds.shapes))
        for batch in c["batches"]:
            rows = sharding.batch_rows(batch, dp, coords["data"])
            model = models.local_model(whole, shape, coords, model_group,
                                       data_group=data, batch=batch)
            res[batch] = dict(rows=(rows.start, rows.stop),
                              global_drops=getattr(
                                  model, "data_group", None) is not None,
                              decode=_dp_run(model, cfg, c, batch, rows,
                                             False))
            if cfg.mla:
                res[batch]["absorbed"] = _dp_run(model, cfg, c, batch, rows,
                                                 True)
        if name in convert_cache:
            rows = sharding.batch_rows(len(c["prompt"]), dp, coords["data"])
            res["cache"] = _dp_cache(model, whole, cfg, c, rows, shape,
                                     coords)
        out[name] = res
    out["launchers"] = {}
    for name, argv in launchers.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = serve.serve_lm(serve.parse_args(argv),
                                   reduced(configs.get(_arch(argv))))
        out["launchers"][name] = dict(
            out=buf.getvalue(), tokens=stats["tokens"],
            prompt=stats["prompt"].numpy().copy(),
            prompt_logits=stats["prompt_logits"].numpy().copy(),
            **{k: stats[k] for k in (
                "model_parallel", "data_parallel", "weights_bytes",
                "tokens_per_s", "row_tokens_per_s", "steps", "step_s",
                "cache_bytes", "collectives", "coords", "rows",
                "prefill_gap", "peak_bytes")})
    if main is not None:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = serve.main(main)
        out["main"] = dict(code=code, out=buf.getvalue(),
                           group_left=dist.is_initialized())
    return out


# The JAX reference of the serving tests, run as ``python -c`` with two
# pickle paths (in: ``(cases, runs)``, out: the results): for each run
# ``(case, (dp, mp), batch)``, the case's reduced config (``arch``, its
# ``over`` config overrides and ``moe_kw`` MoE overrides) with its
# ``jparams`` placed by ``param_pspecs`` on a ``("data", "model")`` mesh
# of ``dp * mp`` of 4 virtual CPU devices (the serve launcher's
# placement), JAX's jitted ``make_serve_step`` teacher-forced over the
# ``prompt``'s first ``batch`` rows then ``gen`` greedy steps (Whisper's
# cross K/V filled from its ``frames``), and its ``make_prefill_step``
# (a VLM's behind its ``patches``).  A string: this module imports no JAX.
JAX_SERVE_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, pickle
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.configs.base import reduced
from repro.models import sharding as shd
from repro.models import whisper
from repro.train import serve_step

with open(sys.argv[1], "rb") as f:
    cases, runs = pickle.load(f)
assert len(jax.devices()) == 4
out = {}
for name, (dp, mp), batch in runs:
    c = cases[name]
    cfg = reduced(configs.get(c["arch"]), **c.get("over", {}))
    if c["moe_kw"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **c["moe_kw"]))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:dp * mp]).reshape(
        dp, mp), ("data", "model"))
    with mesh:  # the serve launcher's placement, then its loop
        p = jax.tree.map(jnp.asarray, c["jparams"])
        p = jax.tree.map(lambda a, s: jax.device_put(
            a, jax.sharding.NamedSharding(mesh, s)), p,
            shd.param_pspecs(p, mesh))
        prompt = jnp.asarray(c["prompt"][:batch])
        cache = serve_step.make_cache(cfg, batch, prompt.shape[1] + c["gen"],
                                      dtype=jnp.float32)
        pb = {"tokens": prompt}
        if "frames" in c:
            frames = jnp.asarray(c["frames"][:batch])
            enc = whisper.encode(p, cfg, frames)
            k, v = jax.vmap(lambda lp: whisper.cross_kv(lp, enc, cfg))(
                p["dec_layers"]["cross"])
            cache = dict(cache, cross_k=k, cross_v=v)
            pb["frames"] = frames
        if "patches" in c:
            pb["patches"] = jnp.asarray(c["patches"][:batch])
        step = jax.jit(serve_step.make_serve_step(cfg))
        logits, tokens = [], []
        tok = prompt[:, :1]
        for t in range(prompt.shape[1] + c["gen"]):
            if t < prompt.shape[1]:
                tok = prompt[:, t:t + 1]
            tok, cache, lg = step(p, cache, tok, jnp.int32(t))
            logits.append(np.asarray(lg))
            tokens.append(np.asarray(tok))
        ptok, plog = jax.jit(serve_step.make_prefill_step(cfg))(p, pb)
    out[(name, (dp, mp), batch)] = dict(
        logits=logits, tokens=tokens, prefill=np.asarray(plog),
        prefill_tokens=np.asarray(ptok))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


JOBS = {f.__name__: f for f in (job_grads, job_ops, job_refusals,
                                job_launcher, job_tp_serve, job_dp_serve)}


def _rank_main(rank, world, mp_, tmp, job, payload):
    torch.set_num_threads(1)
    mesh.init_data_group("gloo", f"file://{tmp}/store", world, rank)
    try:
        data, model_group = mesh.init_mesh(world // mp_, mp_)
        layout = (mesh.dp_rank(data), mesh.mp_rank(model_group),
                  mesh.dp_size(data), mesh.mp_size(model_group))
        out = JOBS[job](data, model_group, rank, tmp, **payload)
        out["layout"] = layout  # a job may end the group
    finally:
        mesh.destroy()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(world: int, mp_: int, job: str, tmp, **payload) -> list[dict]:
    """Run ``job`` on ``world`` gloo ranks laid out as (world / mp, mp);
    every rank's result."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_rank_main, args=(world, mp_, tmp, job, payload),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

