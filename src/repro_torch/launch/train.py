"""Training launcher of the port: the single-device path of the JAX
package's ``launch/train.py`` (``run``), on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch atacworks \\
        --steps 10 --batch 8 --seq 60000

trains the 25-layer AtacWorks model on synthetic ATAC-seq tracks (batch 8
x width 60,000: 50k segments padded by 5k on both sides, paper §4.2)
through the hand-written conv kernels, forward and backward.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 10 --batch 8 --seq 2048

trains the full Mamba2-370M (48 layers, bf16, remat on) on uniform random
tokens, batch 8 x 2,048 (the Mamba-2 paper's pretraining context), its
causal conv through the hand-written depthwise kernels.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --attn-impl flash --steps 8 --batch 4 --seq 4096

trains the full StarCoder2-3B (30 layers, bf16, remat on) on uniform
random tokens at its 4,096-token pretraining context, attention through
the hand-written flash kernels (``--attn-impl`` sets the config's
``attn_impl``, as ``dataclasses.replace(cfg, attn_impl="flash")`` does in
the JAX package; the configs default to ``chunked``, plain PyTorch).

``--device cpu`` runs the plain PyTorch version on the CPU (with
``--smoke`` for the reduced config); without a GPU and without that flag
it raises.  Each step prints its loss, gradient norm and time (to a
synchronisation), and the run ends with the median step time over the
steps after the first ``WARMUP_STEPS``, ``samples_per_s = batch /
median`` (and ``tokens_per_s`` for a language model), and on the card the
peak device memory.  ``--ckpt-dir`` saves atomic checkpoints in the JAX
package's format every ``--ckpt-every`` steps and at the end;
``--resume`` continues from the newest one, with the same batches the
steps saw the first time.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch atacworks --steps 10 --batch 8 --seq 60000

trains data-parallel, one process per card (``cuda:LOCAL_RANK``, taken
modulo the cards present, so ``--dist-backend gloo`` may put every rank
on one card): ``--batch`` stays the global batch, each rank trains on
its contiguous share, and every layer's weight and bias gradients are
all-reduced right after its bwd-weight pass (``train/data_parallel.py``;
``--grad-reduce-chunks`` splits each into width ranges).  Rank 0 alone
prints, saves checkpoints (between barriers) and prints the summary,
which adds ``dp``.  A world of 1 with no ``--dist-backend`` is the
single-process path; ``--dist-backend`` names the backend (default NCCL
on the card, gloo on the CPU), and a caller that has started a group
before ``run`` trains over it.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch atacworks-bf16 --model-parallel 2 --steps 10

adds tensor parallelism: the world is laid out as (dp, mp) = (world /
N, N) (``launch.mesh.init_mesh``), every conv layer whose filter count
divides is K-sharded over the N ranks of a model group, which hold the
same data shard (the loader takes ``rank=data_rank, world=dp``), and each
layer's dx is summed over them after its bwd-data pass
(``--model-reduce-chunks`` splits that sum into column ranges).  The
world must divide by N, and so must the config's ``conv_channels``
(atacworks' 15 does not; atacworks-bf16's 16 does).  Parameters and
checkpoints stay whole: rank 0 saves one unsharded set.  The summary adds
``mp``.

Each step also feeds the step monitors (``repro_torch.runtime``): a
``HealthMonitor`` (skipped steps, loss spikes; on a ``restore`` verdict
the newest checkpoint is restored) and a ``ShardStragglerMonitor`` fed
this rank's step time; their verdicts end the step's line (``[ok/ok]``)
and their rollups the run.  A SIGTERM (``PreemptionGuard``) stops the run
after the step in flight, with a checkpoint of it under ``--ckpt-dir``;
in a group the ranks agree on it after each step (one all-reduce of a
flag), so every rank stops at the same step.

``--telemetry PATH`` (or ``REPRO_TORCH_TELEMETRY=1``) writes a telemetry
log (``repro_torch.obs``), opened once the process group has started so
every record carries its rank: a ``train.step.data`` and a
``train.step`` span a step, a ``train.shard.step_time`` gauge per rank
and step, every conv pass's span (device time on the card), the phases
of the step at ``WARMUP_STEPS`` after the start (``train.phase.forward``,
``backward``, ``optimizer``, and ``psum`` when dp > 1;
``train_step.PhaseProbe``), after that step the arch's conv cell once
through ``backend="auto"`` (tuner counters and pass spans,
``_telemetry_conv_probe``), and the health and straggler rollups.
Telemetry moves no value of the step: losses and gradient norms are
bitwise those of a run without it.  ``python -m repro_torch.obs.report
PATH --check`` reads it.

The JAX launcher's elastic supervisor and fault drills wait in
ROADMAP.md queue A.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, obs
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import reduced
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.launch import mesh
from repro_torch.launch.device import require_device
from repro_torch.models import init_model
from repro_torch.runtime.health import HealthMonitor, PreemptionGuard
from repro_torch.runtime.straggler import ShardStragglerMonitor
from repro_torch.train.train_step import (PhaseProbe, init_state,
                                          make_train_step, psum_probe)

# steps excluded from throughput: the first pays the kernels' build and
# load, the second first-touch allocation
WARMUP_STEPS = 2
# the probe cell's width (JAX's _telemetry_conv_probe)
PROBE_WIDTH = 512


def _telemetry_conv_probe(cfg, device: torch.device) -> None:
    """The arch's conv cell (C -> C, its taps and dilation, batch 1 x
    ``PROBE_WIDTH``, SAME, fp32) once through ``backend="auto"``, the JAX
    launcher's probe: the plan's cache lookups count as tuner hits or
    misses, and the forward, then a forward and its gradient to x and w
    (bwd-data and bwd-weight through ``ops.Conv1dFunction``), log their
    pass spans."""
    from repro_torch import tune
    from repro_torch.kernels import ops
    C, S, d = cfg.conv_channels, cfg.conv_filter, cfg.conv_dilation
    if not (C and S):
        return
    tune.get_plan(N=1, C=C, K=C, S=S, dilation=d, Q=PROBE_WIDTH,
                  dtype=torch.float32, padding="SAME", device=device)
    x = torch.ones((1, C, PROBE_WIDTH), device=device)
    w = torch.full((S, C, C), 0.01, device=device)
    ops.conv1d(x, w, dilation=d, padding="SAME", backend="auto")
    x.requires_grad_()
    w.requires_grad_()
    y = ops.conv1d(x, w, dilation=d, padding="SAME", backend="auto")
    torch.autograd.grad(y, (x, w), torch.ones_like(y))


def _parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (conv: C=8, S=9; "
                         "ssm and dense: 2 layers, d_model 64)")
    ap.add_argument("--attn-impl", choices=("chunked", "flash"), default=None,
                    help="attention of a dense model: 'chunked' (plain "
                         "PyTorch) or 'flash' (the flash kernels); default: "
                         "the config's")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=60_000,
                    help="track width (paper §4.2: 50,000 + 2 x 5,000) or "
                         "tokens per sequence")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per step (gradients summed in fp32)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="start a data group with this backend (default "
                         "under torchrun: nccl on the card, gloo on the CPU)")
    ap.add_argument("--grad-reduce-chunks", type=int, default=None,
                    help="data parallel: all-reduce each layer's gradients "
                         "in this many width ranges")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel (model-axis) width: K-shard the "
                         "conv filters over groups of this many ranks; the "
                         "world and conv_channels must divide by it")
    ap.add_argument("--model-reduce-chunks", type=int, default=None,
                    help="with --model-parallel > 1: sum each layer's dx "
                         "over the model group in this many column ranges")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write a telemetry JSONL log to PATH (as "
                         "REPRO_TORCH_TELEMETRY=1 with "
                         "REPRO_TORCH_TELEMETRY_PATH); the ranks of a group "
                         "share it")
    return ap.parse_args(argv)


def _check_model_parallel(cfg, mp: int, world: int) -> None:
    """The layout's rules (JAX's launcher's messages): the world divides
    into rows of ``mp`` ranks, and the conv family's channels divide."""
    if mp < 1 or world % mp:
        raise SystemExit(
            f"--model-parallel {mp} does not divide the {world} rank(s); "
            "the (data, model) layout needs whole rows of model ranks: "
            "pick N with world % N == 0")
    if mp == 1:
        return
    if cfg.family != "conv":
        raise SystemExit(
            f"--model-parallel needs the conv family (arch {cfg.name} is "
            f"family {cfg.family!r}): only the conv layers K-shard over the "
            "model group")
    if cfg.conv_channels % mp:
        raise SystemExit(
            f"--model-parallel {mp} does not divide this model's filter "
            f"counts: conv_channels={cfg.conv_channels} (every body layer "
            f"has K=C={cfg.conv_channels} filters), so C % N must be 0; "
            "use a config with divisible channels (atacworks-bf16) or "
            "lower --model-parallel")


def _device(args, started: bool) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` modulo the cards present
    (ranks sharing a card under gloo), or the CPU when asked for."""
    if not started or args.device != "cuda":
        return require_device(args.device)
    require_device("cuda")
    dev = torch.device("cuda", mesh.local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _agree(flag: bool, started: bool, device: torch.device) -> bool:
    """``flag`` on any rank of the started group (one all-reduce), or this
    process's own without a group."""
    if not started:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def run(argv=None) -> dict:
    """Train and return a summary: losses, gradient norms, the number of
    steps skipped for a non-finite loss or gradient, per-step times,
    median step time after warm-up, samples/s (and tokens/s for a
    language model), on the card the peak device memory, ``status``
    ("done" or "preempted") and the health and straggler rollups.
    A telemetry sink ``--telemetry`` opens is closed when the run ends."""
    args = _parse_args(argv)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    backend = args.dist_backend
    if backend is None and "WORLD_SIZE" in os.environ:
        backend = "nccl" if args.device == "cuda" else "gloo"
    started = mesh.init_data_group(backend) is not None
    world = dist.get_world_size() if started else 1
    mp = args.model_parallel
    _check_model_parallel(cfg, mp, world)
    group, model_group = mesh.init_mesh(world // mp, mp)
    if args.telemetry:  # after the group: records carry the rank
        obs.enable(args.telemetry)
    try:
        return _train(args, cfg, started, mp, group, model_group)
    finally:
        if args.telemetry:
            obs.disable()


def _train(args, cfg, started: bool, mp: int, group, model_group) -> dict:
    """``run``'s training loop over the started groups."""
    dp, rank = mesh.dp_size(group), mesh.dp_rank(group)
    lead = not started or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    device = _device(args, started)
    if args.batch % (args.accum * dp):
        raise SystemExit(f"--batch {args.batch} must divide by --accum "
                         f"{args.accum} x {dp} data-parallel ranks")
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = init_state(init_model(cfg, seed=args.seed, device=device))
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(state.step)
        log(f"resumed from step {start}")
    step_fn = make_train_step(cfg, accum_steps=args.accum, peak_lr=args.lr,
                              warmup_steps=max(2, args.steps // 10),
                              total_steps=args.steps, group=group,
                              grad_reduce_chunks=args.grad_reduce_chunks,
                              model_group=model_group,
                              model_reduce_chunks=args.model_reduce_chunks)
    log(f"arch={cfg.name} device={device} batch={args.batch} "
        f"seq={args.seq} accum={args.accum}"
        + (f" attn_impl={cfg.attn_impl}" if cfg.family == "dense" else "")
        + (f" dp={dp} mp={mp} path=model_parallel" if mp > 1
           else f" dp={dp} path=data_parallel" if group is not None else ""))

    def save(step):
        if started:
            dist.barrier()
        if lead:
            ckpt.save(state, step)
        if started:
            dist.barrier()

    losses, gnorms, dts, skipped = [], [], [], 0
    health, straggler = HealthMonitor(), ShardStragglerMonitor()
    guard = PreemptionGuard()
    shard = dist.get_rank() if started else 0
    probe_at = min(start + WARMUP_STEPS, args.steps - 1)
    status = "done"
    loader = SyntheticLoader(cfg, args.batch, args.seq, device=device,
                             seed=args.seed, start=start, rank=rank,
                             world=dp)
    try:
        for i in range(start, args.steps):
            t_data = time.perf_counter()
            batch = next(loader)
            probe = None
            if obs.enabled():  # off: one check, no record built
                obs.span_event("train.step.data",
                               time.perf_counter() - t_data, step=i)
                probe = PhaseProbe(device) if i == probe_at else None
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch, probe=probe)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            loss = float(metrics["loss"])
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            step_skipped = int(metrics["skipped"])
            skipped += step_skipped
            dts.append(dt)
            if obs.enabled():
                obs.span_event("train.step", dt, step=i, loss=loss)
                obs.gauge("train.shard.step_time", dt, shard=shard, step=i)
            sverdict = straggler.record(shard, i, dt)
            verdict = health.record(i, loss, bool(step_skipped))
            log(f"step {i:5d} loss {loss:.4f} gnorm {gnorms[-1]:.3f} "
                f"dt {dt:.3f}s [{verdict}/{sverdict}]", flush=True)
            obs.flush()
            if probe is not None:
                for phase, sec in probe.phases().items():
                    obs.span_event(f"train.phase.{phase}", sec, step=i)
                if dp > 1:
                    obs.span_event("train.phase.psum", psum_probe(
                        state.params.parameters(), group, device), step=i)
                if cfg.family == "conv":
                    _telemetry_conv_probe(cfg, device)
                    obs.flush()
            if (verdict == "restore" and ckpt
                    and ckpt.latest_step() is not None):
                log("health: restoring the newest checkpoint")
                state = ckpt.restore(state)
            if ckpt and (i + 1) % args.ckpt_every == 0:
                save(i + 1)
            if _agree(guard.preempted(), started, device):
                log("preemption: saving a checkpoint and stopping")
                if ckpt:
                    save(i + 1)
                status = "preempted"
                break
    finally:
        loader.close()
        guard.close()
        obs.event("train.health.rollup", **health.rollup())
        obs.event("train.straggler.rollup", **straggler.rollup())
    if ckpt and args.steps > start and status == "done":
        save(args.steps)

    summary = {"arch": cfg.name, "device": str(device), "steps": args.steps,
               "attn_impl": cfg.attn_impl, "dp": dp, "mp": mp,
               "first_step": start, "global_batch": args.batch,
               "seq": args.seq, "accum": args.accum, "losses": losses,
               "grad_norms": gnorms, "skipped_steps": skipped,
               "step_s": dts, "status": status, "health": health.rollup(),
               "straggler": straggler.rollup()}
    if dts:
        measured = dts[WARMUP_STEPS:] or dts
        steady = float(np.median(measured))
        summary.update(median_step_s=steady,
                       samples_per_s=args.batch / steady)
        rate = f"{args.batch / steady:.2f} samples/s"
        if cfg.family != "conv":
            summary["tokens_per_s"] = args.batch * args.seq / steady
            rate += f", {summary['tokens_per_s']:.0f} tokens/s"
        log(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; median step "
            f"{steady * 1e3:.2f} ms over {len(measured)} steps after "
            f"warm-up ({rate})")
    if device.type == "cuda":
        summary["peak_memory_gb"] = torch.cuda.max_memory_allocated(
            device) / 1e9
        log(f"peak device memory {summary['peak_memory_gb']:.2f} GB")
    return summary


def main(argv=None) -> int:
    """The command line: ``run``, then end a data group it started."""
    try:
        run(argv)
    finally:
        mesh.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
