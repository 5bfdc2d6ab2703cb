"""Training launcher of the port: the JAX package's ``launch/train.py``
(``run``, its elastic supervisor included), on the card by default.

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

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch whisper-large-v3 --attn-impl flash --steps 6 --batch 4 \
        --seq 448

trains the full Whisper-large-v3 (32 + 32 layers, bf16, remat on) on
random tokens and standard-normal frames (B, 1500, 1280): ``--seq`` is
the decoder's tokens (448, its context), the encoder's self-attention
runs non-causal and the decoder's causal through the flash kernels, the
cross-attention plain, as in the JAX package.  tokens/s counts decoder
tokens.  The conv frontend is not on the path (the frames are given);
its parameters get zero gradients and AdamW's decay, as in JAX.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --attn-impl flash --steps 6 --batch 4 --seq 4096

trains Zamba2-7B (81 Mamba2 layers and the shared attention block, bf16,
remat on), its convs through the depthwise kernels and its shared
attention (head_dim 112) through the flash kernels.  Its training state
(about 12 bytes a parameter, 81 GB) does not fit one 80 GB card: a
config cut in depth at the published widths trains (chip_smoke.py
registers ``zamba2-7b-12l``, 12 layers, the shared block applied twice,
1.41 B parameters).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch moonshot-v1-16b-a3b --smoke --device cpu --steps 3 \
        --batch 2 --seq 16

trains Moonlight (the MoE family: 64 routed experts top-6 and 2 shared
a layer after one dense layer, bf16, remat on; here the reduced config
on the CPU), its attention (16 over 16 heads of 128) through the flash
kernels with ``--attn-impl flash``, its experts as plain grouped
products.  The 28.39 B parameters' training state does not fit one card;
on the card ``chip_smoke.py`` registers and trains the cut
``moonshot-v1-16b-a3b-6l`` (the dense layer and 5 MoE layers at the
published widths, 3.70 B parameters, ``xent_chunk`` 1,024: the streamed
cross-entropy keeps one (B, 1,024, 163,840) chunk of fp32 logits at a
time) at ``--attn-impl flash --batch 4 --seq 4096``.  Each step's line
gives the total loss and, apart, the NLL (the total adds 0.01 x the
load-balance loss); the summary lists both (``losses``, ``nlls``).

``--device cpu`` runs the plain PyTorch version on the CPU (with
``--smoke`` for the reduced config); without a GPU and without that flag
it raises.  Each step prints its loss, gradient norm and time (to a
synchronisation), and the run ends with the median step time over the
steps after the first ``WARMUP_STEPS``, ``samples_per_s = batch /
median`` (and ``tokens_per_s`` for a language model), and on the card the
peak device memory.  ``--ckpt-dir`` saves atomic checkpoints in the JAX
package's format every ``--ckpt-every`` steps (asynchronously: the state
is copied to the host and written on a thread while training goes on)
and at the end; ``--resume`` continues from the newest one, with the
same batches the steps saw the first time.

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

Elastic recovery: the launcher is a *supervisor* over generations of
its process group.  Each step it consumes the ``HealthMonitor``, the
``ShardStragglerMonitor``, the ``PreemptionGuard`` and, in a drill,
a ``runtime.faults.FaultInjector`` that every rank polls with the same
``--faults`` schedule (``device_loss@STEP:N``, ``straggle@STEP:SHARDxF``,
``preempt@STEP``), so the ranks agree on a fault without a message.  A
rank is named by its launch rank, its rank in generation 0.

  * ``device_loss``: the step runs, then is declared tainted; the N
    highest launch ranks leave (their summary reads ``status: "lost"``)
    and the survivors re-plan the layout with
    ``runtime.elastic.make_plan``: the model axis fixed, the data axis
    shrunk to the widest that divides ``--batch`` (which stays the
    global batch), accumulation re-derived so the global batch is kept
    exactly.  ``runtime.elastic.build_groups`` tears the group down
    behind one barrier and starts the next generation over the
    survivors (``launch.mesh.regroup``; a survivor beyond the plan's
    ranks sits out, ``status: "idle"``); the new rank 0 waits for its
    async write and broadcasts the newest committed step, which every
    rank restores; the step, the loader and the monitor are rebuilt for
    the new groups, and the steps from the restore point are replayed on
    their step-keyed batches, their records overwritten.
  * ``straggle``: the ranks of data shard SHARD sleep (F - 1) x the
    fleet's median clean step time after each step; then one gather of
    every rank's time, outside every timing window, feeds every rank's
    monitor with every shard's time, so all reach the same verdict; on
    REPLACE the shard's ranks are rotated out as in a device loss.
  * ``preempt``: as a SIGTERM: the run drains (waits for the async
    writer, saves synchronously, stops).

``device_loss`` and ``straggle`` need ``--ckpt-dir`` (a restore point
is saved at the start when there is none).  Rank 0 of each generation
writes one ``elastic.fault`` event, one ``elastic.detect`` span and one
``elastic.recover`` span a fault, and a ``train.straggler.rollup`` per
finished generation.  The summary adds JAX's ``recoveries`` (detect and
restore seconds, step medians before and after, and
``post_shrink_efficiency``) and ``mesh_history``.  One process that
loses its device stops with JAX's message.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch atacworks --smoke --device cpu --dist-backend gloo \
        --steps 10 --batch 8 --seq 512 --ckpt-dir /tmp/ck --ckpt-every 2 \
        --faults device_loss@5:2

drills a recovery on 4 CPU ranks (dp 4 -> 2, accumulation 1 -> 2).  The
NCCL path regroups the same way; it has not run across cards.
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
from repro_torch.runtime.elastic import build_groups, make_plan
from repro_torch.runtime.faults import FaultInjector, parse_faults
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
                         "ssm, dense, moe and encdec: 2 layers, hybrid 4, "
                         "d_model 64)")
    ap.add_argument("--attn-impl", choices=("chunked", "flash"), default=None,
                    help="self-attention of a dense or encoder-decoder "
                         "model: 'chunked' (plain PyTorch) or 'flash' (the "
                         "flash kernels); default: the config's")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8,
                    help="the GLOBAL batch, preserved exactly across every "
                         "elastic re-plan")
    ap.add_argument("--seq", type=int, default=60_000,
                    help="track width (paper §4.2: 50,000 + 2 x 5,000) or "
                         "tokens per sequence (an encoder-decoder's decoder "
                         "tokens)")
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
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="fault-injection drill schedule (runtime/faults.py "
                         "grammar, e.g. 'device_loss@5:2', 'straggle@5:1x6', "
                         "'preempt@8'); device_loss and straggle recover "
                         "from --ckpt-dir")
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


def _gather_times(dt: float, device: torch.device) -> list[float]:
    """Every rank's ``dt`` of the generation's group, by rank (one
    all-reduce of a vector with this rank's slot filled)."""
    t = torch.zeros(dist.get_world_size(), dtype=torch.float64,
                    device=device)
    t[dist.get_rank()] = dt
    dist.all_reduce(t)
    return t.tolist()


def _fleet_times(dt: float, straggle, dp: int, mp: int,
                 device: torch.device) -> tuple[float, list[float]]:
    """A drill's per-shard step times: ``(this rank's dt, [each data
    shard's dt])``, the same list on every rank, so every rank's monitor
    reaches the same verdict at the same step.

    Under an active straggle the ranks of data shard ``straggle.shard %
    dp`` sleep ``(factor - 1)`` x the fleet's clean time (the median of
    every rank's, so the factor holds against the fleet) and add it to
    their dt.  The second gather comes after that sleep and outside every
    rank's timing window: the healthy ranks wait for the straggler there,
    not in their next step.  A shard's time is its slowest rank's."""
    if straggle is not None:
        delay = (straggle.factor - 1.0) * float(
            np.median(_gather_times(dt, device)))
        if dist.get_rank() // mp == straggle.shard % dp:
            time.sleep(delay)
            dt += delay
    times = _gather_times(dt, device)
    return dt, [max(times[s * mp:(s + 1) * mp]) for s in range(dp)]


def _committed_step(ckpt, started: bool, lead: bool,
                    device: torch.device) -> int | None:
    """The newest committed checkpoint's step as the generation's rank 0
    sees it once its async write has ended, on every rank (a broadcast):
    a rank reading ``latest_step()`` on its own could see an older one
    while the write is in flight.  None without a checkpoint."""
    step = -1
    if lead:
        ckpt.wait()
        latest = ckpt.latest_step()
        step = -1 if latest is None else latest
    if started:
        t = torch.tensor([step], device=device)
        dist.broadcast(t, src=0)
        step = int(t.item())
    return None if step < 0 else step


def run(argv=None) -> dict:
    """Train and return the summary of this process (``_summary``);
    ``status`` is "done", "preempted", "lost" (a rank a fault took out)
    or "idle" (a survivor the re-planned layout left out).  A telemetry
    sink ``--telemetry`` opens is closed when the run ends."""
    args = _parse_args(argv)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    faults = parse_faults(args.faults) if args.faults else None
    if faults and any(f.kind in ("device_loss", "straggle") for f in faults) \
            and not args.ckpt_dir:
        raise SystemExit(
            "--faults with device_loss/straggle needs --ckpt-dir: "
            "recovery restores from the last committed checkpoint "
            "(the in-memory state lives on the lost devices)")
    backend = args.dist_backend
    if backend is None and "WORLD_SIZE" in os.environ:
        backend = "nccl" if args.device == "cuda" else "gloo"
    started = mesh.init_data_group(backend) is not None
    world = dist.get_world_size() if started else 1
    mp = args.model_parallel
    _check_model_parallel(cfg, mp, world)
    # every rank polls its own injector over the launch ranks, with the
    # same schedule: the ranks agree on each fault without a message
    injector = FaultInjector(faults, range(world)) if faults else None
    if args.telemetry:  # after the group: records carry the rank
        obs.enable(args.telemetry)
    try:
        return _train(args, cfg, started, world, mp, injector)
    finally:
        if args.telemetry:
            obs.disable()


def _train(args, cfg, started: bool, world: int, mp: int, injector) -> dict:
    """``run``'s supervisor: the training loop over generations of the
    process group (module docstring)."""
    dp0 = world // mp
    device = _device(args, started)
    if args.batch % (args.accum * dp0):
        raise SystemExit(f"--batch {args.batch} must divide by --accum "
                         f"{args.accum} x {dp0} data-parallel ranks")
    # the launch layout's per-shard microbatch: every re-plan holds it as
    # plan_batch's cap, so accum x microbatch is always the global batch
    micro_cap = max(1, (args.batch // args.accum) // dp0)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = init_state(init_model(cfg, seed=args.seed, device=device))
    me = mesh.launch_rank()
    members = list(range(world))  # the generation's launch ranks, by rank
    health, guard = HealthMonitor(), PreemptionGuard()
    # a drill feeds the monitor from its third step after a (re)start, so
    # its own warm-up only needs to cover steady noise
    straggler = (ShardStragglerMonitor(warmup=WARMUP_STEPS) if injector
                 else ShardStragglerMonitor())
    losses: dict[int, float] = {}
    nlls: dict[int, float] = {}
    gnorms: dict[int, float] = {}
    dts: dict[int, float] = {}
    skips: dict[int, int] = {}
    recoveries: list[dict] = []
    history: list[dict] = []
    pending = None  # the recovery in flight
    start = 0
    dp, accum, lead = dp0, args.accum, True
    status = "done"

    def save(step):  # synchronous: between barriers of the generation
        if started:
            dist.barrier()
        if lead:
            ckpt.save(state, step)
        if started:
            dist.barrier()

    try:
        while True:
            gen = len(history)
            if gen == 0:
                group, model_group = mesh.init_mesh(dp0, mp)
            else:
                healthy = injector.healthy()
                if len(healthy) < mp:
                    raise SystemExit(
                        f"only {len(healthy)} healthy device(s) left; the "
                        f"model axis needs {mp} — cannot re-plan (the model "
                        "axis never changes across elastic re-plans)")
                # model axis fixed, data axis shrunk to the largest width
                # that divides the batch, accumulation re-derived: the same
                # global batch, the same trajectory
                plan = make_plan(len(healthy), model_parallel=mp,
                                 global_batch=args.batch,
                                 max_microbatch_per_shard=micro_cap)
                groups = build_groups(plan, healthy, gen)
                # a survivor the plan leaves out leaves the run for good:
                # a process that has returned cannot rejoin a later plan
                injector.mark_lost(healthy[plan.n_devices:])
                if groups is None:
                    status = "idle" if me in healthy else "lost"
                    started, lead = False, False
                    break
                group, model_group = groups
                members = healthy[:plan.n_devices]
                accum = plan.accum_steps
            dp, rank = mesh.dp_size(group), mesh.dp_rank(group)
            lead = not started or dist.get_rank() == 0
            log = print if lead else (lambda *a, **k: None)
            if gen == 0:
                if ckpt and args.resume and ckpt.latest_step() is not None:
                    state = ckpt.restore(state)
                    start = int(state.step)
                    log(f"resumed from step {start}")
                if injector and ckpt and ckpt.latest_step() is None:
                    # a restore point for a fault before the first
                    # periodic save
                    save(start)
            else:
                state = ckpt.restore(state, step=_committed_step(
                    ckpt, started, lead, device))
                start = int(state.step)
            if pending is not None:
                t_restore = time.perf_counter() - pending["t_detected"]
                if lead:
                    obs.span_event(
                        "elastic.recover", t_restore, kind=pending["kind"],
                        step=pending["step"], dp_from=pending["dp_from"],
                        dp_to=dp, mp=mp, restore_step=start)
                recoveries.append(dict(
                    kind=pending["kind"], fault_step=pending["step"],
                    restore_step=start, dp_from=pending["dp_from"], dp_to=dp,
                    mp=mp, accum=accum, time_to_detect_s=pending["t_detect"],
                    time_to_restore_s=t_restore))
                log(f"elastic: recovered dp={pending['dp_from']} -> dp={dp} "
                    f"(accum {accum}), restored step {start}, detect "
                    f"{pending['t_detect']:.3f}s restore {t_restore:.3f}s")
                for rec in (losses, nlls, gnorms, dts, skips):
                    # the replayed steps overwrite their tainted records
                    for s in [s for s in rec if s >= start]:
                        del rec[s]
                pending = None
            history.append({"dp": dp, "mp": mp, "accum": accum,
                            "from_step": start})
            if gen > 0:
                # a new generation is a new fleet epoch: its per-shard
                # times legitimately changed, so the baselines re-learn
                if lead:
                    obs.event("train.straggler.rollup", generation=gen - 1,
                              **straggler.rollup())
                straggler = ShardStragglerMonitor(warmup=WARMUP_STEPS)
            step_fn = make_train_step(
                cfg, accum_steps=accum, peak_lr=args.lr,
                warmup_steps=max(2, args.steps // 10),
                total_steps=args.steps, group=group,
                grad_reduce_chunks=args.grad_reduce_chunks,
                model_group=model_group,
                model_reduce_chunks=args.model_reduce_chunks)
            log(f"arch={cfg.name} device={device} batch={args.batch} "
                f"seq={args.seq} accum={accum}"
                + (f" attn_impl={cfg.attn_impl}"
                   if cfg.family in ("dense", "encdec", "hybrid", "moe")
                   else "")
                + (f" dp={dp} mp={mp} path=model_parallel" if mp > 1
                   else f" dp={dp} path=data_parallel" if group is not None
                   else "")
                + (f" generation={gen}" if gen else ""))
            shard = dist.get_rank() if started else 0
            drill = injector is not None and dp > 1
            probe_at = min(start + WARMUP_STEPS, args.steps - 1) \
                if gen == 0 else -1
            loader = SyntheticLoader(cfg, args.batch, args.seq,
                                     device=device, seed=args.seed,
                                     start=start, rank=rank, world=dp)
            status = "done"
            try:
                for i in range(start, args.steps):
                    fault = injector.poll(i) if injector else None
                    t_fault = None
                    if fault is not None and fault.kind == "preempt":
                        if lead:
                            obs.event("elastic.fault", kind="preempt",
                                      step=i)
                        log(f"fault: preemption delivered at step {i}")
                        guard.request()
                    elif fault is not None and fault.kind == "straggle":
                        if lead:
                            obs.event("elastic.fault", kind="straggle",
                                      step=i, shard=fault.shard,
                                      factor=fault.factor)
                        log(f"fault: shard {fault.shard} straggling "
                            f"{fault.factor:g}x from step {i}")
                        injector.begin_straggle(fault, time.perf_counter())
                    elif fault is not None:  # device_loss
                        t_fault = time.perf_counter()
                        if lead:
                            obs.event("elastic.fault", kind="device_loss",
                                      step=i, n_lost=fault.n_devices,
                                      healthy=len(members) - fault.n_devices)

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

                    if t_fault is not None:
                        # the victims died at the step's start; a
                        # synchronous step surfaces that only at its sync
                        # point, so detection costs about one step, and the
                        # step's result is tainted: recover from the last
                        # checkpoint
                        t_detect = time.perf_counter() - t_fault
                        if lead:
                            obs.span_event("elastic.detect", t_detect,
                                           kind="device_loss", step=i)
                        victims = injector.commit_loss(fault)
                        log(f"elastic: device loss at step {i} (launch "
                            f"ranks {sorted(victims)}), detected in "
                            f"{t_detect:.3f}s; re-planning the layout")
                        pending = {"kind": "device_loss", "step": i,
                                   "t_detect": t_detect,
                                   "t_detected": time.perf_counter(),
                                   "dp_from": dp}
                        status = "fault"
                        break

                    straggle = injector.straggle_active() if injector \
                        else None
                    if drill:
                        dt, shard_dts = _fleet_times(dt, straggle, dp, mp,
                                                     device)
                    losses[i], dts[i] = loss, dt
                    if "nll" in metrics:
                        nlls[i] = float(metrics["nll"])
                    gnorms[i] = float(metrics["grad_norm"])
                    skips[i] = int(metrics["skipped"])
                    if obs.enabled():
                        obs.span_event("train.step", dt, step=i, loss=loss)
                    if drill:
                        # the fleet view: every shard's time, the first
                        # WARMUP_STEPS after a (re)start kept out of the
                        # healthy baselines
                        verdicts = set()
                        for s, dt_s in enumerate(shard_dts):
                            if lead and obs.enabled():
                                obs.gauge("train.shard.step_time", dt_s,
                                          shard=s, step=i)
                            if i - start >= WARMUP_STEPS:
                                verdicts.add(straggler.record(s, i, dt_s))
                        sverdict = ("replace" if "replace" in verdicts
                                    else "slow" if "slow" in verdicts
                                    else "ok")
                    else:
                        if obs.enabled():
                            obs.gauge("train.shard.step_time", dt,
                                      shard=shard, step=i)
                        sverdict = straggler.record(shard, i, dt)
                    verdict = health.record(i, loss, bool(skips[i]))
                    log(f"step {i:5d} loss {loss:.4f} "
                        + (f"nll {nlls[i]:.4f} " if cfg.family == "moe"
                           else "")
                        + f"gnorm {gnorms[i]:.3f} dt {dt:.3f}s "
                        f"[{verdict}/{sverdict}]", flush=True)
                    obs.flush()
                    if straggle is not None and sverdict == "replace":
                        # rotate the slow shard's ranks out of the next
                        # generation
                        row = straggle.shard % dp
                        victims = members[row * mp:(row + 1) * mp]
                        t_detect = (time.perf_counter()
                                    - injector.straggle_onset())
                        if lead:
                            obs.span_event("elastic.detect", t_detect,
                                           kind="straggle", step=i,
                                           shard=row)
                        log(f"elastic: straggler shard {row} voted REPLACE "
                            f"at step {i} (launch ranks {victims}), "
                            f"detected in {t_detect:.3f}s; re-planning the "
                            "layout")
                        injector.mark_lost(victims)
                        injector.end_straggle()
                        pending = {"kind": "straggle", "step": i,
                                   "t_detect": t_detect,
                                   "t_detected": time.perf_counter(),
                                   "dp_from": dp}
                        status = "fault"
                        break
                    if probe is not None:
                        for phase, sec in probe.phases().items():
                            obs.span_event(f"train.phase.{phase}", sec,
                                           step=i)
                        if dp > 1:
                            obs.span_event("train.phase.psum", psum_probe(
                                state.params.parameters(), group, device),
                                step=i)
                        if cfg.family == "conv":
                            _telemetry_conv_probe(cfg, device)
                            obs.flush()
                    if verdict == "restore" and ckpt:
                        step = _committed_step(ckpt, started, lead, device)
                        if step is not None:
                            log("health: restoring the newest checkpoint")
                            state = ckpt.restore(state, step=step)
                    if ckpt and lead and (i + 1) % args.ckpt_every == 0:
                        ckpt.save_async(state, i + 1)
                    if _agree(guard.preempted(), started, device):
                        log("preemption: saving a checkpoint and stopping")
                        if ckpt:
                            save(i + 1)  # waits for the async writer first
                        status = "preempted"
                        break
            finally:
                loader.close()
            if status != "fault":
                break
    finally:
        if ckpt:
            ckpt.wait()
        guard.close()
        if status not in ("lost", "idle"):
            obs.event("train.health.rollup", **health.rollup())
            obs.event("train.straggler.rollup", **straggler.rollup())
    if ckpt and args.steps > start and status == "done":
        save(args.steps)
    return _summary(args, cfg, device, dict(
        status=status, dp=dp, mp=mp, accum=accum, start=start,
        losses=losses, nlls=nlls, gnorms=gnorms, dts=dts, skips=skips,
        recoveries=recoveries, history=history, health=health,
        straggler=straggler), print if lead else (lambda *a, **k: None))


def _summary(args, cfg, device: torch.device, r: dict, log) -> dict:
    """The run's summary: JAX's keys (``status``, ``first_step``,
    ``last_step``, ``losses``, ``recoveries``, ``mesh_history``,
    ``steady_step_s``, ``samples_per_s``) and the port's (``nlls`` of a
    language model, ``grad_norms``,
    ``skipped_steps``, ``step_s``, ``median_step_s``, ``dp``, ``mp``,
    ``accum``, ``health``, ``straggler``, ``tokens_per_s``,
    ``peak_memory_gb``).  The per-step lists are in step order; a step
    replayed after a recovery holds its last run's record."""
    dts, history = r["dts"], r["history"]
    # per-generation median step time without its first WARMUP_STEPS;
    # step s belongs to the last generation whose range holds it
    for g, entry in enumerate(history):
        lo = entry["from_step"]
        hi = (history[g + 1]["from_step"] if g + 1 < len(history)
              else args.steps)
        owned = [s for s in sorted(dts) if lo <= s < hi]
        steady = [dts[s] for s in owned[WARMUP_STEPS:]] or \
                 [dts[s] for s in owned]
        entry["steps_run"] = len(owned)
        entry["median_step_s"] = float(np.median(steady)) if steady else None
    for k, rec in enumerate(r["recoveries"]):
        pre = history[k]["median_step_s"]
        post = history[k + 1]["median_step_s"]
        rec["pre_fault_step_s"] = pre
        rec["post_recovery_step_s"] = post
        if pre and post:
            # per-rank throughput kept across the shrink at a fixed global
            # batch: (G / post / dp_to) / (G / pre / dp_from)
            rec["post_shrink_efficiency"] = (
                (pre * rec["dp_from"]) / (post * rec["dp_to"]))
    steps = sorted(r["losses"])
    losses = [r["losses"][s] for s in steps]
    times = [dts[s] for s in steps]
    summary = {"arch": cfg.name, "device": str(device), "steps": args.steps,
               "attn_impl": cfg.attn_impl, "dp": r["dp"], "mp": r["mp"],
               "first_step": steps[0] if steps else r["start"],
               "last_step": steps[-1] if steps else None,
               "global_batch": args.batch, "seq": args.seq,
               "accum": r["accum"], "losses": losses,
               "nlls": [r["nlls"][s] for s in steps if s in r["nlls"]],
               "grad_norms": [r["gnorms"][s] for s in steps],
               "skipped_steps": sum(r["skips"].values()), "step_s": times,
               "status": r["status"], "recoveries": r["recoveries"],
               "mesh_history": history, "health": r["health"].rollup(),
               "straggler": r["straggler"].rollup()}
    if times:
        measured = times[WARMUP_STEPS:] or times
        steady = float(np.median(measured))
        summary.update(median_step_s=steady, steady_step_s=steady,
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
    """The command line: ``run``, then end the process group it trained
    over."""
    try:
        run(argv)
    finally:
        mesh.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
