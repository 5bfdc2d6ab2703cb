"""Train step factory (counterpart of ``repro/train/train_step.py``): loss
-> gradients (with microbatch accumulation; over a data group through
``train/data_parallel.py``) -> optional gradient compression -> non-finite
guard -> AdamW update.

The JAX step is a pure function of an immutable state.  Here the state's
model is an ``nn.Module`` and the step updates it in place: the global
gradient norm comes first, then ``adamw.update_`` overwrites the
parameters, the moments and the count leaf by leaf (no whole copy of the
state is live), and the step counter is replaced.  Nothing in the step
waits for the device: the learning rate comes from the step counter on
the device, and a non-finite loss or gradient norm skips the step with
``torch.where`` (old values kept), not with a host-side branch.  The step
returns its metrics as 0-d tensors; the caller decides when to read them.

Over a data group every rank holds the same state and steps it with the
same, already summed gradients: the norm and the non-finite guard read
them after the all-reduce, so every rank skips the same steps.

**Phase probes** (the ``train.phase.*`` figures of telemetry; JAX's
``make_phase_probes``).  JAX times jitted prefixes of the step against
each other on copies of the state.  Here the optimizer updates the live
state in place, and a copy of a 3 B model's state does not fit beside
it, so a probe times one real step at its own boundaries instead:
``train_step(state, batch, probe=PhaseProbe(device))`` marks the end of
the forward, of the backward (the gradient reduces in flight end inside
it) and of the optimizer (clip, norm, AdamW), with CUDA events on the
card, the host clock on the CPU.  Marks add no work to the step and move
no value in it.  ``psum_probe`` times JAX's fourth phase when dp > 1: an
all-reduce of a zero tree shaped as the gradients over the data group.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.optim import adamw, compression, schedule
from repro_torch.train.data_parallel import make_sharded_grad_fn, param_grads
from repro_torch.train.losses import make_loss_fn


@dataclass
class TrainState:
    params: nn.Module        # the model; its parameters are the params
    opt: adamw.AdamWState
    step: torch.Tensor       # int32, 0-d, on the model's device
    ef: dict[str, torch.Tensor] | None = None  # fp32 error feedback


def init_state(model: nn.Module, *,
               grad_compression: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(params=model, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      ef=(compression.init_error_feedback(params)
                          if grad_compression else None))


class PhaseProbe:
    """The phases of one training step, timed at their boundaries on
    ``device``: :meth:`mark` ends the phase it names (the first phase
    starts when the probe is made); :meth:`phases` sums each phase's
    intervals (microbatches alternate forward and backward) once the
    device is synchronized."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: list = []
        self.mark(None)

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self, phase: str | None) -> None:
        self._marks.append((phase, self._now()))

    def phases(self) -> dict[str, float]:
        """Seconds per phase, in the order the phases first ended."""
        out: dict[str, float] = {}
        for (_, a), (phase, b) in zip(self._marks, self._marks[1:]):
            if self.cuda:
                b.synchronize()
                sec = a.elapsed_time(b) / 1e3
            else:
                sec = b - a
            out[phase] = out.get(phase, 0.0) + sec
        return out


def psum_probe(params, group, device: torch.device) -> float:
    """Seconds of one all-reduce of zeros shaped as ``params`` (one reduce
    a leaf, fp32) over the data group ``group``: JAX's ``psum`` phase."""
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=device)
             for p in params]
    probe = PhaseProbe(device)
    works = [dist.all_reduce(z, group=group, async_op=True) for z in zeros]
    for work in works:
        work.wait()
    probe.mark("psum")
    return probe.phases()["psum"]


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` consecutive slices of the batch (JAX's reshape to
    (accum, B // accum, ...))."""
    return [{k: v[i * (v.shape[0] // accum):(i + 1) * (v.shape[0] // accum)]
             for k, v in batch.items()} for i in range(accum)]


def make_train_step(cfg, *, accum_steps: int = 1, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    group=None, grad_compression: bool = False,
                    grad_reduce_chunks: int | None = None, model_group=None,
                    model_reduce_chunks: int | None = None):
    """``train_step(state, batch) -> (state, metrics)``.  With
    ``accum_steps > 1`` the batch is split into that many microbatches;
    their gradients are summed in fp32 and divided, and the loss is their
    mean.  AdamW clips at global norm 1.0 and decays by 0.1 (its
    defaults).  ``metrics``: loss, grad_norm, lr and skipped, 1.0 where a
    non-finite loss or gradient norm left the state as it was.

    ``group`` (a data group, ``launch.mesh``) makes ``batch`` this rank's
    share of the global batch and the gradients those of
    ``make_sharded_grad_fn`` (each microbatch's reduced on its own);
    ``grad_reduce_chunks`` is its knob; ``model_group`` (with
    ``model_reduce_chunks``) K-shards the conv layers over this rank's
    model group, the layout's other axis.  ``group=None`` and
    ``model_group=None`` is the single-process step.
    ``grad_compression`` rounds the gradients to bf16 with the error
    feedback carried in ``state.ef``
    (``init_state(..., grad_compression=True)``).  ``probe`` (a
    :class:`PhaseProbe`) times the step's phases (module docstring).  A
    language model's metrics add ``nll``, the loss without an MoE model's
    ``AUX_WEIGHT * aux`` (the loss itself for the other families)."""
    if group is None and model_group is None:
        loss_fn = make_loss_fn(cfg)

        def grads_of(model, params, batch, probe):
            loss, aux = loss_fn(model, batch)
            if probe is not None:
                probe.mark("forward")
            grads = param_grads(loss, params)
            if probe is not None:
                probe.mark("backward")
            return loss.detach(), aux.get("nll"), grads
    else:
        grad_fn = make_sharded_grad_fn(
            cfg, group, grad_reduce_chunks=grad_reduce_chunks,
            model_group=model_group, model_reduce_chunks=model_reduce_chunks)

        def grads_of(model, params, batch, probe):
            (loss, aux), grads = grad_fn(model, batch, probe=probe)
            return loss, aux.get("nll"), grads

    def train_step(state: TrainState, batch: dict,
                   probe: PhaseProbe | None = None):
        model = state.params
        names, params = zip(*model.named_parameters())
        if accum_steps > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params]
            lsum = nsum = 0.0
            for mb in _split_microbatches(batch, accum_steps):
                loss, nll, g = grads_of(model, params, mb, probe)
                gsum = [a + b.float() for a, b in zip(gsum, g)]
                lsum = lsum + loss
                nsum = None if nll is None else nsum + nll.detach()
            grads = [g / accum_steps for g in gsum]
            loss = lsum / accum_steps
            nll = None if nsum is None else nsum / accum_steps
        else:
            loss, nll, grads = grads_of(model, params, batch, probe)

        lr = schedule.cosine_with_warmup(
            state.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
            total_steps=total_steps)
        grads = dict(zip(names, grads))
        if grad_compression:
            if state.ef is None:
                raise ValueError("grad_compression needs the state's error "
                                 "feedback: init_state(model, "
                                 "grad_compression=True)")
            q, state.ef = compression.compress(grads, state.ef)
            grads = compression.decompress(q)
        gnorm = adamw.global_norm(grads)
        finite = torch.isfinite(gnorm) & torch.isfinite(loss)
        adamw.update_(grads, state.opt, dict(zip(names, params)), lr=lr,
                      grad_norm=gnorm, finite=finite)
        state.step = state.step + 1
        if probe is not None:
            probe.mark("optimizer")
        metrics = {"grad_norm": gnorm, "skipped": (~finite).float(),
                   "loss": loss, "lr": lr}
        if nll is not None:
            metrics["nll"] = nll.detach()
        return state, metrics

    return train_step
