"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``):
batched greedy decode for the language models, batched continuous
streaming for the conv family.  It runs on the card by default.

Language models (the SSM family, Mamba2, the dense transformers, the
MoE family, Moonlight and DeepSeek-V3, the VLM, InternVL2, the
encoder-decoder, Whisper, and the hybrid, Zamba2): build the cache of
``--prompt-len`` seeded
prompt tokens by sequential teacher-forced decode steps, as the JAX
launcher does (the fused prefill is ``train.serve_step.
make_prefill_step``, which ``--smoke`` checks against it), then generate
``--gen`` tokens greedily, reporting the prefill's time, the decode
step's p50/p99 and tokens/s:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --batch 8 --prompt-len 200 --gen 64

Whisper first encodes seeded frames (``data.synthetic.encdec_batch``'s
draw, (B, 1500, 1280) at full width) and fills the cache's
cross-attention K/V from them (``models.whisper.fill_cross_cache``,
timed as ``encode_s``); the JAX launcher skips that step and decodes
against zero cross K/V, which ignores the audio (ROADMAP.md queue C):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --batch 8 --prompt-len 4 --gen 64

Zamba2-7B serves at its full depth (81 Mamba2 layers, the shared block's
13 applications, 13.6 GB of bf16 weights); the fused prefill that
``--smoke`` checks runs 81 ``depthwise_conv1d_fwd`` and, with
``attn_impl="flash"`` (``serve_lm(args, dataclasses.replace(cfg,
attn_impl="flash"))``; the launcher has no flag for it, as JAX's has
none), 13 ``flash_fwd`` launches:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --batch 8 --prompt-len 200 --gen 64

Moonlight-16B-A3B serves at its full depth (48 layers, 28.39 B
parameters, 56.8 GB of bf16 weights, drawn on the host's cores slab by
slab); its experts run as plain grouped products, one device sync a MoE
layer a step for the group sizes; with ``attn_impl="flash"`` the fused
prefill runs 48 ``flash_fwd`` launches:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot-v1-16b-a3b --batch 8 --prompt-len 200 --gen 64

DeepSeek-V3 (671 B parameters) serves on one card only cut in depth:
``chip_smoke.py`` registers ``deepseek-v3-671b-4l`` (its 3 dense layers
and 1 MoE layer of all 256 experts, every published width, 15.11 B
parameters, 30.2 GB in bf16) and serves it through ``serve_lm`` at batch
8; its cache is the compressed MLA cache (each layer's latent and
rotary key, ``models/mla.py``) and its fused prefill runs 4 ``flash_fwd``
launches at head_dim 192.  The launcher decodes plainly (the latent
re-expanded each step), as JAX's, which has no flag for the absorbed
decode; ``train.serve_step.make_serve_step(cfg, absorb=True)`` gives it.

InternVL2-2B decodes text, as the JAX launcher does (its decode step
takes no image); the image embeddings reach serving through the fused
prefill alone.  Its ``--smoke`` check holds the fused text prefill to
the decode, as for a dense model, then runs the fused prefill once more
behind ``n_image_tokens`` seeded image embeddings (``vlm_batch``'s draw,
(B, 256, 2048) at full width) and checks its logits are finite; with
``attn_impl="flash"`` each fused prefill runs 24 ``flash_fwd`` launches:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \
        --batch 8 --prompt-len 200 --gen 64

An MoE model's ``--smoke`` check holds the fused prefill to the decode
with the decode's expert selection replayed (``moe.RoutingLog``):
routing is discontinuous, and where a token's k-th and (k+1)-th
selection scores lie closer than the two paths' rounding the prefill
would pick another expert, a jump no tolerance of rounding covers.  The
prefill's own selection is compared too: its flips per layer, the
smallest selection margin and the largest score difference are
reported.

The cache is fp32 where the JAX launcher runs one (the SSM family, and
fp32 configs) and in the model's dtype for a bf16 dense, encoder-decoder
or hybrid model: with an fp32 KV cache the JAX package's bf16 attention
output turns fp32 and its layer scan (or, for the hybrid, its ``cond``)
refuses the carry (ROADMAP.md queue C), so the model's dtype
(``make_cache``'s default) is the one it can run.  A hybrid's Mamba2
states are fp32 whatever the cache's dtype, as in JAX.  The decode step runs
no kernel (as in the JAX package, where XLA takes it).

``--model-parallel N`` serves any language model tensor-parallel over N
ranks started by ``torchrun`` (the JAX launcher places the parameters
by ``models/sharding.py``'s rules and GSPMD partitions the decode): each
rank draws the same seeded model on the host, keeps the blocks it
executes at its coordinate on the (1, N) mesh
(``launch.mesh.make_host_mesh``, ``models.local_model``: the rules'
blocks, an SSM model's fused ``in_proj`` and conv segment-aligned, the
attention's head-aligned) and its share of the cache (the KV heads its
query heads read; an SSM model's H/N heads and conv channels; Whisper's
query heads of the cross K/V), and runs the model
group's sums and logit gather where GSPMD inserts them (Mamba2's and
Zamba2's also over each gated norm's sum of squares).  The fused
prefill runs ``flash_fwd`` on each rank's heads (Zamba2's shared block,
Whisper's encoder and decoder) and ``depthwise_conv1d_fwd`` on its
conv channels (Mamba2, Zamba2).  ``--dist-backend gloo`` lets the ranks
share one card (``cuda:LOCAL_RANK`` modulo the cards present); rank 0
prints, and the summary adds ``model_parallel``, a rank's weight and
cache bytes and the group's collectives a decode step:

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch starcoder2-3b --model-parallel 2 --dist-backend gloo \
        --batch 8 --prompt-len 200 --gen 64

(``--arch mamba2-370m``, ``zamba2-7b`` or ``whisper-large-v3`` alike;
with ``--device cpu --smoke`` the reduced config on the CPU.)

A world larger than N is JAX's serve launcher's ``(world / N, N)`` host
mesh (``make_host_mesh(model=N)``), ``--model-parallel 1`` on a world of
more than one rank included: the parameters are placed FSDP-style by the
same rules, every ``'dp'`` dimension split over the data rows (an MoE
stack's experts over ``('data', 'model')`` where they divide), so a rank
holds its 2-D blocks; where a layer runs, its column block is gathered
over the rank's data group (``sharding.DataShards``) and the model
group's collectives run on it as above; no gathered weight outlives its
layer.  The batch splits over the data rows where it divides (each row's
cache holds its rows; an MoE model's capacity drops are the global
batch's), else every row serves the whole batch; the tokens and prompt
logits are gathered, the whole batch's on every rank.  The fused prefill
runs ``flash_fwd`` and ``depthwise_conv1d_fwd`` at a data row's rows:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch starcoder2-3b --model-parallel 2 --dist-backend gloo \
        --batch 8 --prompt-len 200 --gen 64

Heads and KV heads that do not divide over N serve with head-aligned
blocks (``sharding.head_blocks``): where N divides over the KV heads,
each KV head is replicated on N / KV ranks (its ``wk``/``wv`` columns,
``bk``/``bv`` and cache) and its group's query heads split among them,
the larger blocks first; multi-head attention's heads go in contiguous
blocks as even as they go.  So StarCoder2-3B (24 heads over 2 KV heads)
serves at N 4 and 8, Qwen2-7B (28 over 4) and Whisper-large-v3 (20 MHA
heads) at N 8, on every world a multiple of N:

    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.serve \
        --arch qwen2-7b --model-parallel 8 --dist-backend gloo \
        --batch 8 --prompt-len 200 --gen 64

A rank caches the KV heads it reads (1/KV of the whole cache where a KV
head is replicated), where JAX's ``cache_pspecs`` splits the cache's
head_dim (1/N): a divergence of memory only (ROADMAP.md queue A).

Layouts with no explicit form here are refused, naming ROADMAP.md queue
A item 7 (``tp_refusal``): a rank's heads that would straddle two KV
heads' groups (neither N nor the KV heads divide the other, G > 1) or a
rank with no head, SSM heads that do not divide over N, SSM groups that
do not, any other leaf whose split dimension does not divide over its
axes (d_ff, the padded vocabulary, an expert count, a ``'dp'``
dimension over the data rows); only an odd model axis (N 3 or 6) meets
them among the ported configs.  JAX's launchers cannot place these
layouts either: both place each leaf with ``jax.device_put(p,
NamedSharding(mesh, spec))`` (``repro/launch/serve.py``,
``repro/launch/train.py``), which refuses a dimension that does not
divide over its axes, and ``to_mesh_specs`` falls back only for
``'ep'``.  Every layout where JAX's ``param_pspecs`` splits every leaf
evenly serves here (``tests/test_torch_dryrun_layouts.py``); the port
also serves some that JAX cannot place (StarCoder2-3B at N 6 and 12).  A world that is no multiple of N is
refused too, and the conv family on any world (JAX's ``serve_conv``
builds no mesh).  A failed collective, build or launch raises on its
rank and the run exits non-zero.

Conv family (AtacWorks): a continuous-serving loop over the streaming
conv1d: a request queue, per-stream positions, and padded-batch
compaction so ragged streams share one ``(B, chunk)`` step, with each
layer's state carried in a ring buffer instead of re-running the stack's
receptive field (10 000 columns for the paper's config) on every chunk:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch atacworks \
        --streams 8 --batch 4 --chunk 4096 --prompt-len 4096

Streaming is causal-only: ``--conv-padding same`` exits with an error.

``--device cpu`` runs the plain PyTorch version on the CPU (with
``--smoke`` for the reduced config); without a GPU and without that flag
it raises.  ``--telemetry PATH`` writes a telemetry log
(``repro_torch.obs``): a ``serve.conv.chunk`` span per stream step and a
``serve.conv.prefill`` span per admitted history, or a
``serve.decode_step`` span per decode step and one ``serve.prefill``
span, with the conv passes' spans; ``python -m repro_torch.obs.report
PATH --check-serving`` reads it.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, obs
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import mesh
from repro_torch.launch.device import rank_device, require_device
from repro_torch.models import (init_model, leaf_shapes, local_model, moe,
                                 sharding)
from repro_torch.models.whisper import fill_cross_cache
from repro_torch.train.serve_step import (make_cache, make_conv_prefill_step,
                                          make_conv_stream_state,
                                          make_conv_stream_step,
                                          make_prefill_step, make_serve_step,
                                          with_request_spans)

# The fused prefill's last logits against the sequential decode's at the
# same position: max|prefill - decode| <= tol * max|decode| over the real
# vocabulary.  fp32: the chunked SSD or the attention over the whole
# prompt against the recurrence or the cache, the same products summed in
# another order (about 1e-6 of the largest logit at 2 layers): 1e-4.
# bf16: the logits are bf16 products, so two paths whose sums differ in
# the last bits may round a logit one bf16 ulp apart (2^-7 of the
# largest); before that each layer rounds its outputs to bf16 (2^-9
# relative) on values that differ between the paths, and the residual
# stream carries those roundings to the logits: one 2^-9 of the largest
# logit a layer on top.
PREFILL_TOL_F32 = 1e-4
PREFILL_TOL_BF16_ULP, PREFILL_TOL_BF16_PER_LAYER = 2.0 ** -7, 2.0 ** -9


def prefill_tol(cfg, dtype: torch.dtype) -> float:
    """The prefill-against-decode tolerance of a model of ``dtype``."""
    if dtype == torch.float32:
        return PREFILL_TOL_F32
    return PREFILL_TOL_BF16_ULP + cfg.n_layers * PREFILL_TOL_BF16_PER_LAYER


def _leaves(state: dict):
    """The per-layer buffers of a stream-state tree, in layer order."""
    yield state["stem"]
    for blk in state["res"]:
        yield blk["conv1"]
        yield blk["conv2"]
    yield state["head_signal"]
    yield state["head_peak"]


class StreamRequest:
    """One conv stream: ``track`` is the live input (1D float array) whose
    denoised outputs the client wants as they arrive; ``history`` is an
    optional already-observed prefix to prefill state from (its outputs are
    not re-served).  Results accumulate in ``signal``/``peak``."""

    def __init__(self, rid: int, track, history=None):
        self.id = rid
        self.track = np.asarray(track, np.float32)
        self.history = (None if history is None
                        else np.asarray(history, np.float32))
        self.pos = 0  # next un-served track sample
        self.signal: list[np.ndarray] = []
        self.peak: list[np.ndarray] = []

    @property
    def done(self) -> bool:
        return self.pos >= len(self.track)

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.concatenate(self.signal) if self.signal else np.zeros(0),
                np.concatenate(self.peak) if self.peak else np.zeros(0))


class ConvStreamServer:
    """Batched continuous streaming server for the conv family.

    ``batch`` slots share one ``(B, chunk)`` stream step.  Requests queue
    until a slot frees.  Admission zeroes the slot's ring buffers in place
    (zeros = a fresh causal stream) and, when the request carries history,
    prefills them with one full-sequence pass and copies the result into
    the slot (the JAX server does both with ``.at[i].set`` on donated
    state; here the state tensors are updated in place).  Histories are
    LEFT-padded with zeros to ``prompt_len``, so every prefill has one
    shape; leading zeros are inert, being the causal padding.  The last
    short chunk of a stream rides zero-padded in the shared batch and
    only its ``valid`` columns are served back.  Idle slots stream zeros.
    The stream dtype is the model's; on a CUDA device every layer runs the
    kernel.
    """

    def __init__(self, model, cfg, *, batch: int, chunk: int,
                 prompt_len: int = 0, device: torch.device | str = "cuda"):
        self.device = require_device(device)
        p = next(model.parameters())
        if p.device != self.device:
            raise ValueError(f"model is on {p.device}, server on "
                             f"{self.device}; move the model first")
        self.model, self.cfg = model, cfg
        self.batch, self.chunk, self.prompt_len = batch, chunk, prompt_len
        self.dtype = p.dtype
        with torch.inference_mode():
            self.state = make_conv_stream_state(cfg, batch, self.dtype,
                                                self.device)
        self.slots: list[StreamRequest | None] = [None] * batch
        self.queue: deque[StreamRequest] = deque()
        self.chunk_times: list[float] = []
        self.chunks_run = 0
        self._step = with_request_spans(
            make_conv_stream_step(cfg), "serve.conv.chunk",
            device=self.device, arch=cfg.name, batch=batch, chunk=chunk)
        self._prefill = with_request_spans(
            make_conv_prefill_step(cfg), "serve.conv.prefill",
            device=self.device, arch=cfg.name, batch=1,
            prompt_len=prompt_len)

    def submit(self, req: StreamRequest) -> None:
        self.queue.append(req)

    def context(self, req: StreamRequest) -> np.ndarray | None:
        """The history exactly as admission prefills it, or None: its last
        ``prompt_len`` samples, left-padded with zeros to ``prompt_len`` so
        every prefill has one shape.  The zeros are the causal padding only
        while the biases are zero; with non-zero biases they reach the
        outputs, so the one-shot reference of a stream is taken over this
        context, not over the raw history."""
        if req.history is None or not self.prompt_len:
            return None
        hist = req.history[-self.prompt_len:]
        return np.pad(hist, (self.prompt_len - len(hist), 0))

    def _reset_slot(self, i: int) -> None:
        for buf in _leaves(self.state):
            buf[i].zero_()

    @torch.inference_mode()
    def _admit(self) -> None:
        for i in range(self.batch):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self._reset_slot(i)
            hist = self.context(req)
            if hist is not None:
                _, pstate = self._prefill(
                    self.model,
                    torch.from_numpy(hist)[None].to(self.device, self.dtype))
                for buf, pbuf in zip(_leaves(self.state), _leaves(pstate)):
                    buf[i].copy_(pbuf[0])
            self.slots[i] = req

    def step(self) -> int:
        """Admit waiting requests, run one padded-batch chunk step, hand
        the valid outputs back per stream, retire finished streams.
        Returns the number of streams served this step."""
        self._admit()
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        batch_np = np.zeros((self.batch, self.chunk), np.float32)
        valid = np.zeros(self.batch, np.int64)
        for i, req in active:
            part = req.track[req.pos:req.pos + self.chunk]
            batch_np[i, :len(part)] = part
            valid[i] = len(part)
        t0 = time.perf_counter()
        chunk = torch.from_numpy(batch_np).to(self.device, self.dtype)
        (signal, peak), self.state = self._step(self.model, self.state, chunk)
        signal, peak = signal.cpu().numpy(), peak.cpu().numpy()
        self.chunk_times.append(time.perf_counter() - t0)
        self.chunks_run += 1
        for i, req in active:
            n = int(valid[i])
            req.signal.append(signal[i, :n])
            req.peak.append(peak[i, :n])
            req.pos += n
            if req.done:
                self.slots[i] = None
        return len(active)

    def run(self) -> list[StreamRequest]:
        """Drain the queue: loop ``step`` until every stream completes;
        returns the finished requests in submission order."""
        seen = list(self.queue) + [r for r in self.slots if r is not None]
        while any(self.slots) or self.queue:
            self.step()
        return [r for r in seen if r.done]


def one_shot(model, cfg, track: np.ndarray,
             history: np.ndarray | None = None, *,
             backend: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The one-shot causal forward's (signal, peak) over
    ``[history | track]``, cut to the track's columns: what streaming
    ``track`` after ``history`` (``ConvStreamServer.context``) must
    serve."""
    full = np.concatenate([history, track]) if history is not None else track
    p = next(model.parameters())
    with torch.inference_mode():
        out = blocks.forward(
            model, cfg, torch.from_numpy(full)[None].to(p.device, p.dtype),
            backend=backend, padding="CAUSAL")
    return tuple(o[0, len(full) - len(track):].cpu().numpy() for o in out)


def serve_conv(args, cfg) -> int:
    """The conv-family continuous-serving path."""
    if args.conv_padding != "causal":
        raise SystemExit(
            f"conv serving: padding {args.conv_padding!r} has no streaming "
            "form — SAME needs future context at every output position. "
            "Serve full sequences one-shot via blocks.forward, or use "
            "--conv-padding causal")
    device = require_device(args.device)
    model = blocks.init_params(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    server = ConvStreamServer(model, cfg, batch=args.batch, chunk=args.chunk,
                              prompt_len=args.prompt_len, device=device)
    # synthetic live streams with ragged lengths (padded-batch compaction
    # is exercised by construction) and optional prefill history
    for rid in range(args.streams):
        n = args.track_len + int(rng.integers(0, max(args.chunk, 2)))
        track = rng.normal(size=n).astype(np.float32)
        hist = (rng.normal(size=args.prompt_len).astype(np.float32)
                if args.prompt_len else None)
        server.submit(StreamRequest(rid, track, history=hist))

    t0 = time.perf_counter()
    done = server.run()
    wall = time.perf_counter() - t0
    times = np.asarray(server.chunk_times[1:] or server.chunk_times)
    served = sum(len(r.track) for r in done)
    print(f"served {len(done)} streams ({served} samples) on {device} in "
          f"{wall:.2f}s: chunk p50 {np.median(times) * 1e3:.2f} ms, "
          f"p99 {np.percentile(times, 99) * 1e3:.2f} ms, "
          f"{len(done) / wall:.2f} streams/s, {served / wall:.0f} samples/s")

    if args.smoke:
        # stream 0's chunked outputs against the one-shot causal forward:
        # bitwise through the CUDA kernel (its summation order does not
        # depend on the width); within fp32 tolerance on the CPU, whose
        # einsum may block differently by width
        got = np.stack(done[0].result())
        want = np.stack(one_shot(model, cfg, done[0].track,
                                 server.context(done[0])))
        if device.type == "cuda":
            if not np.array_equal(got, want):
                raise AssertionError(
                    "streaming serve diverged from the one-shot causal "
                    f"forward (maxdiff {np.abs(got - want).max()})")
            print("smoke: stream 0 == one-shot causal forward (bitwise)")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            print("smoke: stream 0 == one-shot causal forward (fp32 tol)")
    return 0


def lm_cache_dtype(cfg) -> torch.dtype:
    """The decode cache's dtype: fp32 for the SSM family and for fp32
    configs (the JAX launcher's), the model's dtype otherwise (the only
    one the JAX package runs for a bf16 dense, encoder-decoder or hybrid
    model; a hybrid's K/V take it, its Mamba2 states stay fp32)."""
    if cfg.family == "ssm" or cfg.dtype == "float32":
        return torch.float32
    return getattr(torch, cfg.dtype)


def prefill_gap(model, cfg, prompt: torch.Tensor,
                decode_logits: torch.Tensor,
                frames: torch.Tensor | None = None,
                routing: moe.RoutingLog | None = None) -> dict:
    """The fused prefill step on ``prompt`` (an encoder-decoder's with the
    ``frames`` its cross K/V came from) against the sequential decode's
    logits at its last position: ``gap`` = max|prefill - decode| over
    max|decode| (the real vocabulary), ``tol`` = ``prefill_tol``, and
    ``tokens_equal``: whether the greedy tokens agree in every row whose
    top-2 margin exceeds twice the tolerance (each path may move a logit
    by the tolerance, so a smaller margin may flip), counted in
    ``rows_with_clear_margin``.

    With ``routing``, the decode's expert selection over the prompt (an
    MoE model), the prefill runs twice: with its own selection, whose
    gap is ``free_gap`` and whose selection against the decode's is
    ``moe.compare_routing``'s ``routing`` (flips per layer, smallest
    margin, largest score difference); then with the decode's selection
    replayed, whose gap is ``gap``."""
    batch = {"tokens": prompt}
    if frames is not None:
        batch["frames"] = frames
    step = make_prefill_step(cfg)
    out = {}
    if routing is not None:
        free = moe.RoutingLog()
        try:
            model.routing = free
            _, free_logits = step(model, batch)
            model.routing = moe.RoutingLog(replay=routing)
            _, logits = step(model, batch)
        finally:
            model.routing = None
        out["routing"] = moe.compare_routing(routing, free)
    else:
        _, logits = step(model, batch)
    V = cfg.vocab_size  # the padded columns are NEG_INF on both sides
    want = decode_logits[:, -1, :V].float()
    scale = want.abs().max()
    if routing is not None:
        out["free_gap"] = ((free_logits[:, -1, :V].float() - want).abs()
                           .max() / scale).item()
    got = logits[:, -1, :V].float()
    rel = prefill_tol(cfg, next(model.parameters()).dtype)
    tol = rel * scale
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    return {"gap": ((got - want).abs().max() / scale).item(),
            "tol": rel,
            "tokens_equal": bool((same | ~clear).all()),
            "rows_with_clear_margin": int(clear.sum()), **out}


# the refused layouts' message ends here
TP_ITEM = "ROADMAP.md queue A item 7"


def tp_refusal(cfg, mp: int, world: int | None = None) -> str | None:
    """Why ``cfg`` cannot serve over ``mp`` model ranks of a world of
    ``world`` ranks (None: the model axis alone) laid out as JAX's serve
    launcher's ``(world / mp, mp)`` host mesh here, or None: the layouts
    with no explicit form (the module docstring)."""
    if cfg.family == "conv":
        return ("the conv family serves by streaming, on one process: the "
                "JAX package's serve_conv builds no mesh (its model axis is "
                "training's, launch/train.py)")
    if world is not None and world % mp:
        return (f"a world of {world} ranks for --model-parallel {mp}: "
                + (f"the model axis needs {mp} ranks" if world < mp else
                   f"the (world / mp, mp) mesh needs a multiple of {mp} "
                   "ranks"))
    dp = 1 if world is None else world // mp
    if cfg.n_heads:
        try:  # whole heads of one group a rank
            sharding.head_blocks(cfg, mp)
        except ValueError as e:
            return f"{e} (no explicit form here: {TP_ITEM})"
    if cfg.padded_vocab % mp:
        return (f"the padded vocabulary of {cfg.padded_vocab} does not "
                f"divide over {mp} model ranks ({TP_ITEM})")
    if cfg.ssm is not None:
        try:
            sharding.ssm_segments(cfg, "in_proj", mp)
        except ValueError as e:
            return f"{e} (no explicit form here: {TP_ITEM})"
    mesh_shape = sharding.MeshShape(("data", "model"), (dp, mp))
    shapes = leaf_shapes(cfg)
    for key, spec in sharding.param_pspecs(shapes, mesh_shape).items():
        if cfg.ssm is not None and key.split(".")[-1] in (
                sharding.SSM_SEGMENTS):
            # segment-aligned on 'model' (checked above); the rest even
            spec = (*spec[:-1], None)
        elif sharding.leaf_heads(cfg, key):
            # head-aligned on 'model' (checked above); the rest even
            spec = tuple(None if e == "model" else e for e in spec)
        try:
            sharding.local_shape(shapes[key], spec, mesh_shape)
        except ValueError as e:
            return (f"{key}: {e} (JAX's launchers cannot place it either: "
                    f"device_put needs even shards; {TP_ITEM})")
    if dp > 1:
        try:
            sharding.fsdp_dims(shapes, mesh_shape)
        except ValueError as e:
            return f"{e} ({TP_ITEM})"
    return None


def distributed(args) -> bool:
    """Whether the launcher serves over a world of ranks:
    ``--model-parallel`` above 1, or a world of more than one rank, from
    torchrun's variables or already started (``--model-parallel 1``
    there is the ``(world, 1)`` mesh)."""
    return (args.model_parallel != 1
            or int(os.environ.get("WORLD_SIZE", "1")) > 1
            or (dist.is_initialized() and dist.get_world_size() > 1))


def _tp_start(args, cfg):
    """Start (or join) the world from torchrun's variables and lay it out
    as JAX's serve launcher's ``(world / mp, mp)`` host mesh: ``(mesh
    shape, coordinates, data group, model group, device)``."""
    mp = args.model_parallel
    why = tp_refusal(cfg, mp)
    if why:
        raise ValueError(why)
    backend = args.dist_backend or ("gloo" if args.device == "cpu" else None)
    mesh.init_data_group(backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    why = tp_refusal(cfg, mp, world)
    if why:
        raise ValueError(why)
    data_group, model_group = mesh.init_mesh(world // mp, mp)
    mesh_shape, coords = mesh.make_host_mesh(model=mp)
    return (mesh_shape, coords, data_group, model_group,
            rank_device(args.device))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def serve_lm(args, cfg, model=None, routing: moe.RoutingLog | None = None
             ) -> dict:
    """The language models' serving path: sequential prefill of a seeded
    prompt through the serve step, then greedy generation.  ``model``
    (on ``args.device``) is served when given, else one is built from
    ``args.seed``.  Returns the run's numbers: ``prefill_s``, ``step_s``,
    ``step_p50_ms`` / ``step_p99_ms`` (host clock around one decode step,
    its next tokens copied to the host as a server sends them),
    ``tokens_per_s`` (batch x decode steps over their time), ``tokens``
    (B, gen), ``prompt`` and ``prompt_logits`` (the decode's logits at the
    prompt's last position), the cache's dtype; an encoder-decoder's also
    ``frames`` and ``encode_s``, the time to encode them and fill the
    cross K/V (host clock to a synchronize); under ``args.smoke`` a VLM's
    also ``patches`` (``vlm_batch``'s image embeddings from
    ``args.seed``) and ``image_logits``, the last logits of the fused
    prefill of the prompt behind them.

    With ``args.model_parallel`` N > 1, or under torchrun with a world
    of more than one rank (``distributed``), the world is started (or
    joined) from torchrun's variables and laid out as JAX's serve
    launcher's ``(world / N, N)`` host mesh; ``model`` (the whole model,
    anywhere; else one drawn on the host from ``args.seed``) gives this
    rank its 2-D blocks (``models.local_model``: on a data axis of more
    than one rank each layer's column block is gathered over the data
    group where the layer runs, and no gathered weight outlives its
    layer).  Where the batch divides over the data rows, data row d
    serves prompt rows ``[d B/dp, (d+1) B/dp)`` and its cache holds only
    those (JAX's ``cache_pspecs``); otherwise every data row serves the
    whole batch.  ``tokens``, ``prompt``, ``prompt_logits`` and a VLM's
    ``patches`` and ``image_logits`` are gathered over the data group,
    the whole batch's as in one process, and ``tokens_per_s`` is the
    whole batch's (its tokens over the slowest data row's decode time);
    ``row_tokens_per_s`` is the data row's own.  Every rank returns its
    numbers, which add ``model_parallel``, ``data_parallel``,
    ``coords``, ``rows`` (the data row's prompt rows), ``weights_bytes``,
    ``cache_bytes`` (the rank's), ``peak_bytes`` (the card's peak
    allocation on the rank's device over the run, None on the CPU),
    ``collectives`` (a decode step's model-group ``sums`` and
    ``gathers``, data-group ``data_gathers``, and their host
    ``seconds`` and ``data_seconds``) and ``draw_s`` (the host draw and
    the blocks' move to the device).  Rank 0 alone prints.  ``routing``:
    a ``moe.RoutingLog`` the decode records into, replaying its
    ``replay`` when it has one (an MoE model; under ``--smoke`` one is
    made)."""
    if args.prompt_len < 1 or args.gen < 2:
        raise ValueError("--prompt-len must be >= 1 and --gen >= 2 (the "
                         "first generated token comes from the prefill)")
    mp, dp = args.model_parallel, 1
    rows, extra, data_group = slice(0, args.batch), {}, None
    if not distributed(args):
        device = require_device(args.device)
        if model is None:
            model = init_model(cfg, seed=args.seed, device=device)
    else:
        (mesh_shape, coords, data_group, model_group,
         device) = _tp_start(args, cfg)
        dp = mesh_shape.shape["data"]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        if model is None:
            model = init_model(cfg, seed=args.seed, device="cpu")
        model = local_model(model, mesh_shape, coords, model_group,
                            device=device, data_group=data_group,
                            batch=args.batch)
        rows = sharding.batch_rows(args.batch, dp, coords["data"])
        extra.update(draw_s=time.perf_counter() - t0, model_parallel=mp,
                     data_parallel=dp, coords=coords,
                     rows=(rows.start, rows.stop))
    say = print if dp * mp == 1 or coords == {"data": 0, "model": 0} else (
        lambda *a, **k: None)
    batch = rows.stop - rows.start  # this data row's
    max_len = args.prompt_len + args.gen
    cache_dtype = lm_cache_dtype(cfg)
    cache = make_cache(cfg, args.batch, max_len, dtype=cache_dtype,
                       device=device, mp=mp, dp=dp,
                       rank=coords["model"] if dp * mp != 1 else 0)
    if dp * mp != 1:
        extra.update(weights_bytes=_nbytes(model.parameters()),
                     cache_bytes=_nbytes(sharding.tree_leaves(cache)))
    frames, encode_s = None, None
    if cfg.family == "encdec":
        frames = make_batch(cfg, args.batch, args.prompt_len,
                            seed=args.seed)["frames"][rows].to(device)
        t0 = time.perf_counter()
        fill_cross_cache(model, cache, frames)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        encode_s = time.perf_counter() - t0
        say(f"encode {tuple(frames.shape)} frames and fill the "
            f"cross-attention cache: {encode_s:.3f} s", flush=True)
    serve = with_request_spans(make_serve_step(cfg), "serve.decode_step",
                               device=device, arch=cfg.name,
                               batch=args.batch)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    )[rows].to(device)

    # prefill: sequential teacher-forced decode steps (cache-correct by
    # construction); under --smoke an MoE model records its selection
    # over the prompt for the fused prefill's check; a caller's log
    # records (or replays) the whole decode
    whole = routing
    if routing is None and args.smoke and cfg.family == "moe":
        routing = moe.RoutingLog()
    t0 = time.perf_counter()
    with obs.span("serve.prefill", arch=cfg.name, batch=args.batch,
                  prompt_len=args.prompt_len):
        try:
            if routing is not None:
                model.routing = routing
            for t in range(args.prompt_len):
                nxt, cache, logits = serve(model, cache, prompt[:, t:t + 1],
                                           t)
        finally:
            if routing is not None:
                model.routing = None
        out = [nxt.cpu()]
    prompt_logits = logits
    finite = torch.isfinite(logits).all()
    prefill_s = time.perf_counter() - t0
    say(f"prefill {args.prompt_len} tokens x {args.batch} on {device} "
        f"(sequential decode steps, {cache_dtype} cache): "
        f"{prefill_s:.3f} s", flush=True)

    times = []
    tp, ds = model.tp, model.ds
    before = [g.counts() for g in (tp, ds) if g is not None]
    try:
        model.routing = whole
        for t in range(args.prompt_len, max_len - 1):
            t0 = time.perf_counter()
            nxt, cache, logits = serve(model, cache, nxt, t)
            out.append(nxt.cpu())
            times.append(time.perf_counter() - t0)
            finite &= torch.isfinite(logits).all()
    finally:
        model.routing = None
    if dp * mp != 1:
        c = {"sums": 0, "gathers": 0, "seconds": 0.0, "data_gathers": 0,
             "data_seconds": 0.0}
        if tp is not None:
            after = tp.counts()
            c.update({k: (after[k] - before[0][k]) / len(times)
                      for k in after})
        if ds is not None:
            after = ds.counts()
            c.update(data_gathers=(after["gathers"] - before[-1]["gathers"])
                     / len(times), data_seconds=(
                         after["seconds"] - before[-1]["seconds"])
                     / len(times))
        extra["collectives"] = c
    if not bool(finite):
        raise AssertionError("non-finite logits")
    tokens = torch.cat(out, dim=1)
    st = np.asarray(times)
    decode_s = float(st.sum())
    if dp * mp != 1:
        extra["row_tokens_per_s"] = batch * len(times) / decode_s
    row_prompt, row_logits = prompt, prompt_logits
    if batch != args.batch:  # the data rows' shares, in row order
        tokens = _gather_rows(tokens.to(device), data_group).cpu()
        prompt = _gather_rows(prompt, data_group)
        prompt_logits = _gather_rows(prompt_logits, data_group)
        slowest = torch.tensor([decode_s], dtype=torch.float64,
                               device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=data_group)
        decode_s = float(slowest)
    tokens = tokens.numpy()
    stats = dict(device=str(device), cache_dtype=str(cache_dtype),
                 batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                 prefill_s=prefill_s, steps=len(times), step_s=times,
                 step_p50_ms=float(np.median(st)) * 1e3,
                 step_p99_ms=float(np.percentile(st, 99)) * 1e3,
                 tokens_per_s=args.batch * len(times) / decode_s,
                 tokens=tokens, prompt=prompt, prompt_logits=prompt_logits,
                 **extra)
    if frames is not None:
        stats.update(frames=frames, encode_s=encode_s)
    if routing is not None:
        stats["routing"] = routing
    say(f"generated {tokens.shape} tokens, logits finite: step p50 "
        f"{stats['step_p50_ms']:.3f} ms, p99 {stats['step_p99_ms']:.3f} ms,"
        f" {stats['tokens_per_s']:.1f} tokens/s"
        + (f" ({extra['row_tokens_per_s']:.1f} a data row)" if dp > 1
           else ""), flush=True)
    if dp * mp != 1:
        c = extra["collectives"]
        say(f"model-parallel {mp}, mesh (data {dp}, model {mp}): a rank "
            f"holds {extra['weights_bytes']:,} bytes of weights and "
            f"{extra['cache_bytes']:,} of cache for rows "
            f"{rows.start}:{rows.stop}; a decode step runs "
            f"{c['data_gathers']:.0f} gathers over the data group "
            f"({c['data_seconds'] * 1e3:.3f} ms of host time) and "
            f"{c['sums']:.0f} sums and {c['gathers']:.0f} gathers over the "
            f"model group ({c['seconds'] * 1e3:.3f} ms)", flush=True)
    say("sample:", tokens[0, :16])
    if args.smoke:
        # each data row holds its fused prefill to its own rows' decode
        gap = prefill_gap(model, cfg, row_prompt, row_logits, frames,
                          routing=routing)
        if gap["gap"] > gap["tol"] or not gap["tokens_equal"]:
            raise AssertionError(f"the fused prefill diverged from the "
                                 f"sequential decode: {gap}")
        stats["prefill_gap"] = gap
        say(f"smoke: fused prefill == sequential decode at position "
            f"{args.prompt_len - 1} (max diff {gap['gap']:.2e} of the "
            f"largest logit, tol {gap['tol']:.2e}"
            + (", the decode's expert selection replayed" if routing
               else "") + ")")
        if routing is not None:
            r = gap["routing"]
            say(f"smoke: the prefill's own selection flips {r['flips']} "
                f"(layer: tokens; smallest margin {r['min_margin']:.3e}, "
                f"largest score difference {r['max_score_diff']:.3e}), "
                f"max diff {gap['free_gap']:.2e}")
        if cfg.family == "vlm":
            image = image_prefill(model, cfg, row_prompt, args.seed,
                                  say=say, rows=rows, batch=args.batch)
            if batch != args.batch:
                image = {k: _gather_rows(v, data_group)
                         for k, v in image.items()}
            stats.update(image)
    if device.type == "cuda" and dp * mp != 1:
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    elif dp * mp != 1:
        stats["peak_bytes"] = None
    return stats


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every data row's ``t`` (its rows of the batch, equal shares)
    joined along the first dimension in data-rank order: the whole
    batch's, on every rank."""
    t = t.contiguous()
    buf = t.new_empty((dist.get_world_size(group) * t.shape[0],
                       *t.shape[1:]))
    dist.all_gather_into_tensor(buf, t, group=group)
    return buf


def image_prefill(model, cfg, prompt: torch.Tensor, seed: int,
                  say=print, rows: slice | None = None,
                  batch: int | None = None) -> dict:
    """A VLM's fused prefill of ``prompt`` behind ``cfg.n_image_tokens``
    image embeddings drawn by ``vlm_batch`` from ``seed``: ``patches``
    and ``image_logits`` (B, 1, padded_vocab), checked finite.  On a data
    row, ``prompt`` is its ``rows`` of a ``batch`` whose patches are
    drawn whole, and the row's are taken."""
    B, T = prompt.shape
    patches = make_batch(cfg, batch or B, cfg.n_image_tokens + T,
                         seed=seed)["patches"]
    patches = patches[rows if rows is not None else slice(None)].to(
        prompt.device)
    _, logits = make_prefill_step(cfg)(model, {"tokens": prompt,
                                               "patches": patches})
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits after the image prefix")
    say(f"smoke: fused prefill of {tuple(patches.shape)} image embeddings "
        f"and {T} tokens: logits finite")
    return {"patches": patches, "image_logits": logits}


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags (``serve_lm`` and ``serve_conv`` read them)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (conv: C=8, S=9, and a check of "
                         "stream 0 against the one-shot forward; ssm, dense, "
                         "moe, vlm and encdec: 2 layers, hybrid 4, d_model "
                         "64, and a check of the fused prefill against the "
                         "sequential decode; vlm: and a fused prefill "
                         "behind its image embeddings)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="LM: prompt tokens; conv: history samples")
    ap.add_argument("--gen", type=int, default=16,
                    help="LM: tokens generated per sequence")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="LM: the model axis of the (world / N, N) mesh of "
                         "the ranks started by torchrun (tensor-parallel "
                         "over N, the parameters FSDP-placed on the data "
                         "axis, the batch split over the data rows)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="on a world of more than one rank: the backend "
                         "(default nccl on the card, gloo on the CPU; gloo "
                         "lets the ranks share one card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", type=int, default=8,
                    help="number of queued streaming requests")
    ap.add_argument("--chunk", type=int, default=128,
                    help="samples per streaming step")
    ap.add_argument("--track-len", type=int, default=512,
                    help="base stream length (lengths are ragged above "
                         "this to exercise padded-batch compaction)")
    ap.add_argument("--conv-padding", default="causal",
                    choices=["causal", "same"],
                    help="only 'causal' can stream; 'same' exits with an "
                         "error (needs future context)")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write a telemetry JSONL log to PATH (as "
                         "REPRO_TORCH_TELEMETRY=1 with "
                         "REPRO_TORCH_TELEMETRY_PATH)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.telemetry:
        obs.enable(args.telemetry)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if cfg.family == "conv" and distributed(args):
        raise ValueError(tp_refusal(cfg, args.model_parallel))
    try:
        if cfg.family == "conv":
            return serve_conv(args, cfg)
        serve_lm(args, cfg)
        return 0
    finally:
        obs.flush()  # the spans of passes outside a request span
        if distributed(args):
            mesh.destroy()


if __name__ == "__main__":
    raise SystemExit(main())
