"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``):
batched greedy decode for the language models, batched continuous
streaming for the conv family.  It runs on the card by default.

Language models (the SSM family, Mamba2, the dense transformers, the
MoE family, Moonlight, the encoder-decoder, Whisper, and the hybrid,
Zamba2): build the cache of
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

Its ``--smoke`` check holds the fused prefill to the decode with the
decode's expert selection replayed (``moe.RoutingLog``): routing is
discontinuous, and where a token's k-th and (k+1)-th selection scores lie
closer than the two paths' rounding the prefill would pick another
expert, a jump no tolerance of rounding covers.  The prefill's own
selection is compared too: its flips per layer, the smallest selection
margin and the largest score difference are reported.

The cache is fp32 where the JAX launcher runs one (the SSM family, and
fp32 configs) and in the model's dtype for a bf16 dense, encoder-decoder
or hybrid model: with an fp32 KV cache the JAX package's bf16 attention
output turns fp32 and its layer scan (or, for the hybrid, its ``cond``)
refuses the carry (ROADMAP.md queue C), so the model's dtype
(``make_cache``'s default) is the one it can run.  A hybrid's Mamba2
states are fp32 whatever the cache's dtype, as in JAX.  The decode step runs
no kernel (as in the JAX package, where XLA takes it); ``--model-parallel``
above 1, which in the JAX launcher shards the language models'
parameters (``models/sharding.py``), waits for that sharding (ROADMAP.md
queue A item 4).

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
import time
from collections import deque

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.device import require_device
from repro_torch.models import init_model, moe
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


def serve_lm(args, cfg, model=None) -> dict:
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
    cross K/V (host clock to a synchronize)."""
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 is not ported to repro_torch yet: in the "
            "JAX launcher it shards the language models' parameters "
            "(models/sharding.py), which waits in ROADMAP.md queue A item 4")
    if args.prompt_len < 1 or args.gen < 2:
        raise ValueError("--prompt-len must be >= 1 and --gen >= 2 (the "
                         "first generated token comes from the prefill)")
    device = require_device(args.device)
    if model is None:
        model = init_model(cfg, seed=args.seed, device=device)
    max_len = args.prompt_len + args.gen
    cache_dtype = lm_cache_dtype(cfg)
    cache = make_cache(cfg, args.batch, max_len, dtype=cache_dtype,
                       device=device)
    frames, encode_s = None, None
    if cfg.family == "encdec":
        frames = make_batch(cfg, args.batch, args.prompt_len,
                            seed=args.seed)["frames"].to(device)
        t0 = time.perf_counter()
        fill_cross_cache(model, cache, frames)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        encode_s = time.perf_counter() - t0
        print(f"encode {tuple(frames.shape)} frames and fill the "
              f"cross-attention cache: {encode_s:.3f} s", flush=True)
    serve = with_request_spans(make_serve_step(cfg), "serve.decode_step",
                               device=device, arch=cfg.name,
                               batch=args.batch)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)

    # prefill: sequential teacher-forced decode steps (cache-correct by
    # construction); under --smoke an MoE model records its selection
    # for the fused prefill's check
    routing = (moe.RoutingLog() if args.smoke and cfg.family == "moe"
               else None)
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
    print(f"prefill {args.prompt_len} tokens x {args.batch} on {device} "
          f"(sequential decode steps, {cache_dtype} cache): "
          f"{prefill_s:.3f} s", flush=True)

    times = []
    for t in range(args.prompt_len, max_len - 1):
        t0 = time.perf_counter()
        nxt, cache, logits = serve(model, cache, nxt, t)
        out.append(nxt.cpu())
        times.append(time.perf_counter() - t0)
        finite &= torch.isfinite(logits).all()
    if not bool(finite):
        raise AssertionError("non-finite logits")
    tokens = torch.cat(out, dim=1).numpy()
    st = np.asarray(times)
    stats = dict(device=str(device), cache_dtype=str(cache_dtype),
                 batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                 prefill_s=prefill_s, steps=len(times), step_s=times,
                 step_p50_ms=float(np.median(st)) * 1e3,
                 step_p99_ms=float(np.percentile(st, 99)) * 1e3,
                 tokens_per_s=args.batch * len(times) / float(st.sum()),
                 tokens=tokens, prompt=prompt, prompt_logits=prompt_logits)
    if frames is not None:
        stats.update(frames=frames, encode_s=encode_s)
    print(f"generated {tokens.shape} tokens, logits finite: step p50 "
          f"{stats['step_p50_ms']:.3f} ms, p99 {stats['step_p99_ms']:.3f} ms,"
          f" {stats['tokens_per_s']:.1f} tokens/s", flush=True)
    print("sample:", tokens[0, :16])
    if args.smoke:
        gap = prefill_gap(model, cfg, prompt, prompt_logits, frames,
                          routing=routing)
        if gap["gap"] > gap["tol"] or not gap["tokens_equal"]:
            raise AssertionError(f"the fused prefill diverged from the "
                                 f"sequential decode: {gap}")
        print(f"smoke: fused prefill == sequential decode at position "
              f"{args.prompt_len - 1} (max diff {gap['gap']:.2e} of the "
              f"largest logit, tol {gap['tol']:.2e}"
              + (", the decode's expert selection replayed" if routing
                 else "") + ")")
        if routing is not None:
            r = gap["routing"]
            print(f"smoke: the prefill's own selection flips {r['flips']} "
                  f"(layer: tokens; smallest margin {r['min_margin']:.3e}, "
                  f"largest score difference {r['max_score_diff']:.3e}), "
                  f"max diff {gap['free_gap']:.2e}")
    return stats


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags (``serve_lm`` and ``serve_conv`` read them)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (conv: C=8, S=9, and a check of "
                         "stream 0 against the one-shot forward; ssm, dense, "
                         "moe and encdec: 2 layers, hybrid 4, d_model 64, "
                         "and a check of the fused prefill against the "
                         "sequential decode)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="LM: prompt tokens; conv: history samples")
    ap.add_argument("--gen", type=int, default=16,
                    help="LM: tokens generated per sequence")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="LM: only 1 (the language models' parameter "
                         "sharding waits in ROADMAP.md queue A item 4)")
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
    try:
        if cfg.family == "conv":
            return serve_conv(args, cfg)
        serve_lm(args, cfg)
        return 0
    finally:
        obs.flush()  # the spans of passes outside a request span


if __name__ == "__main__":
    raise SystemExit(main())
