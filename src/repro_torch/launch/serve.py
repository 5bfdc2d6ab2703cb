"""Serving launcher of the port: batched continuous streaming for the conv
family (counterpart of ``repro/launch/serve.py``).

A continuous-serving loop over the streaming conv1d: a request queue,
per-stream positions, and padded-batch compaction so ragged streams share
one ``(B, chunk)`` step, with each layer's state carried in a ring buffer
instead of re-running the stack's receptive field (10 000 columns for the
paper's config) on every chunk.  It runs on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch atacworks \
        --streams 8 --batch 4 --chunk 4096 --prompt-len 4096

``--device cpu`` runs the plain PyTorch version on the CPU (with
``--smoke`` for the reduced config); without a GPU and without that flag
it raises.  Streaming is causal-only: ``--conv-padding same`` exits with an
error.  Serving the LM families (Mamba2 included: its decode path runs no
kernel) is not ported yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time
from collections import deque

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.core import blocks
from repro_torch.launch.device import require_device
from repro_torch.train.serve_step import (make_conv_prefill_step,
                                          make_conv_stream_state,
                                          make_conv_stream_step)


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
        self._step = make_conv_stream_step(cfg)
        self._prefill = make_conv_prefill_step(cfg)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (C=8, S=9) and a check of stream "
                         "0 against the one-shot forward")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
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
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if cfg.family != "conv":
        raise NotImplementedError(
            f"serving the {cfg.family!r} family is not ported to repro_torch "
            "yet: only conv streaming is; Mamba2's decode path waits in "
            "ROADMAP.md queue A")
    if args.smoke:
        cfg = reduced(cfg)
    return serve_conv(args, cfg)


if __name__ == "__main__":
    raise SystemExit(main())
