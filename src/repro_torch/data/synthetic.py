"""Synthetic data of every family of the port (counterpart of
``repro/data/synthetic.py``).

The real ATAC-seq data behind the paper's end-to-end experiments is
access-controlled, so training runs on synthetic coverage tracks with
matched shape statistics: Poisson-like counts, sparse smoothed peaks,
50k-wide segments padded by 5k on both sides (paper §4.2).
``atacseq_batch``, ``lm_batch`` (uniform random tokens),
``vlm_batch`` (text tokens, then standard-normal image embeddings) and
``encdec_batch`` (tokens, then standard-normal frames) are the JAX
package's functions line for line, with the same numpy generator calls,
so one seed gives the same batch in both packages.  A batch's leaves are
numpy arrays, except the patches and the frames, tensors in the config's
dtype (numpy has no bfloat16).  ``SyntheticLoader`` makes batches on a
producer thread and moves them to the device while the step runs (token
batches keep JAX's int32).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

PREFETCH = 2  # batches the producer thread keeps ready ahead of the step


def atacseq_batch(rng: np.random.Generator, batch: int, width: int = 60_000,
                  pad: int = 5_000, peak_rate: float = 8e-5):
    """Returns {'noisy','clean','peaks'} float32/float32/int8 of (B, width).

    clean = sum of Gaussian bumps at sparse peak locations; noisy = Poisson
    subsample of clean (low-coverage simulation); peaks = binary labels.
    """
    pad = min(pad, width // 12)
    inner = width - 2 * pad
    x = np.zeros((batch, width), np.float32)
    peaks = np.zeros((batch, width), np.int8)
    t = np.arange(width, dtype=np.float32)
    for b in range(batch):
        n_peaks = max(1, rng.poisson(peak_rate * inner))
        centers = rng.integers(pad, width - pad, n_peaks)
        widths = rng.uniform(150, 600, n_peaks).astype(np.float32)
        heights = rng.uniform(2.0, 25.0, n_peaks).astype(np.float32)
        for c, wd, h in zip(centers, widths, heights):
            lo, hi = max(0, int(c - 4 * wd)), min(width, int(c + 4 * wd))
            x[b, lo:hi] += h * np.exp(-0.5 * ((t[lo:hi] - c) / wd) ** 2)
            peaks[b, max(0, int(c - wd)):min(width, int(c + wd))] = 1
    clean = x
    noisy = rng.poisson(np.maximum(clean * 0.15, 1e-3)).astype(np.float32)
    return {"noisy": noisy, "clean": clean, "peaks": peaks}


def lm_batch(rng: np.random.Generator, cfg, batch: int, seq: int) -> dict:
    """``{'tokens', 'labels'}`` int32 (B, seq): one draw of seq + 1 tokens
    per row, labels the tokens shifted by one."""
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int64)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def vlm_batch(rng: np.random.Generator, cfg, batch: int, seq: int) -> dict:
    """``seq`` is the TOTAL length, image positions included: the text's
    tokens and labels (B, seq - n_image_tokens) from one draw, then
    ``'patches'`` (B, n_image_tokens, d_model): standard-normal fp32
    draws cast to the config's dtype, as a tensor."""
    t_text = seq - cfg.n_image_tokens
    if t_text < 1:
        raise ValueError(
            f"seq {seq} leaves no text after the {cfg.n_image_tokens} image "
            f"positions of {cfg.name}: seq counts both, so it must exceed "
            f"{cfg.n_image_tokens}")
    toks = rng.integers(0, cfg.vocab_size, (batch, t_text + 1), dtype=np.int64)
    patches = rng.standard_normal(
        (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "patches": torch.from_numpy(patches).to(getattr(torch, cfg.dtype))}


def encdec_batch(rng: np.random.Generator, cfg, batch: int,
                 seq: int) -> dict:
    """``lm_batch``'s tokens and labels (B, seq) from one draw, then
    ``'frames'`` (B, encoder_width, d_model): standard-normal fp32 draws
    cast to the config's dtype, as a tensor."""
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int64)
    frames = rng.standard_normal(
        (batch, cfg.encoder_width, cfg.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "frames": torch.from_numpy(frames).to(getattr(torch, cfg.dtype))}


def make_batch(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    """One batch of the config's family from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.family == "conv":
        return atacseq_batch(rng, batch, width=seq)
    if cfg.family in ("ssm", "dense", "hybrid", "moe"):
        return lm_batch(rng, cfg, batch, seq)
    if cfg.family == "encdec":
        return encdec_batch(rng, cfg, batch, seq)
    if cfg.family == "vlm":
        return vlm_batch(rng, cfg, batch, seq)
    raise ValueError(f"unknown family {cfg.family!r}")


class SyntheticLoader:
    """Host-side data pipeline: a producer thread makes batches and moves
    them to ``device`` (dicts of tensors) while the step runs.

    Batches are keyed by STEP index, not production order: batch *i* of a
    loader started at ``start`` is seeded ``seed + start + i``, so a loader
    rebuilt at step *r* on resume replays exactly the batches steps
    ``r, r+1, ...`` saw the first time.  ``close`` stops the thread.  A
    batch the producer cannot make raises its error in ``__next__``.

    ``rank``/``world``: data parallelism.  ``batch`` stays the global
    batch; every rank draws the same global batch from the step's seed
    (the generator draws sample after sample, so a slice cannot be drawn
    alone) and moves its contiguous share, rows ``[rank * batch / world,
    (rank + 1) * batch / world)``, to its device.  The ranks' shares are
    then the single-process batch, split."""

    def __init__(self, cfg, batch: int, seq: int, *,
                 device: torch.device | str = "cpu", seed: int = 0,
                 start: int = 0, rank: int = 0, world: int = 1):
        if batch % world:
            raise ValueError(
                f"batch {batch} does not divide over {world} data-parallel "
                "shards; pad or re-batch the input")
        self.cfg, self.batch, self.seq = cfg, batch, seq
        n = batch // world
        self._rows = slice(rank * n, (rank + 1) * n)
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._seed = seed + start
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        i = 0
        while not self._stop.is_set():
            try:
                b = make_batch(self.cfg, self.batch, self.seq,
                               seed=self._seed + i)
                b = {k: torch.as_tensor(v[self._rows]).to(self.device)
                     for k, v in b.items()}
            except Exception as e:  # raised by the next __next__
                b = e
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    i += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self._q.get()
        if isinstance(b, Exception):
            raise b
        return b

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
