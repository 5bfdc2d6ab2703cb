"""The paper's Figure 4/5/6 parameter sets, as tuner work-lists (a copy of
the data of ``repro/tune/presets.py``).

Shared by ``python -m repro_torch.tune`` (cache pre-population) and
``repro_torch.tune.sweep`` (the efficiency sweep), so the shapes swept are
exactly the shapes pre-tuned.
"""
from __future__ import annotations

# figure -> (dtype name, C, K, dilation); batch matches the sweep benchmark
FIGSETS = {
    "fig4": ("float32", 15, 15, 8),
    "fig5": ("float32", 64, 64, 1),
    "fig6": ("bfloat16", 32, 32, 4),
}
Q_SET = [1000, 5000, 20000]
Q_SET_FULL = [1000, 2000, 5000, 10000, 20000, 60000]
S_SET = [5, 25, 51]
S_SET_FULL = [1, 5, 9, 15, 21, 25, 31, 49, 51]
N = 4  # batch (paper used 56/64; scaled to the 1-core container)

# One tiny instance for CI smoke runs: small enough that tuning all three
# passes (fwd, bwd_data, bwd_weight) over it is seconds on the CPU
# container, yet it exercises the full pass-aware cache schema.
SMOKE = dict(N=1, C=8, K=8, S=3, dilation=2, Q=128, dtype="float32",
             padding="SAME")

# The JAX package's pipelining race (DESIGN.md §15) needs at least two
# width tiles; kept with the data (the port has no pipeline axis).
SMOKE_PIPE = dict(SMOKE, Q=512)

# The AtacWorks training cell (paper Table 1 / the 6.86x e2e win) in both
# precisions: the skinny C=K=15/16, S=51, d=8 body-conv shape the
# tap-packed formulation (DESIGN.md §12) exists for.  ``python -m
# repro_torch.tune --figset atacworks`` pre-populates exactly the shapes
# the e2e training benchmark runs.
ATACWORKS_CELLS = [
    dict(N=N, C=15, K=15, S=51, dilation=8, Q=1000, dtype="float32",
         padding="SAME"),
    dict(N=N, C=15, K=15, S=51, dilation=8, Q=5000, dtype="float32",
         padding="SAME"),
    dict(N=N, C=16, K=16, S=51, dilation=8, Q=5000, dtype="bfloat16",
         padding="SAME"),
]


# Serving-shaped cells (DESIGN.md §16): the streaming conv1d path issues
# VALID-padded passes of width span + chunk with Q = chunk, at decode-style
# batch sizes — nothing the training figsets cover.  Every fused epilogue
# signature the AtacWorks streaming stack emits is keyed separately
# (epilogue is part of the cache key), so a streaming step under
# ``backend='auto'`` resolves tuned plans for each of its layer kinds
# instead of falling back to the kernel's own tile.  ``python -m
# repro_torch.tune --figset serving`` pre-populates these (forward pass
# only: serving never differentiates).
SERVING_CHUNKS = [128, 512]
SERVING_BATCHES = [4, 16]
# body convs dominate (2*11 of 25 layers): conv1 is bias+relu, conv2 is
# bias+relu+residual; the unfused instance rides along for baselines
SERVING_EPILOGUES = ["b+relu", "b+relu+r", "none"]


def serving_shapes():
    """The streaming-serving work-list (same schema as ``figset_shapes``,
    plus an ``epilogue`` field): the paper's AtacWorks body-conv shape at
    chunked widths × decode batch sizes × the streaming epilogues."""
    for batch in SERVING_BATCHES:
        for chunk in SERVING_CHUNKS:
            for ep in SERVING_EPILOGUES:
                yield dict(N=batch, C=15, K=15, S=51, dilation=8, Q=chunk,
                           dtype="float32", padding="VALID", epilogue=ep)


def atacworks_shapes():
    """The AtacWorks-cell work-list (same schema as ``figset_shapes``)."""
    yield from (dict(p) for p in ATACWORKS_CELLS)


def smoke_shapes():
    """The CI smoke work-list (one problem dict, same schema as
    ``figset_shapes``)."""
    yield dict(SMOKE)


def model_sharded_shapes(cells, mp: int):
    """Local-shape views of ``cells`` under ``mp``-way tensor parallelism
    (DESIGN.md §17), as ``(view, prob)`` pairs:

      * ``'local-K'`` — K -> K/mp, C unchanged: the dense K-sharded layer
        each model shard traces (fwd/bwd_weight read the full-C input and
        produce the local filter slice; the bwd_data pass is the
        local-K-contraction transposed GEMM the chunked model psum
        finishes).
      * ``'local-C'`` — C -> C/mp, K unchanged: the C-sharded-input view
        (a layer consuming model-sharded activations; with K localized
        alongside it is also the per-group shape depthwise channel-group
        sharding traces).

    A view whose dimension does not divide by ``mp`` is skipped, so
    callers can detect fully-unshardable cells by an empty yield.  These
    are the keys per-shard ``backend='auto'`` lookups build — a
    global-shape entry never stands in for them (the JAX package's
    ``scripts/tune.py --mp``; the port's ``--mp`` waits for tensor
    parallelism).
    """
    for p in cells:
        p = dict(p)
        if mp > 0 and p["K"] % mp == 0:
            yield "local-K", dict(p, K=p["K"] // mp)
        if mp > 0 and p["C"] % mp == 0:
            yield "local-C", dict(p, C=p["C"] // mp)


def figset_shapes(name: str, *, full: bool = False):
    """Yield one problem dict per (S, Q) cell of the named figure.

    padding='SAME' matches the sweep benchmark's calls, so the cache keys
    written here are the ones ``backend='auto'`` looks up there.
    """
    dtype, C, K, d = FIGSETS[name]
    for S in (S_SET_FULL if full else S_SET):
        for Q in (Q_SET_FULL if full else Q_SET):
            yield dict(N=N, C=C, K=K, S=S, dilation=d, Q=Q, dtype=dtype,
                       padding="SAME")
