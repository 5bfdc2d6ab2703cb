r"""Pre-populate the conv1d tuning cache over the paper's figure shapes,
all three passes (fwd, bwd_data, bwd_weight) per shape (counterpart of
the JAX package's ``scripts/tune.py``).

    PYTHONPATH=src python -m repro_torch.tune --figset all --measure
    PYTHONPATH=src python -m repro_torch.tune --figset fig5 --full \
        --cache c.json
    PYTHONPATH=src python -m repro_torch.tune --figset serving
    PYTHONPATH=src python -m repro_torch.tune --figset fig4 --device cpu
    PYTHONPATH=src python -m repro_torch.tune --figset atacworks --dp 2
    PYTHONPATH=src python -m repro_torch.tune --figset atacworks --mp 2

One entry per (S, Q, pass) cell of the selected figures (``presets``), so
afterwards ``ops.conv1d(backend="auto")`` on those shapes, forward or
gradient, finds its plan in the cache.  The default is the cost model
(fast, deterministic); ``--measure`` times every legal candidate on the
device (graph-replayed device time on a card; ``--top-k`` only the cost
model's best k).  It tunes for the card and raises without one unless
``--device cpu`` asks for the host, whose candidates are ``ref`` and
``library``.  ``--dp`` tunes each cell's per-rank view under that much
data parallelism (N / dp, the shape each rank runs and looks up); a cell
whose N does not divide is skipped with a message.  ``--mp`` tunes each
cell's views under that much tensor parallelism
(``presets.model_sharded_shapes``): ``local-K`` (K / mp, the K-sharded
layer each rank runs) and ``local-C`` (C / mp, a layer reading a
channel group); a cell where neither divides is skipped with a message
(atacworks' C=K=15 at mp 2; its bf16 cells, C=K=16, divide).
"""
from __future__ import annotations

import argparse

from . import TuneCache, get_default_cache, tune
from .presets import (FIGSETS, atacworks_shapes, figset_shapes,
                      model_sharded_shapes, serving_shapes)
from .problem import PASSES
from .space import BACKENDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--figset", default="all",
                    choices=[*FIGSETS, "atacworks", "serving", "all"],
                    help="figure to cover ('atacworks': the training cells, "
                         "both precisions; 'serving': the streaming chunk "
                         "cells, forward only unless --passes says more)")
    ap.add_argument("--full", action="store_true",
                    help="the full S/Q grid instead of the short one")
    ap.add_argument("--measure", action="store_true",
                    help="time the top candidates (default: cost model)")
    ap.add_argument("--passes", default="all",
                    help=f"comma list of passes ({','.join(PASSES)})")
    ap.add_argument("--backends", default=None,
                    help="comma list restricting the searched backends, "
                         "e.g. 'cuda' to race the kernel's knobs alone")
    ap.add_argument("--device", default="cuda",
                    help="device to tune for: 'cuda' (default; raises "
                         "without a card) or 'cpu'")
    ap.add_argument("--cache", default=None,
                    help="cache file (default: $REPRO_TUNE_CACHE or "
                         "~/.cache/repro_torch/tune_cache.json)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: tune the local N = N/dp "
                         "each rank runs")
    ap.add_argument("--mp", type=int, default=1,
                    help="tensor-parallel ranks: tune the local-K and "
                         "local-C views each model rank runs")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top-k", type=int, default=None,
                    help="with --measure, time only the cost model's top k "
                         "candidates a problem (default: every legal one)")
    args = ap.parse_args(argv)

    passes = list(PASSES) if args.passes == "all" else args.passes.split(",")
    for p in passes:
        if p not in PASSES:
            ap.error(f"unknown pass {p!r}; expected one of {PASSES}")
    backends = tuple(args.backends.split(",")) if args.backends else None
    for b in backends or ():
        if b not in BACKENDS:
            ap.error(f"unknown backend {b!r}; expected some of {BACKENDS}")

    cache = TuneCache(args.cache) if args.cache else get_default_cache()
    if args.figset == "atacworks":
        work = [("atacworks", p) for p in atacworks_shapes()]
    elif args.figset == "serving":
        work = [("serving", p) for p in serving_shapes()]
        if args.passes == "all":  # serving never differentiates
            passes = ["fwd"]
    else:
        names = list(FIGSETS) if args.figset == "all" else [args.figset]
        work = [(name, p) for name in names
                for p in figset_shapes(name, full=args.full)]
    if args.dp < 1:
        ap.error(f"--dp must be >= 1, got {args.dp}")
    if args.mp < 1:
        ap.error(f"--mp must be >= 1, got {args.mp}")
    n = 0
    dp = f" dp={args.dp}" if args.dp != 1 else ""
    for name, prob in work:
        if prob["N"] % args.dp:
            print(f"{name} S={prob['S']:>2} Q={prob['Q']:>6}: skipped "
                  f"(N={prob['N']} does not divide over dp={args.dp})")
            continue
        views = [("", prob)]
        if args.mp != 1:
            views = [(f" mp={args.mp}:{v}", p)
                     for v, p in model_sharded_shapes([prob], args.mp)]
            if not views:
                print(f"{name} S={prob['S']:>2} Q={prob['Q']:>6}: skipped "
                      f"(neither K={prob['K']} nor C={prob['C']} divides "
                      f"over mp={args.mp})")
                continue
        for mp, vprob in views:
            for pass_ in passes:
                cfg = tune(**vprob, pass_=pass_, shards=args.dp,
                           device=args.device, cache=cache,
                           measure=args.measure, iters=args.iters,
                           top_k=args.top_k, backends=backends)
                n += 1
                sec = f" {cfg.sec:.3e}s" if cfg.sec is not None else ""
                print(f"{name} S={prob['S']:>2} Q={prob['Q']:>6} "
                      f"{prob['dtype']}{dp}{mp} {pass_:>10}: {cfg.backend} "
                      f"tile={cfg.tile} body={cfg.body} "
                      f"[{cfg.source}]{sec}")
    print(f"\n{n} entries -> {cache.path} ({len(cache)} total)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
