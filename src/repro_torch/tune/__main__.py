r"""Pre-populate the conv1d tuning cache over the paper's figure shapes,
all three passes (fwd, bwd_data, bwd_weight) per shape (counterpart of
the JAX package's ``scripts/tune.py``).

    PYTHONPATH=src python -m repro_torch.tune --figset all --measure
    PYTHONPATH=src python -m repro_torch.tune --figset fig5 --full \
        --cache c.json
    PYTHONPATH=src python -m repro_torch.tune --figset serving
    PYTHONPATH=src python -m repro_torch.tune --figset fig4 --device cpu

One entry per (S, Q, pass) cell of the selected figures (``presets``), so
afterwards ``ops.conv1d(backend="auto")`` on those shapes, forward or
gradient, finds its plan in the cache.  The default is the cost model
(fast, deterministic); ``--measure`` times every legal candidate on the
device (graph-replayed device time on a card; ``--top-k`` only the cost
model's best k).  It tunes for the card and raises without one unless
``--device cpu`` asks for the host, whose candidates are ``ref`` and
``library``.
"""
from __future__ import annotations

import argparse

from . import TuneCache, get_default_cache, tune
from .presets import FIGSETS, atacworks_shapes, figset_shapes, serving_shapes
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
    n = 0
    for name, prob in work:
        for pass_ in passes:
            cfg = tune(**prob, pass_=pass_, device=args.device, cache=cache,
                       measure=args.measure, iters=args.iters,
                       top_k=args.top_k, backends=backends)
            n += 1
            sec = f" {cfg.sec:.3e}s" if cfg.sec is not None else ""
            print(f"{name} S={prob['S']:>2} Q={prob['Q']:>6} {prob['dtype']} "
                  f"{pass_:>10}: {cfg.backend} tile={cfg.tile} "
                  f"body={cfg.body} [{cfg.source}]{sec}")
    print(f"\n{n} entries -> {cache.path} ({len(cache)} total)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
