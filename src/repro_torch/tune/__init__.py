"""Tuning of the conv1d layer's three passes (counterpart of
``repro/tune``): a cost model ranks the candidates, a measured search on
the card decides among the best few, and a JSON cache keeps the winner
per pass and shape.

  * ``problem`` — ``ConvProblem``, one pass of one layer instance;
  * ``space``   — the legal ``(backend, tile, body)`` candidates, legality
                  by the kernels' own rule;
  * ``cost``    — the analytic H100 ranking;
  * ``measure`` — graph-replayed device time on the card (host clock on
                  the CPU); a backward problem times its own pass;
  * ``cache``   — the persistent cache and the memo of ``auto`` plans;
  * ``presets`` — the paper's Figs 4-6 shapes and the AtacWorks and
                  serving cells;
  * ``sweep``   — the Figs 4-6 sweep against cuDNN.

Entry points:

  * ``get_config(...)`` / ``get_config_for(problem)`` — one pass: cache hit
    -> the cached winner; miss -> a measured search only when allowed
    (``REPRO_TUNE=1`` or ``allow_measure=True``), else the default
    (``cuda`` with the kernel's own tile on a card, ``ref`` on the CPU),
    leaving the cache untouched.
  * ``get_plan(...)`` — all three passes of one layer; what
    ``ops.conv1d(backend="auto")`` runs.  A miss measures the forward
    only (a forward-only caller would tune gradients it never computes).
  * ``tune(...)`` / ``tune_problem(problem)`` — enumerate, rank, measure
    every candidate (or the cost model's top k), keep the winner.
    ``python -m repro_torch.tune`` drives it over the presets.

Like the launchers, every entry point runs on the card unless the caller
asks for the CPU (``device="cpu"``); with no card and no device named it
raises (``launch.device.require_device``).

Telemetry hooks wait for the port of ``obs/``.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.launch.device import require_device

from . import cost as _cost
from . import measure as _measure
from . import presets  # noqa: F401  (re-exported work-lists)
from . import space as _space
from .cache import (PLANS, TuneCache, cache_key, get_default_cache,
                    reset_default_cache)
from .problem import PASSES, ConvProblem
from .space import Candidate

ENV_TUNE = "REPRO_TUNE"


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    backend: str                 # 'cuda' | 'library' | 'ref'
    tile: int | None             # conv1d_fwd's register tile (None: own)
    body: str | None             # conv1d_bwd_weight's body (None: own)
    source: str                  # 'cache' | 'measured' | 'cost' | 'default'
    sec: float | None = None     # measured seconds, if any


def as_device(device=None) -> torch.device:
    """A torch.device: the current card for None or "cuda" (raises when
    there is none), the CPU only when asked for."""
    return require_device("cuda" if device is None else device)


def device_kind(device: torch.device | str | None = None) -> str:
    """The name a cache key carries: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, "cpu" for the
    host."""
    device = as_device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def measurement_enabled() -> bool:
    return os.environ.get(ENV_TUNE) == "1"


def _make_problem(*, N, C, K, S, dilation, Q, dtype, padding="VALID",
                  depthwise=False, epilogue="none", pass_="fwd"
                  ) -> ConvProblem:
    return ConvProblem(N=N, C=C, K=K, S=S, dilation=dilation, Q=Q,
                       dtype=dtype, padding=padding, depthwise=depthwise,
                       epilogue=epilogue, pass_=pass_)


def default_config(device: torch.device | str | None = None) -> TunedConfig:
    """What a miss resolves to without measuring: the kernels with their
    own tile and body on a card, the plain version on the CPU."""
    backend = "cuda" if as_device(device).type == "cuda" else "ref"
    return TunedConfig(backend, None, None, "default")


def tune_problem(prob: ConvProblem, *, device=None,
                 cache: TuneCache | None = None, measure: bool = True,
                 top_k: int | None = None, iters: int = 5, warmup: int = 2,
                 backends: tuple[str, ...] | None = None) -> TunedConfig:
    """Search one problem's candidates on ``device`` and keep the winner
    under the problem's key.  ``measure=False``: the cost model alone
    picks (source 'cost'); else every candidate (at most five a pass on
    the card), or the cost model's top ``top_k``, is timed and the
    fastest wins (source 'measured')."""
    if cache is None:  # not `or`: an empty TuneCache is falsy
        cache = get_default_cache()
    dev = as_device(device)
    kind = device_kind(dev)
    allowed = (lambda p, c: _space.kernel_allows(p, c, dev.index or 0))
    cands = _space.enumerate_candidates(prob, device_kind=kind,
                                        backends=backends, allowed=allowed)
    if not cands:
        raise ValueError(f"no legal candidates for {prob.key(kind)} under "
                         f"backends={backends}")
    ranked = _cost.rank(cands, prob, device_kind=kind)
    if measure:
        timed = [(_measure.time_candidate(c, prob, device=dev, iters=iters,
                                          warmup=warmup), c)
                 for c in ranked[:top_k or None]]
        sec, best = min(timed, key=lambda t: t[0])
        cfg = TunedConfig(best.backend, best.tile, best.body, "measured", sec)
    else:
        best = ranked[0]
        cfg = TunedConfig(best.backend, best.tile, best.body, "cost")
    cache.put(prob.key(kind), {**best.as_entry(), "source": cfg.source,
                               "sec": cfg.sec})
    PLANS.clear()  # a memoised auto plan may predate this entry
    return cfg


def tune(*, N: int, C: int, K: int, S: int, dilation: int, Q: int, dtype,
         padding: str = "VALID", depthwise: bool = False,
         epilogue: str = "none", pass_: str = "fwd", device=None,
         cache: TuneCache | None = None, measure: bool = True,
         top_k: int | None = None, iters: int = 5, warmup: int = 2,
         backends: tuple[str, ...] | None = None) -> TunedConfig:
    """Keyword spelling of ``tune_problem`` (shapes in forward-layer
    coordinates; ``pass_`` selects the pass tuned).

    Example (the cost model alone, into an explicit cache)::

        >>> import tempfile
        >>> from repro_torch import tune
        >>> cache = tune.TuneCache(tempfile.mkstemp(suffix=".json")[1])
        >>> cfg = tune.tune(N=2, C=8, K=8, S=3, dilation=2, Q=128,
        ...                 dtype="float32", device="cpu", cache=cache,
        ...                 measure=False)
        >>> cfg.source, cfg.backend
        ('cost', 'library')
    """
    prob = _make_problem(N=N, C=C, K=K, S=S, dilation=dilation, Q=Q,
                         dtype=dtype, padding=padding, depthwise=depthwise,
                         epilogue=epilogue, pass_=pass_)
    return tune_problem(prob, device=device, cache=cache, measure=measure,
                        top_k=top_k, iters=iters, warmup=warmup,
                        backends=backends)


def get_config_for(prob: ConvProblem, *, device=None,
                   cache: TuneCache | None = None,
                   allow_measure: bool | None = None) -> TunedConfig:
    """Resolve one problem: cache -> (maybe) a measured search -> the
    default.  A hit never measures again; a miss without measurement
    leaves the cache untouched."""
    if cache is None:
        cache = get_default_cache()
    hit = cache.get(prob.key(device_kind(as_device(device))))
    if hit is not None:
        return TunedConfig(hit["backend"], hit.get("tile"), hit.get("body"),
                           "cache", hit.get("sec"))
    if allow_measure is None:
        allow_measure = measurement_enabled()
    if allow_measure:
        return tune_problem(prob, device=device, cache=cache)
    return default_config(device)


def get_config(*, N: int, C: int, K: int, S: int, dilation: int, Q: int,
               dtype, padding: str = "VALID", depthwise: bool = False,
               epilogue: str = "none", pass_: str = "fwd", device=None,
               cache: TuneCache | None = None,
               allow_measure: bool | None = None) -> TunedConfig:
    """Keyword spelling of ``get_config_for``."""
    prob = _make_problem(N=N, C=C, K=K, S=S, dilation=dilation, Q=Q,
                         dtype=dtype, padding=padding, depthwise=depthwise,
                         epilogue=epilogue, pass_=pass_)
    return get_config_for(prob, device=device, cache=cache,
                          allow_measure=allow_measure)


def get_plan(*, N: int, C: int, K: int, S: int, dilation: int, Q: int,
             dtype, padding: str = "VALID", depthwise: bool = False,
             epilogue: str = "none", device=None,
             cache: TuneCache | None = None,
             allow_measure: bool | None = None) -> dict[str, TunedConfig]:
    """All three passes of one layer instance, each through its own key;
    what ``ops.conv1d(backend="auto")`` runs.  The forward resolves
    through ``get_config_for`` (a measured search on a miss when
    allowed); the backward passes from the cache or the default, never
    measured here: a forward-only caller would tune gradients it never
    computes (``tune(pass_=...)`` tunes them).  The JAX package's
    ``get_plan`` measures all three on a miss.

    Example::

        >>> import tempfile
        >>> from repro_torch import tune
        >>> cache = tune.TuneCache(tempfile.mkstemp(suffix=".json")[1])
        >>> plan = tune.get_plan(N=2, C=8, K=8, S=3, dilation=2, Q=128,
        ...                      dtype="float32", device="cpu", cache=cache)
        >>> sorted(plan), plan["fwd"].source, plan["fwd"].backend
        (['bwd_data', 'bwd_weight', 'fwd'], 'default', 'ref')
    """
    base = _make_problem(N=N, C=C, K=K, S=S, dilation=dilation, Q=Q,
                         dtype=dtype, padding=padding, depthwise=depthwise,
                         epilogue=epilogue)
    return {p: get_config_for(base.with_pass(p), device=device, cache=cache,
                              allow_measure=allow_measure if p == "fwd"
                              else False)
            for p in PASSES}


__all__ = [
    "Candidate", "ConvProblem", "PASSES", "TuneCache", "TunedConfig",
    "as_device", "cache_key", "default_config", "device_kind", "get_config",
    "get_config_for", "get_default_cache", "get_plan",
    "measurement_enabled", "presets", "reset_default_cache", "tune",
    "tune_problem",
]
