"""Persistent JSON cache of tuned conv1d configurations (counterpart of
``repro/tune/cache.py``).

One entry per problem (one pass of one layer instance), keyed as the JAX
package keys it (``cache_key``): device kind, dtype, shape, padding,
dense/depthwise, then ``|ep:<signature>`` for a fused epilogue and
``|pass:<pass>`` for a backward pass.  An entry names the winner::

    {"NVIDIA H100 80GB HBM3|float32|N4|C64|K64|S25|d1|Q5000|SAME|dense":
        {"backend": "cuda", "tile": 408, "body": null,
         "source": "measured", "sec": 2.1e-4}}

``tile`` is ``conv1d_fwd``'s register tile (fwd, bwd_data), ``body``
``conv1d_bwd_weight``'s body; ``backend`` is ``cuda``, ``library`` or
``ref``.

Path: explicit argument > ``REPRO_TUNE_CACHE`` > ``~/.cache/repro_torch/
tune_cache.json`` (never the JAX package's file, whose entries name its
own backends).  Writes are atomic (temporary file, then rename), and the
file is read again when its mtime changes, so a long-lived process picks
up entries another process wrote.

``reset_default_cache`` also clears ``PLANS``, the process-wide memo of
``backend="auto"`` plans (``repro_torch.kernels.ops``), so a plan is never
read from a cache that is no longer the default.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

ENV_CACHE_PATH = "REPRO_TUNE_CACHE"
_DEFAULT_PATH = os.path.join("~", ".cache", "repro_torch", "tune_cache.json")

# backend="auto"'s plans, one per (cache path, device, layer instance)
PLANS: dict[tuple, Any] = {}


def default_cache_path() -> str:
    return os.path.expanduser(os.environ.get(ENV_CACHE_PATH) or _DEFAULT_PATH)


def cache_key(*, device_kind: str, dtype: str, N: int, C: int, K: int,
              S: int, dilation: int, Q: int, padding: str,
              depthwise: bool = False, epilogue: str = "none",
              pass_: str = "fwd") -> str:
    """The JAX package's key for the same device kind (its ``alg``,
    ``nblk`` and ``pipe`` suffixes have no counterpart on this card)."""
    kind = "dw" if depthwise else "dense"
    base = (f"{device_kind}|{dtype}|N{N}|C{C}|K{K}|S{S}|d{dilation}"
            f"|Q{Q}|{padding}|{kind}")
    if epilogue not in (None, "", "none"):
        base = f"{base}|ep:{epilogue}"
    if pass_ not in (None, "", "fwd"):
        base = f"{base}|pass:{pass_}"
    return base


class TuneCache:
    """Dict-like view over one JSON cache file."""

    def __init__(self, path: str | None = None):
        self.path = os.path.expanduser(path) if path else default_cache_path()
        self._entries: dict[str, dict[str, Any]] | None = None
        self._mtime: float | None = None

    def _load(self) -> dict[str, dict[str, Any]]:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            if self._entries is None:
                self._entries = {}
            return self._entries
        if self._entries is None or mtime != self._mtime:
            try:
                with open(self.path) as f:
                    self._entries = json.load(f)
            except (OSError, json.JSONDecodeError):
                self._entries = {}
            self._mtime = mtime
        return self._entries

    def _persist(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tune.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._entries, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._mtime = os.path.getmtime(self.path)

    def get(self, key: str) -> dict[str, Any] | None:
        return self._load().get(key)

    def put(self, key: str, entry: dict[str, Any], *,
            persist: bool = True) -> None:
        self._load()[key] = dict(entry)
        if persist:
            self._persist()

    def __len__(self) -> int:
        return len(self._load())

    def keys(self):
        return self._load().keys()


_default: TuneCache | None = None


def get_default_cache() -> TuneCache:
    """Process-wide cache bound to the current ``REPRO_TUNE_CACHE`` value
    (made anew when the variable changes)."""
    global _default
    path = default_cache_path()
    if _default is None or _default.path != path:
        _default = TuneCache(path)
    return _default


def reset_default_cache() -> None:
    """Forget the process-wide cache and every memoised auto plan."""
    global _default
    _default = None
    PLANS.clear()
