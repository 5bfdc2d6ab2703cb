"""Fault-tolerant checkpoints of a ``TrainState`` (counterpart of
``repro/checkpoint/checkpoint.py``), in the JAX package's on-disk format
so a checkpoint crosses between the packages in both directions.

Layout::

    <dir>/step_00000100/arrays.npz      leaf arrays keyed by flat path
    <dir>/step_00000100/manifest.json   step, shapes, dtypes
    <dir>/step_00000100/COMMIT          completeness marker, written last

Flat keys are those the JAX ``_flatten`` gives its ``TrainState``:
``.params/res/0/conv1/w``, ``.opt/.m/...``, ``.opt/.v/...``,
``.opt/.count``, ``.step`` and, with gradient compression, the error
feedback ``.ef/...`` (152 leaves for the AtacWorks stack, 202 with
``ef``; 38 for Mamba2, whose per-layer leaves are stacked (L, ...) in
both packages).  bf16 leaves are stored as their raw 2-byte values, as numpy
saves the JAX package's bf16 arrays.

  * **Atomic commit**: a checkpoint is staged as ``step_<n>.tmp``, every
    file fsync'd, the ``COMMIT`` marker written last, then renamed into
    place; a directory without the marker is torn and never offered.
  * **Torn-checkpoint fallback**: ``restore(step=None)`` walks newest to
    oldest past any checkpoint that fails to load.
  * **Retention**: the ``keep`` newest are kept; deletion goes through a
    rename to ``.trash``; stale ``.tmp``, ``.trash`` and torn directories
    are swept after each save.
  * **Async writer**: ``save_async`` copies every tensor of the state to
    the host on the caller's thread (a real copy: the optimizer updates
    the parameters in place, and ``.cpu()`` of a CPU tensor is the same
    storage) and hands serialization and fsync to a daemon thread, so
    the training loop goes on at once; ``wait()`` joins it.  ``save`` and
    ``save_async`` wait first, since the sweep after a save removes
    ``*.tmp``.  A writer that dies mid-write leaves only a torn
    ``.tmp`` directory, which no reader sees; ``wait()`` reports its
    error.
  * **Elastic restore**: tensors are stored whole, so a checkpoint
    written by one (data, model) layout restores into any other (the
    elastic supervisor in ``launch/train.py``).
  * **FSDP states** (``state.params.ds``, a ``sharding.DataShards``: each
    rank holds blocks of the parameters and moments): every rank of the
    data group calls ``save`` / ``save_async``, which gather each split
    leaf whole (collectives, in the same order on every rank, on the
    caller's thread), and the group's rank 0 alone writes; ``restore``
    reads the whole arrays on every rank and keeps the rank's blocks.  The
    files are the same as a whole state's, so a checkpoint moves between
    dp 1 and dp 2 and between the packages.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState

SEP = "/"
COMMIT_MARKER = "COMMIT"
_REQUIRED = ("manifest.json", "arrays.npz", COMMIT_MARKER)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _is_complete(path: str) -> bool:
    """Complete iff every required file, the COMMIT marker included,
    exists; anything else is torn and must never be offered."""
    return all(os.path.exists(os.path.join(path, f)) for f in _REQUIRED)


def _key(name: str) -> str:
    return name.replace(".", SEP)


def state_tensors(state) -> dict[str, torch.Tensor]:
    """The state's tensors under the JAX package's flat keys."""
    flat = {f".params{SEP}{_key(k)}": p
            for k, p in state.params.named_parameters()}
    flat.update({f".opt{SEP}.m{SEP}{_key(k)}": t
                 for k, t in state.opt.m.items()})
    flat.update({f".opt{SEP}.v{SEP}{_key(k)}": t
                 for k, t in state.opt.v.items()})
    flat[f".opt{SEP}.count"] = state.opt.count
    flat[".step"] = state.step
    if state.ef is not None:
        flat.update({f".ef{SEP}{_key(k)}": t for k, t in state.ef.items()})
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, finished when this returns."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:  # raw 2-byte values, as numpy stores bf16
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # raw bf16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(like.dtype)


def _param_key(flat: str) -> str | None:
    """The parameter's state-dict key of a flat key of its value, its
    moments or its error feedback; None for the count and the step."""
    for head in (f".params{SEP}", f".opt{SEP}.m{SEP}", f".opt{SEP}.v{SEP}",
                 f".ef{SEP}"):
        if flat.startswith(head):
            return flat[len(head):].replace(SEP, ".")
    return None


def _shards(state):
    return getattr(state.params, "ds", None)


def _writes(state) -> bool:
    """Whether this process writes the state's checkpoints: always, or
    rank 0 of an FSDP state's data group."""
    shards = _shards(state)
    return shards is None or shards.rank == 0


def _snapshot(state, step: int) -> tuple[dict, dict]:
    """(arrays, manifest): host copies of the state's tensors under their
    flat keys, whole (an FSDP state's blocks gathered: a collective), and
    the manifest."""
    arrays, manifest = {}, {"step": step, "leaves": {}}
    shards = _shards(state)
    for k, t in state_tensors(state).items():
        if shards is not None and _param_key(k) is not None:
            t = shards.whole(_param_key(k), t)
        arrays[k] = _to_numpy(t)
        manifest["leaves"][k] = {
            "shape": list(t.shape),
            "dtype": str(t.dtype).removeprefix("torch.")}
    return arrays, manifest


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._failed: tuple[int, Exception] | None = None
        os.makedirs(directory, exist_ok=True)

    # -- write ------------------------------------------------------------

    def save(self, state, step: int) -> str | None:
        """Synchronous atomic save; returns the committed path (None on an
        FSDP rank that does not write)."""
        self.wait()  # _gc sweeps *.tmp: never while an async write stages
        snap = _snapshot(state, step)
        return self._write(*snap) if _writes(state) else None

    def save_async(self, state, step: int) -> None:
        """Snapshot the state now, serialize it on a daemon thread."""
        self.wait()
        snap = _snapshot(state, int(step))
        if not _writes(state):
            return
        self._thread = threading.Thread(target=self._write_reporting,
                                        args=snap, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the async writer, if one runs; print its error if it
        died (its step then stays invisible)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._failed is not None:
            step, err = self._failed
            self._failed = None
            print(f"checkpoint: async save of step {step} failed ({err!r}); "
                  f"the newest complete checkpoint is {self.latest_step()}")

    def _write_reporting(self, arrays, manifest) -> None:
        # the writer thread's boundary: a failed write must not kill the
        # process; wait() reports it
        try:
            self._write(arrays, manifest)
        except Exception as e:
            self._failed = (manifest["step"], e)

    def _write(self, arrays: dict, manifest: dict) -> str:
        step = manifest["step"]
        final = _step_dir(self.directory, step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # completeness marker LAST: a crash between any of the writes above
        # and here leaves a directory readers provably reject
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            f.write(f"{step}\n")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            victim = _step_dir(self.directory, s)
            trash = victim + ".trash"
            os.replace(victim, trash)
            shutil.rmtree(trash, ignore_errors=True)
        # sweep crash debris: stale staging dirs, half-deleted trash, and
        # torn step dirs (no COMMIT marker: unreadable by construction)
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.endswith((".tmp", ".trash")):
                shutil.rmtree(path, ignore_errors=True)
            elif (name.startswith("step_") and os.path.isdir(path)
                  and not _is_complete(path)):
                shutil.rmtree(path, ignore_errors=True)

    # -- read -------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Steps with COMPLETE checkpoints only."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(
                    (".tmp", ".trash")):
                try:
                    step = int(name[5:])
                except ValueError:
                    continue
                if _is_complete(os.path.join(self.directory, name)):
                    out.append(step)
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state, step: int | None = None):
        """Load a checkpoint into ``state`` (in place: parameters copied,
        moments, count and step replaced on the state's device) and return
        it.  Every leaf is read and checked before any is written, so a
        damaged checkpoint leaves ``state`` as it was.

        With ``step=None`` the newest checkpoint is tried first and one that
        fails to load is skipped with a message, falling back to the next
        newest.  An explicit ``step`` raises ``FileNotFoundError`` if that
        checkpoint is missing, torn or unreadable.
        """
        candidates = self.all_steps()[::-1] if step is None else [step]
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        last_err = None
        for s in candidates:
            path = _step_dir(self.directory, s)
            if not _is_complete(path):
                last_err = FileNotFoundError(
                    f"checkpoint step {s} at {path} is missing or torn "
                    "(no COMMIT marker)")
                continue
            try:
                return self._load(state, path)
            except (OSError, EOFError, KeyError, ValueError,
                    zipfile.BadZipFile) as e:  # damaged past the marker
                last_err = e
                if step is None:
                    print(f"checkpoint: step {s} unreadable ({e!r}); "
                          "falling back to an older checkpoint")
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.directory}: {last_err}")

    def _load(self, state, path: str):
        want = state_tensors(state)
        shards = _shards(state)
        loaded = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for k, like in want.items():
                a = data[k]
                key = _param_key(k)
                whole = (tuple(like.shape) if shards is None or key is None
                         else shards.shapes[key])
                if tuple(a.shape) != whole:
                    raise ValueError(f"{k}: stored shape {a.shape}, state "
                                     f"has {whole}")
                t = _from_numpy(a, like)
                if whole != tuple(like.shape):  # an FSDP rank's block
                    t = shards.block(key, t).contiguous()
                loaded[k] = t.to(like.device)
        with torch.no_grad():
            for k, p in state.params.named_parameters():
                p.copy_(loaded[f".params{SEP}{_key(k)}"])
        state.opt = AdamWState(
            m={k: loaded[f".opt{SEP}.m{SEP}{_key(k)}"] for k in state.opt.m},
            v={k: loaded[f".opt{SEP}.v{SEP}{_key(k)}"] for k in state.opt.v},
            count=loaded[f".opt{SEP}.count"])
        state.step = loaded[".step"]
        if state.ef is not None:
            state.ef = {k: loaded[f".ef{SEP}{_key(k)}"] for k in state.ef}
        return state
