"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each library is a plain C interface compiled for Hopper (``sm_90a``) into
``<checkout>/build/kernels/<name>-<hash>.so``, where the hash covers the
sources and the flags: the first call after a change builds, later calls
load.  The directory is listed in ``.gitignore``.  A missing ``nvcc`` or a
failed build raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``).  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, not under CUDA_HOME or /usr/local/cuda)"
        ": the CUDA kernels are built from source at first use and need the "
        "CUDA toolkit")


def _digest(sources: tuple[Path, ...]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(name: str, sources: tuple[str, ...]) -> Path:
    """Compile ``sources`` (file names under ``csrc/``) into one shared
    library unless a build of the same sources and flags exists; returns
    its path.  Headers (``.cuh``) among ``sources`` enter the hash and are
    included by the ``.cu`` files, not compiled.  ``nvcc``'s output, with
    ptxas' register and spill report, is kept beside it as
    ``<name>-<hash>.log``."""
    srcs = tuple(CSRC / s for s in sources)
    out = BUILD_DIR / f"{name}-{_digest(srcs)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(s) for s in srcs if s.suffix == ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = out.with_suffix(".log")
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    return ctypes.CDLL(str(build(name, sources)))
