"""Run provenance (counterpart of ``repro/obs/provenance.py``): the
identity block stamped first on every telemetry log, so a number can be
traced back to the code and the device that produced it.

Importing this module touches nothing.  The git sha is read once per
process (it shells out to git); everything else is read at each call,
so a log opened after ``launch.mesh.init_data_group`` carries the rank
the group gave the process, not the 0 it had before.  Every field
degrades to a placeholder rather than raising: telemetry must never take
a run down.
"""
from __future__ import annotations

import functools
import os
import platform
import subprocess


@functools.lru_cache(maxsize=1)
def _git_sha() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5,
                             cwd=here)
        sha = out.stdout.strip()
        if out.returncode == 0 and sha:
            dirty = subprocess.run(["git", "status", "--porcelain"],
                                   capture_output=True, text=True,
                                   timeout=5, cwd=here)
            return sha + ("-dirty" if dirty.stdout.strip() else "")
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def process_index() -> int:
    """The process's global rank: ``torch.distributed``'s once a group is
    started, else ``torchrun``'s ``RANK``, else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return int(os.environ.get("RANK", "0"))


def provenance() -> dict:
    """{git_sha, torch_version, cuda_version, device_kind, n_devices,
    process_index, hostname, python}, JSON-safe.  ``device_kind`` is
    ``torch.cuda.get_device_name`` of the current card, "cpu" on a host
    without one."""
    try:
        import torch
        torch_version = torch.__version__
        cuda_version = torch.version.cuda or "none"
        if torch.cuda.is_available():
            device_kind = torch.cuda.get_device_name(
                torch.cuda.current_device())
            n_devices = torch.cuda.device_count()
        else:
            device_kind, n_devices = "cpu", 0
        rank = process_index()
    except Exception:  # a broken install still gets a block
        torch_version = cuda_version = device_kind = "unknown"
        n_devices, rank = 0, 0
    return {
        "git_sha": _git_sha(),
        "torch_version": torch_version,
        "cuda_version": cuda_version,
        "device_kind": device_kind,
        "n_devices": n_devices,
        "process_index": rank,
        "hostname": platform.node(),
        "python": platform.python_version(),
    }
