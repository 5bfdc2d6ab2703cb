"""The launchers' device rule: the port runs on the GPU unless the caller
asks for the CPU."""
from __future__ import annotations

import os

import torch


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and there is
    no GPU (the port never moves to the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "--device cpu (device='cpu' in the Python API) to run the plain "
            "PyTorch version on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def rank_device(device: torch.device | str) -> torch.device:
    """A started group's rank's device: ``cuda:LOCAL_RANK`` modulo the
    cards present (gloo ranks may share one card), made current; or the
    CPU when asked for."""
    if torch.device(device).type != "cuda":
        return require_device(device)
    require_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
