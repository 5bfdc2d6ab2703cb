"""The launchers' device rule: the port runs on the GPU unless the caller
asks for the CPU."""
from __future__ import annotations

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
