"""Parameters across the two packages: the JAX package's parameter tree,
given as numpy arrays, becomes the port's state dict.

The tree's nesting of dicts and lists maps onto dotted state-dict keys
(``{"res": [{"conv1": {"w": ...}}]}`` -> ``"res.0.conv1.w"``), which is how
``core.blocks.AtacWorks`` names its parameters, so::

    model.load_state_dict(params_from_jax(jax_tree_as_numpy))
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes) has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Flatten a parameter tree of dicts, lists and arrays into a state
    dict of CPU tensors (same values and dtypes)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _tensor(tree)}
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(params_from_jax(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
