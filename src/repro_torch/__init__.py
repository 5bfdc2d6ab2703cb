"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The layout mirrors the JAX package module for module
(``repro_torch/kernels/ops.py`` is the counterpart of
``repro/kernels/ops.py``); every Pallas TPU kernel on a ported path is a
CUDA C++ kernel written for ``sm_90a`` under ``kernels/csrc/``.  This
package imports ``torch`` and numpy only — never ``jax`` and never
``repro`` — so it runs on a machine that has neither.  See README.md,
section "PyTorch/CUDA port".
"""
__version__ = "0.1.0"
