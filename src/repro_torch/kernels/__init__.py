"""Hand-written CUDA kernels for the dilated conv1d layer (``csrc/``), their
ctypes wrappers (``conv1d_brgemm.py``), the layer-facing ops (``ops.py``)
and the plain PyTorch versions the kernels are held against (``ref.py``)."""
