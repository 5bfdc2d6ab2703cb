"""Hand-written CUDA kernels (``csrc/``): the dilated conv1d layer's, with
their ctypes wrappers (``conv1d_brgemm.py``) and layer-facing ops
(``ops.py``), and flash attention's, with their wrappers and autograd
Function (``flash_attention.py``); and the plain PyTorch versions the
kernels are held against (``ref.py``)."""
