"""Hand-written CUDA kernels for Hopper, one package each: ``csrc/*.cu``
(the kernel), ``ops.py`` (the checked ctypes wrapper and its launch
count) and ``ref.py`` (the plain PyTorch version the wrapper runs for
CPU tensors and the card checks are held against)."""
