"""Hand-written CUDA kernels for the hot reductions.

Each kernel package holds the CUDA source (``csrc/``), the wrapper that
launches it (``kernel.py``, beside the plain PyTorch version it is
tested against), the reducer around it (``ops.py``) and plain
references (``ref.py``).  On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches its kernel or raises.
"""
