"""Hand-written CUDA kernels: the blocked segment reducers, the embedding
bag and flash attention.

Each kernel package holds the CUDA source (``csrc/``), the wrapper that
launches it (``kernel.py``, beside the plain PyTorch version it is
tested against), the op or reducer around it (``ops.py``) and plain
references (``ref.py``).  On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches its kernel or raises.  All four
are built by :mod:`repro_torch.kernels._build`.
"""
