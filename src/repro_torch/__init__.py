"""repro_torch: the PyTorch/CUDA port of ``repro``.

Push/pull x coherence x consistency specialization for vertex-centric
graph analytics, run on an NVIDIA GPU.  Module names mirror ``repro``'s
so that each module's counterpart is easy to find; the package imports
``torch`` and numpy only.  Its entry point is
:func:`repro_torch.core.run`.
"""

__version__ = "0.1.0"
