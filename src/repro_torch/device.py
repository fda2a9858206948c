"""The device rule of every entry point of the port.

An entry point takes ``device=None``, which means the CUDA card.  It
never falls back to the CPU on its own: the CPU runs only when the
caller passes ``device="cpu"``.  This module imports nothing of the
port, so that ``kernels/`` and ``core/`` can both use it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point uses: CUDA unless the caller names
    another.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is present.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
