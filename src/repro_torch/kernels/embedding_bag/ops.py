"""Public embedding-bag op (counterpart of
``repro.kernels.embedding_bag.ops``).

``impl="kernel"``, the default, goes through the wrapper of the CUDA
kernel (:func:`~repro_torch.kernels.embedding_bag.kernel.embag`), which
runs its plain version only on a CPU tensor; ``impl="plain"`` is the
plain PyTorch oracle, kept for comparison.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "IMPLS"]

IMPLS = ("kernel", "plain")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  mode: str = "sum", impl: str = "kernel") -> torch.Tensor:
    """table [R, D]; indices [B, P] int32 -> [B, D] pooled over P."""
    if impl == "kernel":
        return embag(table, indices, mode=mode)
    if impl == "plain":
        return embedding_bag_ref(table, indices, mode=mode)
    raise ValueError(f"embedding_bag: impl must be one of {IMPLS}, got "
                     f"{impl!r}")
