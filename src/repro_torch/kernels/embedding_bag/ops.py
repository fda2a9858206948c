"""Public embedding-bag ops (counterpart of
``repro.kernels.embedding_bag.ops``).

``impl="kernel"``, the default, goes through the wrappers of the CUDA
kernel (:mod:`repro_torch.kernels.embedding_bag.kernel`), which run
their plain versions only on CPU tensors; ``impl="plain"`` is the plain
PyTorch oracle, kept for comparison.  :func:`embedding_bag` pools one
table, :func:`embedding_bags` several in one call.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.embedding_bag.kernel import embag, embag_tables
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                   embedding_bags_ref)

__all__ = ["embedding_bag", "embedding_bags", "IMPLS"]

IMPLS = ("kernel", "plain")


def _check_impl(impl: str, name: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"{name}: impl must be one of {IMPLS}, got "
                         f"{impl!r}")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  mode: str = "sum", impl: str = "kernel") -> torch.Tensor:
    """table [R, D]; indices [B, P] int32 -> [B, D] pooled over P."""
    _check_impl(impl, "embedding_bag")
    if impl == "kernel":
        return embag(table, indices, mode=mode)
    return embedding_bag_ref(table, indices, mode=mode)


def embedding_bags(tables: Sequence[torch.Tensor], indices: torch.Tensor, *,
                   mode: str = "sum", impl: str = "kernel",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F tables [R_f, D]; indices [B, F, P] int32 -> [B, F, D], table f
    pooled over ``indices[:, f]``, written into ``out`` when given."""
    _check_impl(impl, "embedding_bags")
    if impl == "kernel":
        return embag_tables(tables, indices, mode=mode, out=out)
    return embedding_bags_ref(tables, indices, mode=mode, out=out)
