"""Plain PyTorch oracle for the embedding bag (counterpart of
``repro.kernels.embedding_bag.ref``).

It keeps ``jnp.take``'s semantics for indices out of range: an index in
``[-R, 0)`` wraps as in Python, and an index ``>= R`` or ``< -R`` gives
a row of NaN.  :func:`embedding_bags_ref` pools several tables, each
against its own row count, one table at a time.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["embedding_bag_ref", "embedding_bags_ref", "MODES"]

MODES = ("sum", "mean")


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """table [R, D]; indices [B, P] -> [B, D] pooled over P."""
    if mode not in MODES:
        raise ValueError(mode)
    r = table.shape[0]
    idx = indices.long()
    valid = (idx >= -r) & (idx < r)
    safe = torch.where(valid, torch.where(idx < 0, idx + r, idx), 0)
    rows = table[safe]                                   # [B, P, D]
    rows = torch.where(valid[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))
    return rows.sum(dim=1) if mode == "sum" else rows.mean(dim=1)


def embedding_bags_ref(tables: Sequence[torch.Tensor], indices: torch.Tensor,
                       mode: str = "sum",
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F tables [R_f, D]; indices [B, F, P] -> [B, F, D]: table f pooled
    by :func:`embedding_bag_ref` over ``indices[:, f]``, written into
    ``out`` (allocated when None), which is returned."""
    if out is None:
        out = torch.empty((indices.shape[0], len(tables), tables[0].shape[1]),
                          dtype=tables[0].dtype, device=tables[0].device)
    for f, table in enumerate(tables):
        out[:, f] = embedding_bag_ref(table, indices[:, f], mode=mode)
    return out
