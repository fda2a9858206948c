"""Plain PyTorch oracle for the embedding bag (counterpart of
``repro.kernels.embedding_bag.ref``).

It keeps ``jnp.take``'s semantics for indices out of range: an index in
``[-R, 0)`` wraps as in Python, and an index ``>= R`` or ``< -R`` gives
a row of NaN.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_ref", "MODES"]

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
