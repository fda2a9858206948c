"""Plain PyTorch oracle for the embedding bag (counterpart of
``repro.kernels.embedding_bag.ref``).

It keeps ``jnp.take``'s semantics for indices out of range: an index in
``[-R, 0)`` wraps as in Python, and an index ``>= R`` or ``< -R`` gives
a row of NaN.  :func:`embedding_bags_ref` pools several tables, each
against its own row count, one table at a time.

DTensor tables (sharded execution) are pooled in ``local_map``: each
rank pools the rows it holds for its own bags, masking the others, and
the bags come back ``Partial`` over the mesh dimensions that split the
rows (never a gathered table, nor a table-sized gradient: each rank's
gradient is its own rows').
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["embedding_bag_ref", "embedding_bags_ref", "MODES"]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)

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


def _sharded_bag(table, indices, mode: str):
    """:func:`embedding_bag_ref` of a DTensor table and DTensor indices,
    in ``local_map`` (see the module's notes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    r = table.shape[0]
    rows_split = [isinstance(pl, Shard) and pl.dim == 0
                  for pl in table.placements]
    # the bags stay split over the batch where the rows are not
    idx_pl = [Replicate() if split else pl
              for split, pl in zip(rows_split, indices.placements)]
    indices = indices.redistribute(mesh, idx_pl)
    out_pl = [Partial() if split else pl
              for split, pl in zip(rows_split, idx_pl)]
    grad_pl = [pl if split else (Partial() if isinstance(ipl, Shard)
                                 else Replicate())
               for split, pl, ipl in zip(rows_split, table.placements,
                                         idx_pl)]
    _, (off, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)

    def local(tl, il):
        idx = il.long()
        valid = (idx >= -r) & (idx < r)
        safe = torch.where(valid, torch.where(idx < 0, idx + r, idx), 0)
        mine = (safe >= off) & (safe < off + tl.shape[0])
        rows = tl[torch.where(mine, safe - off, 0)] \
            * mine[..., None].to(tl.dtype)
        rows = torch.where(valid[..., None], rows,
                           torch.full((), float("nan"), dtype=tl.dtype,
                                      device=tl.device))
        return rows.sum(dim=1) if mode == "sum" else rows.mean(dim=1)

    return local_map(local, out_placements=out_pl,
                     in_placements=(tuple(table.placements), tuple(idx_pl)),
                     in_grad_placements=(grad_pl, tuple(idx_pl)))(table, indices)


def embedding_bags_ref(tables: Sequence[torch.Tensor], indices: torch.Tensor,
                       mode: str = "sum",
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F tables [R_f, D]; indices [B, F, P] -> [B, F, D]: table f pooled
    by :func:`embedding_bag_ref` over ``indices[:, f]``, written into
    ``out`` (allocated when None), which is returned.  DTensor tables
    (sharded execution) are pooled into a new stacked tensor."""
    if _is_dtensor(tables[0]):
        return torch.stack([_sharded_bag(t, indices[:, f], mode)
                            for f, t in enumerate(tables)], dim=1)
    if out is None:
        out = torch.empty((indices.shape[0], len(tables), tables[0].shape[1]),
                          dtype=tables[0].dtype, device=tables[0].device)
    for f, table in enumerate(tables):
        out[:, f] = embedding_bag_ref(table, indices[:, f], mode=mode)
    return out
