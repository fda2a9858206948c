"""Plain PyTorch segment reductions (counterpart of
``repro.kernels.segment_reduce.ref``).

Each is one ``scatter_reduce_(include_self=True)`` into an output filled
with the reduction's identity, so an empty segment holds 0, +-inf or
the int32 extrema exactly as ``jax.ops.segment_*`` leaves it.  Ids
outside ``[0, num_segments)`` are dropped: they are routed to one extra
trash row that is cut off before returning.
"""
from __future__ import annotations

import torch

__all__ = ["identity", "segment_reduce_ref", "segment_sum_ref",
           "segment_min_ref", "segment_max_ref"]

#: monoid name -> ``scatter_reduce_`` reduction name
SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def identity(kind: str, dtype: torch.dtype):
    """The identity of ``kind`` ('sum' | 'min' | 'max') as a Python
    scalar: 0, +-inf for floats, the iinfo extrema for ints."""
    if kind == "sum":
        return 0.0 if dtype.is_floating_point else 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segment_reduce_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, kind: str) -> torch.Tensor:
    """Reduce ``values`` ([E] or [E, D]) by ``segment_ids`` ([E]) into
    ``[num_segments(, D)]``."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(values.shape[1:]),
                     identity(kind, values.dtype), dtype=values.dtype,
                     device=values.device)
    index = ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out.scatter_reduce_(0, index, values, SCATTER_REDUCE[kind],
                        include_self=True)
    return out[:num_segments]


def segment_sum_ref(values, segment_ids, num_segments):
    return segment_reduce_ref(values, segment_ids, num_segments, "sum")


def segment_min_ref(values, segment_ids, num_segments):
    return segment_reduce_ref(values, segment_ids, num_segments, "min")


def segment_max_ref(values, segment_ids, num_segments):
    return segment_reduce_ref(values, segment_ids, num_segments, "max")
