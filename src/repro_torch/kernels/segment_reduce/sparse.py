"""Gathered-frontier segment reduction: O(cap_e) instead of O(E).

Counterpart of ``repro.kernels.segment_reduce.sparse``.  A gathered
frontier edge subset changes every iteration, so no host-side plan
exists for it; it is reduced with a plain scatter over exactly the
``[cap_e]`` slice.  Padding and masked slots carry segment id -1 and go
to a trash segment, so callers need not substitute the identity first.
No kernel backs it, as none does in the reference (plain XLA there).
:func:`gathered_segment_reduce_ref` is its numpy oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref

__all__ = ["gathered_segment_reduce", "gathered_segment_reduce_ref"]

_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def gathered_segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                            num_segments: int, kind: str,
                            plan=None) -> torch.Tensor:
    """Reduce a gathered edge subset into ``[num_segments]``
    (``sparse.py:40-79``).

    ``segment_ids < 0`` marks slots whose values are ignored.  ``plan``
    optionally splits the slice into ``plan.gather_splits`` partial
    scatters combined elementwise.
    """
    splits = int(getattr(plan, "gather_splits", 1) or 1) if plan else 1
    ids = torch.where(segment_ids < 0, num_segments, segment_ids)
    if splits <= 1 or splits >= ids.shape[0]:
        return segment_reduce_ref(values, ids, num_segments + 1,
                                  kind)[:num_segments]
    e = ids.shape[0]
    chunk = -(-e // splits)
    pad = chunk * splits - e
    if pad:
        ids = torch.cat([ids, ids.new_full((pad,), num_segments)])
        values = torch.cat(
            [values, values.new_zeros((pad,) + tuple(values.shape[1:]))])
    ids = ids.reshape(splits, chunk)
    values = values.reshape(splits, chunk, *values.shape[1:])
    combine = _COMBINE[kind]
    out = segment_reduce_ref(values[0], ids[0], num_segments + 1, kind)
    for s in range(1, splits):
        out = combine(out, segment_reduce_ref(values[s], ids[s],
                                              num_segments + 1, kind))
    return out[:num_segments]


def gathered_segment_reduce_ref(values, segment_ids, num_segments: int,
                                kind: str) -> np.ndarray:
    """Numpy oracle for :func:`gathered_segment_reduce`
    (``sparse.py:82-100``): one slot at a time, from the identity (0 for
    sum; the dtype's max or min, or +-inf, for min and max), with ids
    outside ``[0, num_segments)`` dropped."""
    values = np.asarray(values)
    segment_ids = np.asarray(segment_ids)
    if kind == "sum":
        ident, combine = np.zeros((), values.dtype), np.add
    elif kind == "min":
        ident = (np.iinfo(values.dtype).max
                 if np.issubdtype(values.dtype, np.integer) else np.inf)
        combine = np.minimum
    else:
        ident = (np.iinfo(values.dtype).min
                 if np.issubdtype(values.dtype, np.integer) else -np.inf)
        combine = np.maximum
    out = np.full((num_segments,), ident, values.dtype)
    for v, s in zip(values, segment_ids):
        if 0 <= s < num_segments:
            out[s] = combine(out[s], v)
    return out
