"""Gathered-frontier segment reduction: O(cap_e) instead of O(E).

Counterpart of ``repro.kernels.segment_reduce.sparse``.  A gathered
frontier edge subset changes every iteration, so no host-side plan
exists for it; it is reduced over exactly the ``[cap_e]`` slice.
Padding and masked slots carry segment id -1 and are ignored, so callers
need not substitute the identity first.

On the card one hand-written CUDA kernel (``gathered_reduce_{f32,i32}``
in ``csrc/segment_reduce.cu``, beside K1 and K2) reduces the slice in
one launch: a dead slot makes no atomic, so the empty slots of a sparse
iteration cost a read of their ids and nothing more.  It replaces no TPU
kernel (the reference scatters with plain XLA); it was added because a
scatter that routed every dead slot to one trash row serialised on that
row.  On the CPU its plain version runs
(:func:`gathered_segment_reduce_plain`, the scatter of
:func:`segment_reduce_ref`, as the reference's, with its
``gather_splits`` partial scatters).  :func:`gathered_segment_reduce_ref`
is the numpy oracle of both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.segment_reduce import kernel
from repro_torch.kernels.segment_reduce.ref import (identity,
                                                    segment_reduce_ref)

__all__ = ["gathered_segment_reduce", "gathered_segment_reduce_plain",
           "gathered_segment_reduce_ref"]

_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
#: the kernel's code for each kind
_KIND = {"sum": 0, "min": 1, "max": 2}
#: the int32 key of a float min's and max's identity (+-inf), which the
#: kernel's atomics order as K2's do
_IDENT_KEY = {k: int(kernel._key(torch.tensor(identity(k, torch.float32)),
                                 k))
              for k in ("min", "max")}
_INT32_MAX = torch.iinfo(torch.int32).max


def gathered_segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                            num_segments: int, kind: str,
                            plan=None) -> torch.Tensor:
    """Reduce a gathered edge subset ``values [S]`` or ``[S, D]`` into
    ``[num_segments]`` (or ``[num_segments, D]``) (``sparse.py:40-79``).

    ``segment_ids < 0`` (and ids past the segments) mark slots whose
    values are ignored.  A CUDA tensor goes to the kernel, one launch
    whatever ``plan`` says, counted in ``gathered_segment_reduce.launches``;
    it takes float32 or int32 values and int32 ids and raises on anything
    else.  On the CPU ``plan`` optionally splits the slice into
    ``plan.gather_splits`` partial scatters combined elementwise.
    """
    if values.device.type == "cuda":
        return _gathered_kernel(values, segment_ids, num_segments, kind)
    return gathered_segment_reduce_plain(values, segment_ids, num_segments,
                                         kind, plan)


gathered_segment_reduce.launches = 0


def gathered_segment_reduce_plain(values: torch.Tensor,
                                  segment_ids: torch.Tensor,
                                  num_segments: int, kind: str,
                                  plan=None) -> torch.Tensor:
    """Plain version of :func:`gathered_segment_reduce`, on any device:
    the slots scattered into ``num_segments + 1`` rows, the last a trash
    row for the negative ids, in ``plan.gather_splits`` partial
    scatters."""
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


def _gathered_kernel(values, segment_ids, num_segments, kind):
    """The card's path: check what the kernel takes, make ``out`` filled
    with the identity (a float min/max: its int32 key, which the kernel
    decodes in place), launch on the current stream."""
    name = "gathered_segment_reduce"
    if kind not in _KIND:
        raise ValueError(f"{name}: kind must be one of {tuple(_KIND)}, "
                         f"got {kind!r}")
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"{name}: values must be float32 or int32, got "
                        f"{values.dtype}")
    if values.dim() not in (1, 2):
        raise ValueError(f"{name}: values must be [S] or [S, D], got "
                         f"{tuple(values.shape)}")
    if segment_ids.dtype != torch.int32 or segment_ids.dim() != 1:
        raise TypeError(f"{name}: segment_ids must be a 1-D int32 tensor")
    if segment_ids.device != values.device:
        raise ValueError(f"{name}: segment_ids is on {segment_ids.device}, "
                         f"values on {values.device}")
    if not (values.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError(f"{name}: values and segment_ids must be "
                         "contiguous")
    if segment_ids.shape[0] != values.shape[0]:
        raise ValueError(f"{name}: {segment_ids.shape[0]} segment ids for "
                         f"{values.shape[0]} values")
    d = values.shape[1] if values.dim() == 2 else 1
    if not 0 <= num_segments <= _INT32_MAX or d > _INT32_MAX:
        raise ValueError(f"{name}: {num_segments} segments of {d} words "
                         "pass the kernel's 32-bit ids")
    keyed = kind != "sum" and values.dtype == torch.float32
    out = torch.full((num_segments,) + tuple(values.shape[1:]),
                     _IDENT_KEY[kind] if keyed else identity(kind,
                                                             values.dtype),
                     dtype=torch.int32 if keyed else values.dtype,
                     device=values.device)
    lib = kernel._library()
    entry = (lib.gathered_reduce_f32 if values.dtype == torch.float32
             else lib.gathered_reduce_i32)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = entry(values.data_ptr(), segment_ids.data_ptr(),
                    values.shape[0], d, out.data_ptr(), num_segments,
                    _KIND[kind], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    gathered_segment_reduce.launches += 1
    return out.view(torch.float32) if keyed else out


def gathered_segment_reduce_ref(values, segment_ids, num_segments: int,
                                kind: str) -> np.ndarray:
    """Numpy oracle for :func:`gathered_segment_reduce`
    (``sparse.py:82-100``): one slot at a time, from the identity (0 for
    sum; the dtype's max or min, or +-inf, for min and max), with ids
    outside ``[0, num_segments)`` dropped.  ``values`` is ``[S]`` or
    ``[S, D]``."""
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
    out = np.full((num_segments,) + values.shape[1:], ident, values.dtype)
    for v, s in zip(values, segment_ids):
        if 0 <= s < num_segments:
            out[s] = combine(out[s], v)
    return out
