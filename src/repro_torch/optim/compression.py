"""Gradient compression for cross-pod reduction (counterpart of
``repro.optim.compression``).

:class:`CompressedReducer` casts gradients to a narrow type before the
(cross-pod) all-reduce and keeps the quantisation residual locally,
adding it back into the next step's gradient (error feedback, the
standard convergence-preserving trick).  At 2x16x16 scale the pod-axis
gradient reduction halves its bytes with bf16; the reduction within a
pod stays full precision.

Gradients and state are mappings of tensors (nested mappings allowed),
as the port's train steps hold them.  The numerics are the reference's
bit for bit: ``full = g.f32 + r``, ``wire = full`` rounded to the wire
type (round to nearest even on both sides), ``r' = full - wire.f32``.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import torch

__all__ = ["CompressedReducer", "all_reduce_mean"]


def _map(fn, *trees, is_pair: bool = False):
    """``fn`` over the leaves of mappings of the same keys (a leaf is a
    tensor, or with ``is_pair`` a (wire, residual) pair)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _map(fn, *(t[k] for t in trees), is_pair=is_pair)
                for k in first}
    return fn(*trees)


class CompressedReducer:
    """compress -> reduce_fn -> decompress, with error feedback.

    ``reduce_fn`` performs the cross-replica mean over the wire tensors
    (:func:`all_reduce_mean` over a process group, or anything that maps
    a mapping of tensors to one); this class owns only the numerics."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        self.dtype = dtype

    def init_state(self, grads):
        """Per-leaf f32 residual accumulators (zero)."""
        return _map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)

    def compress(self, grads, state) -> Tuple[dict, dict]:
        """Returns (wire gradients in ``self.dtype``, new residuals)."""
        def one(g, r):
            full = g.to(torch.float32) + r
            wire = full.to(self.dtype)
            return wire, full - wire.to(torch.float32)

        pairs = _map(one, grads, state)
        return (_map(lambda p: p[0], pairs, is_pair=True),
                _map(lambda p: p[1], pairs, is_pair=True))

    def reduce(self, grads, state, reduce_fn: Optional[Callable] = None
               ) -> Tuple[dict, dict]:
        """One full round: compress -> reduce -> f32 decompress."""
        wires, resid = self.compress(grads, state)
        if reduce_fn is not None:
            wires = reduce_fn(wires)
        return _map(lambda w: w.to(torch.float32), wires), resid


def all_reduce_mean(group=None) -> Callable:
    """A ``reduce_fn``: each wire tensor all-reduced (summed in its own
    type) over ``group`` with ``torch.distributed``, then divided by the
    group's size (in place, or in a contiguous copy of a strided wire)."""
    import torch.distributed as dist

    def fn(wires):
        n = dist.get_world_size(group)

        def one(w):
            w = w.contiguous()
            dist.all_reduce(w, group=group)
            return w.div_(n)
        return _map(one, wires)
    return fn
