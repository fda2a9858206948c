"""Consistency dimension: schedule freedom of the update stream.

Counterpart of ``repro.core.consistency``.  Given a per-chunk reduction
``chunk_reduce(chunk_idx) -> [V'] partial``:

- **DRF0**: one monolithic reduction.
- **DRF1**: an ordered chunk pipeline; partials combine in chunk order.
- **DRFrlx**: independent partials stacked ``[C, V']``, then one
  reorderable combine over the chunk axis.

All three give the same result for min and max, and agree to float
rounding for sums, because the monoid is commutative and associative.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.config_space import Consistency
from repro_torch.core.vertex_program import Monoid

__all__ = ["scheduled_reduce"]


def scheduled_reduce(chunk_reduce: Callable[[int], torch.Tensor],
                     n_chunks: int, consistency: Consistency,
                     monoid: Monoid) -> torch.Tensor:
    """Combine ``n_chunks`` partial reductions under a consistency model."""
    if consistency is Consistency.DRF0 or n_chunks == 1:
        return chunk_reduce(0)

    if consistency is Consistency.DRF1:
        out = chunk_reduce(0)
        for i in range(1, n_chunks):
            out = monoid.combine(out, chunk_reduce(i))
        return out

    partials = torch.stack([chunk_reduce(i) for i in range(n_chunks)])
    if monoid.name == "sum":
        return partials.sum(dim=0)
    if monoid.name == "min":
        return partials.amin(dim=0)
    return partials.amax(dim=0)
