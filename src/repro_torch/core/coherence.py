"""Coherence dimension: where the scatter-reduction resolves.

Counterpart of ``repro.core.coherence``.

- :func:`segment_reduce` is the **LLC / GPU-coherence analogue**: one
  global scatter into the whole vertex array in device memory, every
  update resolved by a global atomic.
- :func:`segment_reduce_owned` is the **DeNovo analogue** in plain
  form: the same scatter over edges already binned by target block.
  The kernel realisation is
  :class:`~repro_torch.kernels.segment_reduce.BlockedSegmentReducer`,
  wired in by :class:`~repro_torch.core.executor.EdgeContext` when
  ``use_kernels=True``.
"""
from __future__ import annotations

import torch

from repro_torch.core.vertex_program import Monoid
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref

__all__ = ["segment_reduce", "segment_reduce_owned"]


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, monoid: Monoid) -> torch.Tensor:
    """Monoid-dispatched segment reduction (LLC-resolved accumulation).

    The reference passes ``indices_are_sorted`` for the pull order;
    ``scatter_reduce_`` has no such hint, so sorted and unsorted ids take
    the same call.
    """
    return segment_reduce_ref(values, segment_ids, num_segments, monoid.name)


def segment_reduce_owned(values: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int, monoid: Monoid) -> torch.Tensor:
    """Owned (DeNovo-analogue) accumulation, plain realisation over the
    block-binned order."""
    return segment_reduce(values, segment_ids, num_segments, monoid)
