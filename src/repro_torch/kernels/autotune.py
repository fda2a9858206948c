"""Reducer construction (counterpart of ``repro.kernels.autotune``).

Only :func:`build_reducer` is ported: the one construction path of the
blocked reducers.  The plan tuner is not ported yet, so callers use
:data:`~repro_torch.kernels.segment_reduce.DEFAULT_PLAN` or a plan they
give.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.kernels.segment_reduce.ops import (DEFAULT_PLAN,
                                                    BlockedSegmentReducer,
                                                    TilingPlan)

__all__ = ["build_reducer"]


def build_reducer(graph, order: str, plan: Optional[TilingPlan] = None,
                  device=None) -> BlockedSegmentReducer:
    """Build the blocked reducer for one edge order of a host ``graph``
    (``autotune.py:266-294``) on ``device`` (None: the CUDA card; raises
    ``RuntimeError`` without one unless ``device="cpu"`` is passed).

    ``order`` is "owned" (the dst-block-binned by-src order, the DeNovo
    push path) or "pull" (the CSC order, binned under any blocking since
    it is fully dst-sorted).
    """
    device = resolve_device(device)
    v = int(graph.n_nodes)
    if order == "owned":
        dst_owned = np.asarray(graph.dst)[np.asarray(graph.perm_owned)]
        return BlockedSegmentReducer.from_plan(
            dst_owned, np.asarray(graph.block_ptr), v, graph.block_size,
            plan, device=device)
    if order == "pull":
        plan = plan if plan is not None else DEFAULT_PLAN
        eff_bs = plan.block_size(graph.block_size)
        n_blocks = -(-v // eff_bs)
        bounds = np.minimum(np.arange(n_blocks + 1) * eff_bs, v)
        pull_ptr = np.asarray(graph.row_ptr_in)[bounds]
        return BlockedSegmentReducer(
            np.asarray(graph.dst_in), pull_ptr, v, eff_bs,
            tile_e=plan.tile_e, plan=plan, device=device)
    raise ValueError(f"unknown blocked order {order!r}")
