"""The blocked segment reducer around the kernels (counterpart of
``repro.kernels.segment_reduce.ops``).

The segment ids and block offsets of an edge order are fixed, so the
reducer takes them to the device once, with their chunk plan
(:class:`~repro_torch.kernels.segment_reduce.kernel.ChunkPlan`: one CTA
per chunk of at most ``CHUNK_E`` edges of one block), and reduces many
times with launches only: no host sync, no copy to the host.  On the
main path the values already come in the binned edge order, so the
kernels read them as they are: the TPU path's tile gather
(``ops.py:190-197``) is not needed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.segment_reduce.kernel import (CHUNK_E, ChunkPlan,
                                                       seg_minmax, seg_sum)
from repro_torch.kernels.segment_reduce.ref import identity

__all__ = ["BlockedSegmentReducer", "TilingPlan", "DEFAULT_PLAN",
           "coarsen_block_ptr", "bin_edges_by_block"]


@dataclasses.dataclass(frozen=True)
class TilingPlan:
    """One point of the blocked reducer's tuning space
    (``repro.kernels.segment_reduce.ops:22``).

    - ``tile_e``: edges per tile of the TPU plan; the CUDA kernels'
      threads per CTA (a CTA reduces one chunk of the chunk plan).
    - ``block_mult``: output blocks cover ``block_mult`` base blocks.
    - ``block_div``: output blocks of ``base // block_div`` vertices,
      sound only for the fully dst-sorted pull order.
    - ``gather_splits``: partial scatters of the sparse gathered path.
    - ``source``: provenance tag, not part of equality.
    """

    tile_e: int = 512
    block_mult: int = 1
    block_div: int = 1
    gather_splits: int = 1
    source: str = dataclasses.field(default="default", compare=False)

    def __post_init__(self):
        if self.block_mult > 1 and self.block_div > 1:
            raise ValueError("TilingPlan: block_mult and block_div are "
                             "mutually exclusive")
        if min(self.tile_e, self.block_mult, self.block_div,
               self.gather_splits) < 1:
            raise ValueError("TilingPlan fields must be >= 1")

    def astuple(self):
        """The identity-relevant fields (cache key material)."""
        return (self.tile_e, self.block_mult, self.block_div,
                self.gather_splits)

    def block_size(self, base_block_size: int) -> int:
        """Effective output-block size on a base blocking."""
        if self.block_div > 1:
            return max(1, base_block_size * self.block_mult
                       // self.block_div)
        return base_block_size * self.block_mult


#: The static default tiling.
DEFAULT_PLAN = TilingPlan()


def coarsen_block_ptr(block_ptr: np.ndarray, mult: int) -> np.ndarray:
    """Per-block edge offsets after merging ``mult`` consecutive blocks:
    the base offsets sampled every ``mult`` entries, the last kept."""
    block_ptr = np.asarray(block_ptr)
    if mult <= 1:
        return block_ptr
    n_blocks = block_ptr.shape[0] - 1
    n_coarse = -(-n_blocks // mult)
    idx = np.minimum(np.arange(n_coarse + 1) * mult, n_blocks)
    return block_ptr[idx]


def bin_edges_by_block(dst: np.ndarray, n_nodes: int,
                       block_size: int) -> tuple:
    """Bin an edge list by destination block: ``(perm, block_ptr)``.

    ``perm`` stable-sorts edges by ``dst // block_size``, keeping the
    input order inside each block; ``block_ptr`` gives per-block edge
    offsets.
    """
    dst = np.asarray(dst, np.int64)
    n_blocks = (int(n_nodes) + block_size - 1) // block_size
    blk = dst // block_size
    perm = np.argsort(blk, kind="stable")
    block_ptr = np.zeros(n_blocks + 1, dtype=np.int64)
    np.add.at(block_ptr, blk + 1, 1)
    return perm.astype(np.int32), np.cumsum(block_ptr).astype(np.int32)


class BlockedSegmentReducer:
    """Plan once on the host, reduce many times on ``device`` (None: the
    CUDA card; raises ``RuntimeError`` without one unless ``device="cpu"``
    is passed).

    ``segment_ids`` arrive binned by target block with ``block_ptr``
    giving per-block edge offsets, as :class:`~repro_torch.graph.Graph`
    keeps them.  ``chunks`` is their chunk plan on the device: a block's
    edges are spread over CTAs of at most ``CHUNK_E`` edges each, and a
    split block's partials are merged by the last of its CTAs, so calls
    of one reducer must be ordered on one stream.  ``n_tiles`` is the
    size of the TPU tiling plan for the same edges, kept for comparison
    with the reference.
    """

    def __init__(self, segment_ids: np.ndarray, block_ptr: np.ndarray,
                 num_segments: int, block_size: int, tile_e: int = 512,
                 plan: "TilingPlan | None" = None, device=None):
        device = resolve_device(device)
        self.plan = plan if plan is not None else TilingPlan(tile_e=tile_e)
        block_ptr = np.asarray(block_ptr)
        self.n_tiles = int(np.maximum(1, -(-np.diff(block_ptr)
                                           // tile_e)).sum())
        self.segment_ids = torch.as_tensor(
            np.asarray(segment_ids, np.int32)).to(device)
        self.block_ptr = torch.as_tensor(block_ptr.astype(np.int32)).to(device)
        self.chunks = ChunkPlan.build(block_ptr, CHUNK_E, device)
        self.tile_e = int(tile_e)
        self.num_segments = int(num_segments)
        self.block_size = int(block_size)

    @classmethod
    def from_plan(cls, segment_ids: np.ndarray, block_ptr: np.ndarray,
                  num_segments: int, base_block_size: int,
                  plan: "TilingPlan | None" = None,
                  device=None) -> "BlockedSegmentReducer":
        """Plan-parameterized constructor: ``block_mult`` coarsens the
        base blocking before the reducer is built."""
        plan = plan if plan is not None else DEFAULT_PLAN
        if plan.block_div > 1:
            raise ValueError("from_plan cannot refine blocks (block_div "
                             "> 1) from a base block_ptr; build from "
                             "per-vertex row offsets instead")
        return cls(segment_ids, coarsen_block_ptr(block_ptr, plan.block_mult),
                   num_segments, base_block_size * plan.block_mult,
                   tile_e=plan.tile_e, plan=plan, device=device)

    def _reduce(self, fn, values: torch.Tensor, **kw) -> torch.Tensor:
        squeeze = values.dim() == 1
        out = fn(values[:, None] if squeeze else values.contiguous(),
                 self.segment_ids, self.block_ptr,
                 block_size=self.block_size, num_segments=self.num_segments,
                 tile_e=self.tile_e, chunks=self.chunks, **kw)
        return out[:, 0] if squeeze else out

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce(seg_sum, values)

    def min(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce(seg_minmax, values, is_min=True)

    def max(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce(seg_minmax, values, is_min=False)

    def reduce(self, values: torch.Tensor, kind: str) -> torch.Tensor:
        return getattr(self, kind)(values)

    @staticmethod
    def identity(kind: str, dtype: torch.dtype):
        """The monoid identity this reducer assumes for ``kind``."""
        return identity(kind, dtype)

    def masked(self, values: torch.Tensor, mask: torch.Tensor,
               kind: str, ident=None) -> torch.Tensor:
        """Reduce with an [E] edge mask: masked-out edges contribute the
        identity.  The predicate entry point of both the push/owned and
        the pull/CSC paths."""
        if ident is None:
            ident = self.identity(kind, values.dtype)
        if values.dim() == mask.dim() + 1:
            mask = mask[..., None]
        return self.reduce(torch.where(mask, values, ident), kind)
