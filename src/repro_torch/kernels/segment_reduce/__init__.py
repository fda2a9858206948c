from repro_torch.kernels.segment_reduce.kernel import (CHUNK_E, SOURCE,
                                                       ChunkPlan, plan_chunks,
                                                       plan_tiles, seg_minmax,
                                                       seg_minmax_plain,
                                                       seg_sum, seg_sum_plain)
from repro_torch.kernels.segment_reduce.ops import (DEFAULT_PLAN,
                                                    BlockedSegmentReducer,
                                                    TilingPlan,
                                                    bin_edges_by_block,
                                                    coarsen_block_ptr)
from repro_torch.kernels.segment_reduce.ref import (identity,
                                                    segment_max_ref,
                                                    segment_min_ref,
                                                    segment_reduce_ref,
                                                    segment_sum_ref)
from repro_torch.kernels.segment_reduce.sparse import (
    gathered_segment_reduce, gathered_segment_reduce_plain,
    gathered_segment_reduce_ref)

__all__ = ["BlockedSegmentReducer", "TilingPlan", "DEFAULT_PLAN",
           "bin_edges_by_block", "coarsen_block_ptr", "plan_tiles",
           "plan_chunks", "ChunkPlan", "CHUNK_E",
           "seg_sum", "seg_sum_plain", "seg_minmax", "seg_minmax_plain",
           "SOURCE", "identity", "segment_reduce_ref",
           "segment_sum_ref", "segment_min_ref", "segment_max_ref",
           "gathered_segment_reduce", "gathered_segment_reduce_plain",
           "gathered_segment_reduce_ref"]
