from repro_torch.core.config_space import (ALL_CONFIGS, DYNAMIC_CONFIGS,
                                           STATIC_CONFIGS, Coherence,
                                           Consistency, SystemConfig,
                                           UpdateProp)
from repro_torch.core.executor import (EdgeContext, RunResult,
                                       resolve_device, run, run_batch)
from repro_torch.core.batch import (BatchedEdgeContext, BatchSlice,
                                    GraphBatch, bucket_key, bucket_shape,
                                    get_graph_batch, pack_graphs,
                                    run_batch_slice, run_fused_batch)
from repro_torch.core.plan_cache import PLAN_CACHE, PlanCache
from repro_torch.core.properties import (TABLE_III, AlgorithmicProperties,
                                         Locus, Traversal)
from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, MAX, MIN, SUM,
                                             EdgePhase, Monoid,
                                             VertexProgram, dense_occupancy)

__all__ = [
    "ALL_CONFIGS", "DYNAMIC_CONFIGS", "STATIC_CONFIGS",
    "Coherence", "Consistency", "SystemConfig", "UpdateProp",
    "EdgeContext", "RunResult", "resolve_device", "run", "run_batch",
    "BatchedEdgeContext", "BatchSlice", "GraphBatch", "bucket_key",
    "bucket_shape", "get_graph_batch", "pack_graphs", "run_batch_slice",
    "run_fused_batch",
    "PLAN_CACHE", "PlanCache",
    "TABLE_III", "AlgorithmicProperties", "Locus", "Traversal",
    "DENSE_OCC", "FRONTIER_DIR_KEY", "FRONTIER_OCC_KEY", "MAX", "MIN",
    "SUM", "EdgePhase", "Monoid", "VertexProgram", "dense_occupancy",
]
