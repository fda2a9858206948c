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
from repro_torch.core.resilience import (DEFAULT_CHECKPOINT_EVERY,
                                         DEFAULT_RING_CAPACITY, Checkpoint,
                                         CheckpointRing, ExecutionFault,
                                         FaultInjector, RetryPolicy,
                                         build_sentinels, check_certificate,
                                         check_state_host, run_resilient)
from repro_torch.core.durability import (CHECKPOINT_MAGIC,
                                         CHECKPOINT_VERSION, CheckpointStore)
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
    "CHECKPOINT_MAGIC", "CHECKPOINT_VERSION", "CheckpointStore",
    "DEFAULT_CHECKPOINT_EVERY", "DEFAULT_RING_CAPACITY", "Checkpoint",
    "CheckpointRing", "ExecutionFault", "FaultInjector", "RetryPolicy",
    "build_sentinels", "check_certificate", "check_state_host",
    "run_resilient",
    "TABLE_III", "AlgorithmicProperties", "Locus", "Traversal",
    "DENSE_OCC", "FRONTIER_DIR_KEY", "FRONTIER_OCC_KEY", "MAX", "MIN",
    "SUM", "EdgePhase", "Monoid", "VertexProgram", "dense_occupancy",
]
