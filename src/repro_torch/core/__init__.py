from repro_torch.core.config_space import (ALL_CONFIGS, DYNAMIC_CONFIGS,
                                           STATIC_CONFIGS, Coherence,
                                           Consistency, SystemConfig,
                                           UpdateProp)
from repro_torch.core.executor import (STATS, EdgeContext, ExecutorStats,
                                       RunResult, resolve_device, run,
                                       run_batch)
from repro_torch.core.batch import (BatchedEdgeContext, BatchSlice,
                                    GraphBatch, bucket_key, bucket_shape,
                                    get_graph_batch, pack_graphs,
                                    run_batch_slice, run_fused_batch)
from repro_torch.core.plan_cache import PLAN_CACHE, PlanCache
from repro_torch.core.frontier import (FrontierEdges, SparseFrontier,
                                       choose_direction, dense_to_sparse,
                                       frontier_density, frontier_edges,
                                       frontier_size, gather_frontier_edges,
                                       sparse_to_dense)
from repro_torch.core.model import specialize, specialize_partial
from repro_torch.core.specialize_learned import (DEFAULT_MODEL_PATH,
                                                 LearnedSpecializer,
                                                 ModelFileError,
                                                 SpecializeFallbackWarning,
                                                 features_from_graph,
                                                 fit_matrix, load_model,
                                                 project_config,
                                                 resolve_config, save_model,
                                                 static_config_for)
from repro_torch.core.taxonomy import (H100, PAPER_GPU, GraphProfile,
                                       HwProfile, classify, profile_graph)
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
    "ExecutorStats", "STATS",
    "BatchedEdgeContext", "BatchSlice", "GraphBatch", "bucket_key",
    "bucket_shape", "get_graph_batch", "pack_graphs", "run_batch_slice",
    "run_fused_batch",
    "PLAN_CACHE", "PlanCache",
    "CHECKPOINT_MAGIC", "CHECKPOINT_VERSION", "CheckpointStore",
    "DEFAULT_CHECKPOINT_EVERY", "DEFAULT_RING_CAPACITY", "Checkpoint",
    "CheckpointRing", "ExecutionFault", "FaultInjector", "RetryPolicy",
    "build_sentinels", "check_certificate", "check_state_host",
    "run_resilient",
    "FrontierEdges", "SparseFrontier",
    "choose_direction", "dense_to_sparse", "frontier_density",
    "frontier_edges", "frontier_size", "gather_frontier_edges",
    "sparse_to_dense",
    "specialize", "specialize_partial",
    "DEFAULT_MODEL_PATH", "LearnedSpecializer", "ModelFileError",
    "SpecializeFallbackWarning", "features_from_graph", "fit_matrix",
    "load_model", "project_config", "resolve_config", "save_model",
    "static_config_for",
    "TABLE_III", "AlgorithmicProperties", "Locus", "Traversal",
    "H100", "PAPER_GPU", "GraphProfile", "HwProfile", "classify",
    "profile_graph",
    "DENSE_OCC", "FRONTIER_DIR_KEY", "FRONTIER_OCC_KEY", "MAX", "MIN",
    "SUM", "EdgePhase", "Monoid", "VertexProgram", "dense_occupancy",
]
