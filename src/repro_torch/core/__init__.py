from repro_torch.core.config_space import (ALL_CONFIGS, DYNAMIC_CONFIGS,
                                           STATIC_CONFIGS, Coherence,
                                           Consistency, SystemConfig,
                                           UpdateProp)
from repro_torch.core.executor import (EdgeContext, RunResult,
                                       resolve_device, run)
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
    "EdgeContext", "RunResult", "resolve_device", "run",
    "PLAN_CACHE", "PlanCache",
    "TABLE_III", "AlgorithmicProperties", "Locus", "Traversal",
    "DENSE_OCC", "FRONTIER_DIR_KEY", "FRONTIER_OCC_KEY", "MAX", "MIN",
    "SUM", "EdgePhase", "Monoid", "VertexProgram", "dense_occupancy",
]
