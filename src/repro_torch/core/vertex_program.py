"""Vertex-centric program abstraction (paper Fig. 1, typed).

Counterpart of ``repro.core.vertex_program``.  A program is written
against :class:`~repro_torch.core.executor.EdgeContext`, which hides
the system configuration: the algorithm supplies ``spred``/``tpred``
(control), ``vprop`` (information) and the reduction monoid; the system
decides how each edge-propagated update executes.  State is a dict of
torch tensors on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.properties import TABLE_III, AlgorithmicProperties
from repro_torch.kernels.segment_reduce.ref import identity

__all__ = ["Monoid", "SUM", "MIN", "MAX", "EdgePhase", "VertexProgram",
           "FRONTIER_DIR_KEY", "FRONTIER_OCC_KEY", "DENSE_OCC",
           "dense_occupancy"]

State = dict  # str -> torch.Tensor

#: State key under which frontier-aware programs record the direction
#: their step chose (bool scalar, True = pull).
FRONTIER_DIR_KEY = "pull"

#: State key under which frontier-aware programs record this iteration's
#: sparse-gather occupancy: ``m_f / sparse_edge_capacity`` on the
#: gathered path, :data:`DENSE_OCC` on a dense O(E) iteration.
FRONTIER_OCC_KEY = "sparse_occ"

#: Occupancy value marking a dense iteration.
DENSE_OCC = -1.0


def dense_occupancy(device=None) -> torch.Tensor:
    """The dense-iteration occupancy sentinel as a float32 scalar."""
    return torch.tensor(DENSE_OCC, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Commutative-associative reduction: the paper's ``op``."""
    name: str  # 'sum' | 'min' | 'max'

    def identity(self, dtype: torch.dtype) -> Any:
        """The identity as a Python scalar: 0 for sum, +-inf for floats
        and the iinfo extrema for ints (``vertex_program.py:64-72``)."""
        return identity(self.name, dtype)

    def combine(self, a, b):
        if self.name == "sum":
            return a + b
        return torch.minimum(a, b) if self.name == "min" else torch.maximum(a, b)


SUM = Monoid("sum")
MIN = Monoid("min")
MAX = Monoid("max")


@dataclasses.dataclass(frozen=True)
class EdgePhase:
    """One edge-propagated reduction (one kernel of Fig. 1).

    ``vprop(state, src_ids, edge_weight) -> [E] values`` reads
    source-side properties only.  ``spred(state, src_ids)`` and
    ``tpred(state, dst_ids)`` are the algorithmic control: edges failing
    either contribute the monoid identity.  ``frontier(state) -> [V]
    bool`` feeds the dynamic configs' direction choice.  ``gatherable``
    asserts that ``spred`` restricts contributing sources to the
    frontier, which makes the sparse gathered push path sound.
    """
    monoid: Monoid
    vprop: Callable[[State, torch.Tensor, torch.Tensor], torch.Tensor]
    spred: Optional[Callable[[State, torch.Tensor], torch.Tensor]] = None
    tpred: Optional[Callable[[State, torch.Tensor], torch.Tensor]] = None
    frontier: Optional[Callable[[State], torch.Tensor]] = None
    gatherable: bool = False


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """A graph algorithm: state init, per-iteration step, convergence.

    ``init(graph, key=None)`` returns the initial state as CPU tensors
    (``key``: a ``torch.Generator`` for randomized programs); ``run``
    moves it to the run's device.  ``step(ctx, state, it)`` returns the
    next state, with ``it`` the iteration as a device int32 scalar, and
    ``converged(prev, cur)`` a bool scalar tensor.
    Frontier-aware programs set ``frontier_update`` and record their
    per-iteration direction under :data:`FRONTIER_DIR_KEY`.

    Batching protocol (:mod:`repro_torch.core.batch`): ``converged``
    reduces over the last axis only, so that on ``[B, n_q]`` row views
    of a packed state it gives each graph's verdict as a ``[B]`` bool
    (no ``vmap``); ``step`` takes ``it`` as a scalar or as ``[B]``
    per-graph counters.  ``state_pad`` maps a state key to the fill of
    its padding rows where 0 is not inert (MIS: status 2, "removed").
    """
    name: str
    init: Callable[..., State]                         # (graph, key)
    step: Callable[..., State]                         # (ctx, state, it)
    converged: Callable[[State, State], torch.Tensor]  # (prev, cur) -> bool
    extract: Callable[[State], Any]
    weighted: bool = False
    max_iters: int = 1024
    frontier_init: Optional[Callable[..., torch.Tensor]] = None  # (graph)
    frontier_update: Optional[Callable[[State], torch.Tensor]] = None
    state_pad: Optional[dict] = None  # key -> padding fill value

    @property
    def properties(self) -> AlgorithmicProperties:
        return TABLE_III[self.name]
