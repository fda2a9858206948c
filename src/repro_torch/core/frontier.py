"""Frontier representation and the direction-optimizing heuristic.

Counterpart of ``repro.core.frontier``.  The frontier is a dense ``[V]``
bool mask on the device.  :func:`dense_to_sparse` compacts it into a
padded id list of fixed capacity, and :func:`gather_frontier_edges`
expands that list into the frontier's CSR out-edges, so a sparse push
iteration costs O(m_f) gathered work instead of an O(E) masked scan.
Both keep fixed shapes and the true (untruncated) counts, so a caller
sees an overflow and falls back to the dense path instead of dropping
work.  Neither reads anything back to the host.

:func:`choose_direction` is Beamer's rule: while pushing, switch to pull
once the frontier's out-edges ``m_f`` exceed the unexplored edges
``m_u / alpha`` (or ``|E| / alpha`` without an unvisited set); while
pulling, switch back once the frontier holds fewer than ``|V| / beta``
vertices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["ALPHA", "BETA", "frontier_size", "frontier_edges",
           "frontier_density", "choose_direction", "choose_direction_batch",
           "SparseFrontier", "FrontierEdges", "dense_to_sparse",
           "sparse_to_dense", "gather_frontier_edges"]

#: push->pull trigger: pull once frontier out-edges exceed unexplored/ALPHA.
ALPHA = 14.0
#: pull->push trigger: push once the frontier holds fewer than V/BETA nodes.
BETA = 24.0


def frontier_size(mask: torch.Tensor) -> torch.Tensor:
    """Number of frontier vertices (``n_f``), an int32 scalar."""
    return mask.sum(dtype=torch.int32)


def frontier_edges(mask: torch.Tensor,
                   out_degree: torch.Tensor) -> torch.Tensor:
    """Number of edges leaving the frontier (``m_f``), an int32 scalar."""
    return torch.where(mask, out_degree.int(), 0).sum(dtype=torch.int32)


def frontier_density(mask: torch.Tensor, out_degree: torch.Tensor,
                     n_edges: int) -> torch.Tensor:
    """Fraction of all edges that leave the frontier, a float32 scalar
    in [0, 1] (``frontier.py:71-74``).

    The reference divides the int32 ``m_f`` by ``max(n_edges, 1)`` under
    JAX's promotion: both become float32 and are divided.  The divisor
    is a float32 tensor on the mask's device, not a Python scalar, so
    the card divides too rather than multiplying by a reciprocal, and
    the result is the reference's bit for bit.
    """
    denom = torch.tensor(float(max(n_edges, 1)), dtype=torch.float32,
                         device=mask.device)
    return frontier_edges(mask, out_degree).float() / denom


def choose_direction(mask: torch.Tensor, out_degree: torch.Tensor,
                     n_edges: int, n_nodes: int, prev_pull,
                     unvisited: Optional[torch.Tensor] = None,
                     alpha: float = ALPHA,
                     beta: float = BETA) -> torch.Tensor:
    """Per-iteration push/pull decision, a bool scalar (True = pull)
    (``frontier.py:77-96``).

    The int32 counts times the float thresholds promote to float32 and
    compare in float32, as in the reference, so the direction traces
    match.  ``prev_pull`` gives the hysteresis.
    """
    m_f = frontier_edges(mask, out_degree)
    n_f = frontier_size(mask)
    if unvisited is None:
        to_pull = m_f * alpha > n_edges
    else:
        m_u = frontier_edges(unvisited, out_degree)
        to_pull = m_f * alpha > m_u
    to_push = n_f * beta < n_nodes
    return torch.where(prev_pull, ~to_push, to_pull)


def choose_direction_batch(mask: torch.Tensor, out_degree: torch.Tensor,
                           n_edges: torch.Tensor, n_nodes: torch.Tensor,
                           prev_pull, unvisited: Optional[torch.Tensor] = None,
                           alpha: float = ALPHA,
                           beta: float = BETA) -> torch.Tensor:
    """Row-wise :func:`choose_direction` over packed graphs
    (``frontier.py:99-130``): ``[B]`` bools (True = pull).

    ``mask``, ``out_degree`` and ``unvisited`` are ``[B, n_q]`` rows
    (padding columns False in the masks); ``n_edges`` and ``n_nodes``
    the ``[B]`` true sizes as int32; ``prev_pull`` the ``[B]``
    hysteresis.  Each row's statistics are the same int32 sums as the
    scalar rule's and compare in float32 the same way, so every row
    equals :func:`choose_direction` on its own graph bit for bit.
    """
    deg = out_degree.int()
    m_f = torch.where(mask, deg, 0).sum(dim=1, dtype=torch.int32)
    n_f = mask.sum(dim=1, dtype=torch.int32)
    if unvisited is None:
        to_pull = m_f * alpha > n_edges
    else:
        m_u = torch.where(unvisited, deg, 0).sum(dim=1, dtype=torch.int32)
        to_pull = m_f * alpha > m_u
    to_push = n_f * beta < n_nodes
    return torch.where(prev_pull, ~to_push, to_pull)


class SparseFrontier(NamedTuple):
    """Padded sparse frontier plus its true size.

    ``ids`` is the ``[capacity]`` int32 vertex list (ascending, -1
    padding); ``count`` is the true vertex count, which may exceed
    ``capacity``.
    """
    ids: torch.Tensor
    count: torch.Tensor

    @property
    def overflowed(self) -> torch.Tensor:
        """Bool scalar: True iff frontier vertices were dropped."""
        return self.count > self.ids.shape[0]


class FrontierEdges(NamedTuple):
    """Padded frontier-edge list plus the gathered frontier's edge count.

    ``edge_ids`` indexes the CSR edge arrays (``[capacity]`` int32, -1
    padding); ``count`` is the total out-edge count of the gathered
    vertex list.
    """
    edge_ids: torch.Tensor
    count: torch.Tensor

    @property
    def overflowed(self) -> torch.Tensor:
        """Bool scalar: True iff frontier edges were dropped."""
        return self.count > self.edge_ids.shape[0]


def dense_to_sparse(mask: torch.Tensor, capacity: int) -> SparseFrontier:
    """Dense [V] mask -> :class:`SparseFrontier` of fixed ``capacity``
    (``frontier.py:166-178``).

    The reference's ``jnp.nonzero(size=)`` has a fixed shape;
    ``torch.nonzero`` has a data-dependent one and waits for the device.
    So the ids are compacted with a cumulative sum and a scatter into
    ``capacity`` slots plus one trash slot that takes every vertex that
    is not in the frontier or does not fit.
    """
    v = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    slot = torch.where(mask & (pos < capacity), pos, capacity).long()
    ids = torch.full((capacity + 1,), -1, dtype=torch.int32,
                     device=mask.device)
    ids.scatter_(0, slot, torch.arange(v, dtype=torch.int32,
                                       device=mask.device))
    return SparseFrontier(ids=ids[:capacity], count=frontier_size(mask))


def sparse_to_dense(ids: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Padded vertex-id list (-1 padding) -> dense ``[n_nodes]`` bool
    mask (``frontier.py:181-185``)."""
    mask = torch.zeros(n_nodes + 1, dtype=torch.bool, device=ids.device)
    mask[torch.where(ids < 0, n_nodes, ids).long()] = True
    return mask[:n_nodes]


def gather_frontier_edges(ids: torch.Tensor, row_ptr: torch.Tensor,
                          capacity: int) -> FrontierEdges:
    """Expand a sparse vertex list into its CSR out-edge list
    (``frontier.py:188-214``).

    Output slot ``j`` belongs to the k-th listed vertex where
    ``cum[k-1] <= j < cum[k]`` (a right-sided searchsorted over the
    running degree sum), at offset ``j - cum[k-1]`` within its row.
    """
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    starts = row_ptr[safe].int()
    degs = torch.where(valid, row_ptr[safe + 1].int() - starts, 0)
    cum = torch.cumsum(degs, 0, dtype=torch.int32)
    total = cum[-1]
    slot = torch.arange(capacity, dtype=torch.int32, device=ids.device)
    k = torch.searchsorted(cum, slot, right=True)
    k = torch.clamp(k, max=ids.shape[0] - 1)
    edge = starts[k] + (slot - (cum[k] - degs[k]))
    edge_ids = torch.where(slot < torch.clamp(total, max=capacity), edge, -1)
    return FrontierEdges(edge_ids=edge_ids.int(), count=total)
