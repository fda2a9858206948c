"""Amortized construction of per-graph execution-plan artifacts.

Counterpart of ``repro.core.plan_cache``.  Binding a graph to an
:class:`~repro_torch.core.executor.EdgeContext` builds costly
artifacts: the device copy of the graph, the chunked edge orders and
the blocked reducers.  Most do not depend on the whole config, so the
cache shares them across configs of one graph.

Entries are keyed on graph identity (``id(graph)``, guarded by a
``weakref.finalize`` hook that evicts a collected graph's entries) plus
an artifact kind and its build parameters; the device is part of the
parameters of every device artifact.

The batched path adds two kinds: ``"batch_pack"`` (a block-diagonal
:class:`~repro_torch.core.batch.GraphBatch`, anchored on the batch's
first member and keyed on the member identities; the batch holds its
first member weakly and the others strongly, so that no member's id can
be recycled while the entry lives) and ``"batch_context"`` (a bound
:class:`~repro_torch.core.batch.BatchedEdgeContext`, anchored on the
packed graph).  The tuner adds ``"tuned_tiling"``.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, Hashable, Tuple

__all__ = ["PlanCache", "PLAN_CACHE"]


class PlanCache:
    """Process-wide (graph, kind, params) -> artifact store with counters."""

    def __init__(self):
        self._store: Dict[Tuple[int, str, Hashable], Any] = {}
        self._finalizers: Dict[int, weakref.finalize] = {}
        #: ids of collected graphs whose entries await pruning.  A
        #: finalizer may run during a GC pass on this very thread while
        #: the store is being iterated, so it only appends here.
        self._dead: list = []
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        #: per-kind counters, kind -> [hits, misses]
        self._by_kind: Dict[str, list] = {}

    def get(self, graph: Any, kind: str, params: Hashable,
            build: Callable[[], Any], capacity: int | None = None) -> Any:
        """Return the cached artifact, building and caching it on a miss.

        ``params`` must capture everything ``build`` depends on besides
        the graph itself.  ``capacity`` bounds the entries of this
        ``(graph, kind)`` bucket: on insert, the least recently used
        beyond it are dropped (``plan_cache.py:87-126``), as the fused
        engine's captured graphs would otherwise pile up per program.
        """
        key = (id(graph), kind, params)
        with self._lock:
            self._prune()
            counters = self._by_kind.setdefault(kind, [0, 0])
            if key in self._store:
                self.hits += 1
                counters[0] += 1
                # dict order is the recency order
                value = self._store.pop(key)
                self._store[key] = value
                return value
            self.misses += 1
            counters[1] += 1
            self._watch(graph)
        # build outside the lock: builders recurse into the cache
        value = build()
        with self._lock:
            value = self._store.setdefault(key, value)
            if capacity is not None:
                bucket = [k for k in self._store
                          if k[0] == key[0] and k[1] == kind]
                for stale in bucket[:-capacity]:
                    del self._store[stale]
            return value

    def _watch(self, graph: Any) -> None:
        gid = id(graph)
        if gid not in self._finalizers:
            self._finalizers[gid] = weakref.finalize(graph, self._dead.append,
                                                     gid)

    def _prune(self) -> None:
        """Drop entries of collected graphs.  Call with the lock held."""
        while self._dead:
            gid = self._dead.pop()
            self._finalizers.pop(gid, None)
            for key in [k for k in self._store if k[0] == gid]:
                del self._store[key]

    def clear(self) -> None:
        """Drop every entry and reset the counters, per kind too."""
        with self._lock:
            for fin in self._finalizers.values():
                fin.detach()
            self._finalizers.clear()
            self._store.clear()
            self._dead.clear()
            self.hits = 0
            self.misses = 0
            self._by_kind.clear()

    def stats(self) -> Dict[str, Any]:
        """Global counters and, under ``by_kind``, each kind's
        ``{hits, misses, entries}`` (``plan_cache.py:153-177``)."""
        with self._lock:
            self._prune()
            entries: Dict[str, int] = {}
            for _, kind, _ in self._store:
                entries[kind] = entries.get(kind, 0) + 1
            by_kind = {kind: {"hits": hm[0], "misses": hm[1],
                              "entries": entries.get(kind, 0)}
                       for kind, hm in self._by_kind.items()}
            for kind, n in entries.items():
                by_kind.setdefault(kind, {"hits": 0, "misses": 0,
                                          "entries": n})
            return {"entries": len(self._store), "hits": self.hits,
                    "misses": self.misses, "by_kind": by_kind}

    def kind_stats(self, kind: str) -> Dict[str, int]:
        """One kind's ``{hits, misses, entries}``; zeros for a kind never
        touched."""
        return self.stats()["by_kind"].get(
            kind, {"hits": 0, "misses": 0, "entries": 0})

    def kinds(self) -> Dict[str, int]:
        """Entry count per artifact kind."""
        with self._lock:
            self._prune()
            out: Dict[str, int] = {}
            for _, kind, _ in self._store:
                out[kind] = out.get(kind, 0) + 1
            return out

    def __len__(self) -> int:
        with self._lock:
            self._prune()
            return len(self._store)


#: The process-wide cache :class:`~repro_torch.core.executor.EdgeContext`
#: uses.
PLAN_CACHE = PlanCache()
