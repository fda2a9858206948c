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

    def get(self, graph: Any, kind: str, params: Hashable,
            build: Callable[[], Any]) -> Any:
        """Return the cached artifact, building and caching it on a miss.

        ``params`` must capture everything ``build`` depends on besides
        the graph itself.
        """
        key = (id(graph), kind, params)
        with self._lock:
            self._prune()
            if key in self._store:
                self.hits += 1
                return self._store[key]
            self.misses += 1
            self._watch(graph)
        # build outside the lock: builders recurse into the cache
        value = build()
        with self._lock:
            return self._store.setdefault(key, value)

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
        """Drop every entry and reset the counters."""
        with self._lock:
            for fin in self._finalizers.values():
                fin.detach()
            self._finalizers.clear()
            self._store.clear()
            self._dead.clear()
            self.hits = 0
            self.misses = 0

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
