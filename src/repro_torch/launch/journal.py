"""Write-ahead admission journal for the serving gateway.

Counterpart of ``repro.launch.journal`` (``journal.py:110-264``), with
the reference's on-disk layout, so that a journal moves between the two
packages.  Every admission-lifecycle transition is appended **before**
the in-memory step it describes completes, so
:meth:`~repro_torch.launch.serve.ContinuousScheduler.recover` can rebuild
the unfinished tickets of a killed gateway and re-admit each from its
newest persisted slice boundary, bit-identical to the uninterrupted
gateway.

Layout under ``journal_dir``::

    journal.waj          append-only JSONL, one record per line:
                         ``<crc32 hex> <json body>``
    graphs/<fp>.npz      each distinct submitted graph, persisted once
                         verbatim (every array of ``ARRAY_FIELDS`` bit for
                         bit, keyed by :func:`graph_fingerprint`)
    tickets/<jid>/       a per-ticket :class:`~repro_torch.core.durability.
                         CheckpointStore` holding its slice-boundary states

Records (each carries ``jid``, the journal-scoped ticket id):
``submit`` (program and config names, graph fingerprint, knobs,
``max_iters``, ``deadline_s``, serialized key), ``admit``, ``commit``
(iteration, the ticket's cumulative direction and occupancy traces and
committed slices; the state goes to the checkpoint store, matched to its
record by iteration) and ``retire`` (outcome; the ticket's store is
deleted).  The knobs keep the reference's names: the port's
``use_kernels`` is written as ``"use_pallas"``.

Each line's CRC makes a torn write self-describing: replay skips it (and
any interior corruption) and counts it.  Replay appends nothing, so
recovering twice from one journal is idempotent.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.durability import (CheckpointStore, _serialize_key,
                                         graph_fingerprint)
from repro_torch.core.resilience import Checkpoint
from repro_torch.graph.structure import ARRAY_FIELDS, Graph

__all__ = ["WriteAheadJournal", "JOURNAL_FILE", "graph_fingerprint"]

JOURNAL_FILE = "journal.waj"

#: Graph array fields persisted verbatim, in the reference's
#: ``_GRAPH_ARRAYS`` order, plus the static ints.
_GRAPH_ARRAYS = ARRAY_FIELDS
_GRAPH_STATICS = ("n_nodes", "n_edges", "block_size")


class WriteAheadJournal:
    """Append-only gateway journal plus its graph and checkpoint stores.

    One instance is owned by a scheduler; :meth:`replay` is the read
    side used by recovery (it never writes).
    """

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "graphs").mkdir(exist_ok=True)
        (self.root / "tickets").mkdir(exist_ok=True)
        self.path = self.root / JOURNAL_FILE
        self.torn_lines = 0
        self._graph_cache: Dict[str, Graph] = {}
        records, _ = self.replay()
        self._next_jid = 1 + max(
            (int(j.split("-")[1]) for j in records), default=-1)

    # -- write side ------------------------------------------------------
    def _append(self, body: Dict[str, Any]) -> None:
        line = json.dumps(body, sort_keys=True)
        crc = zlib.crc32(line.encode()) & 0xFFFFFFFF
        with open(self.path, "a") as f:
            f.write(f"{crc:08x} {line}\n")
            f.flush()
            os.fsync(f.fileno())

    def record_submit(self, program, graph: Graph, config, *, key,
                      max_iters, deadline_s, knobs: Dict[str, Any]) -> str:
        """Persist the graph (once) and append the submit record;
        returns the journal-scoped ticket id."""
        jid = f"jid-{self._next_jid:08d}"
        self._next_jid += 1
        self._append({
            "type": "submit", "jid": jid,
            "program": program.name, "config": config.name,
            "graph": self.persist_graph(graph),
            "key": _serialize_key(key),
            "max_iters": max_iters, "deadline_s": deadline_s,
            "knobs": dict(knobs),
        })
        return jid

    def record_admit(self, jid: str) -> None:
        self._append({"type": "admit", "jid": jid})

    def record_commit(self, jid: str, it: int, state,
                      dispatches: int, trace: Optional[str],
                      occs: Optional[List[float]]) -> None:
        """One committed slice boundary: the record first (so every
        persisted checkpoint has its trace metadata even if the process
        dies between the two writes), then the state into the ticket's
        checkpoint store."""
        self._append({"type": "commit", "jid": jid, "it": int(it),
                      "dispatches": int(dispatches), "trace": trace,
                      "occs": occs})
        self.store_for(jid).save(Checkpoint(
            it=int(it), done=False, state=state,
            dir_buf=None, occ_buf=None))

    def record_retire(self, jid: str, outcome: str) -> None:
        self._append({"type": "retire", "jid": jid, "outcome": outcome})
        shutil.rmtree(self.root / "tickets" / jid, ignore_errors=True)

    # -- graph persistence ----------------------------------------------
    def persist_graph(self, graph: Graph) -> str:
        fp = graph_fingerprint(graph)
        path = self.root / "graphs" / f"{fp}.npz"
        if not path.exists():
            arrays = {n: np.asarray(getattr(graph, n))
                      for n in _GRAPH_ARRAYS}
            arrays["__static__"] = np.array(
                [int(getattr(graph, n)) for n in _GRAPH_STATICS], np.int64)
            tmp = path.with_name(f".tmp-{path.name}")
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        self._graph_cache.setdefault(fp, graph)
        return fp

    def load_graph(self, fp: str) -> Graph:
        """Rebuild the persisted graph field by field, bit-identical to
        the submitted one.  Cached per fingerprint, so every replayed
        ticket over one graph shares one instance (lane packing and the
        plan cache key on graph identity)."""
        if fp in self._graph_cache:
            return self._graph_cache[fp]
        path = self.root / "graphs" / f"{fp}.npz"
        with np.load(path, allow_pickle=False) as z:
            statics = z["__static__"]
            graph = Graph(
                **{n: z[n].copy() for n in _GRAPH_ARRAYS},
                **{n: int(statics[i])
                   for i, n in enumerate(_GRAPH_STATICS)})
        self._graph_cache[fp] = graph
        return graph

    def store_for(self, jid: str) -> CheckpointStore:
        return CheckpointStore(self.root / "tickets" / jid,
                               fingerprint={"jid": jid})

    # -- read side -------------------------------------------------------
    def replay(self) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, int]]:
        """Fold the journal into per-ticket lifecycle state.

        Returns ``(tickets, report)``: ``tickets[jid]`` has the submit
        record under ``"submit"``, ``"admitted"``, the ordered
        ``"commits"`` and ``"retired"`` (outcome or None).  ``report``
        counts ``lines``, ``torn`` (bad CRC or partial line) and
        ``orphan`` (a record whose jid has no surviving submit).
        """
        tickets: Dict[str, Dict[str, Any]] = {}
        report = {"lines": 0, "torn": 0, "orphan": 0}
        if not self.path.exists():
            self.torn_lines = 0
            return tickets, report
        for raw in self.path.read_text().splitlines():
            report["lines"] += 1
            try:
                crc_hex, line = raw.split(" ", 1)
                if (zlib.crc32(line.encode()) & 0xFFFFFFFF) != int(
                        crc_hex, 16):
                    raise ValueError("crc mismatch")
                body = json.loads(line)
            except Exception:  # noqa: BLE001 — torn/corrupt line
                report["torn"] += 1
                continue
            jid = body.get("jid")
            if body["type"] == "submit":
                tickets[jid] = {"submit": body, "admitted": False,
                                "commits": [], "retired": None}
                continue
            if jid not in tickets:
                report["orphan"] += 1
                continue
            if body["type"] == "admit":
                tickets[jid]["admitted"] = True
            elif body["type"] == "commit":
                tickets[jid]["commits"].append(body)
            elif body["type"] == "retire":
                tickets[jid]["retired"] = body["outcome"]
        self.torn_lines = report["torn"]
        return tickets, report

    def unfinished(self) -> Dict[str, Dict[str, Any]]:
        """The replayed tickets that never retired, in submit order: the
        re-admission set of recovery."""
        tickets, _ = self.replay()
        return {jid: rec for jid, rec in tickets.items()
                if rec["retired"] is None}
