"""Persistent checkpoints: spill :class:`CheckpointRing` boundaries to disk.

Counterpart of ``repro.core.durability``, with the reference's on-disk
format byte for byte, so that either package reads the other's files.
One file per checkpoint generation, ``ckpt-<seq>.rck``::

    magic   8 bytes   b"RPCKPT1\\n"
    version u32 LE    format version (current: 1)
    length  u64 LE    payload byte count
    digest  32 bytes  SHA-256 of the payload
    payload           npz archive: "__meta__" JSON (iteration, done flag,
                      run fingerprint, buffer presence) + one entry per
                      state leaf / trace buffer

A truncated file fails the length check, a flipped byte the digest, and
a directory of another run (program, config, graph content, generator
state, limit or segment length) the fingerprint; each is rejected at
load with a structured :class:`~repro_torch.core.resilience.
ExecutionFault` (``"corrupt_checkpoint"`` / ``"checkpoint_mismatch"``),
and recovery falls back generation by generation, to a cold restart at
worst.  Writes go to a ``.tmp-`` sibling, are fsynced and published with
``os.replace``, so a kill mid-write loses only that generation.  Pruning
keeps ``keep`` generations and always the oldest (the cold-restart
floor) and the newest (the resume point).

The run fingerprint's :func:`graph_fingerprint` and the key's
serialization (:func:`_serialize_key`, :func:`_deserialize_key`) are the
port's copies of ``launch/journal.py:71-107``; the port's key is a
``torch.Generator``, serialized by its state.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.resilience import (DEFAULT_RING_CAPACITY, Checkpoint,
                                         ExecutionFault)

__all__ = ["CheckpointStore", "CHECKPOINT_MAGIC", "CHECKPOINT_VERSION",
           "graph_fingerprint"]

CHECKPOINT_MAGIC = b"RPCKPT1\n"
CHECKPOINT_VERSION = 1
_HEADER = struct.Struct("<8sIQ32s")  # magic, version, payload_len, sha256

#: Graph array fields hashed by :func:`graph_fingerprint`, in the order
#: that defines the digest (``launch/journal.py:62-67``), then the statics.
_GRAPH_ARRAYS = ("src", "dst", "weight", "row_ptr_out", "src_in", "dst_in",
                 "weight_in", "row_ptr_in", "out_degree", "in_degree",
                 "perm_owned", "block_ptr")
_GRAPH_STATICS = ("n_nodes", "n_edges", "block_size")


def graph_fingerprint(graph) -> str:
    """Content SHA-256 over every array (values, dtype, shape) and static
    field (``launch/journal.py:71-84``).  Arrays on a device are hashed
    from host copies, so a graph gives the reference's digest wherever
    it lives."""
    h = hashlib.sha256()
    for name in _GRAPH_ARRAYS:
        a = getattr(graph, name)
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    for name in _GRAPH_STATICS:
        h.update(f"{name}={getattr(graph, name)}".encode())
    return h.hexdigest()


def _serialize_key(key) -> Optional[dict]:
    """A run's ``torch.Generator`` as JSON: its state, taken before
    ``program.init`` draws from it (None for no key)."""
    if key is None:
        return None
    if not isinstance(key, torch.Generator):
        raise TypeError(f"key must be a torch.Generator, got "
                        f"{type(key).__name__}")
    return {"generator": key.device.type,
            "state": key.get_state().numpy().tobytes().hex()}


def _deserialize_key(rec: Optional[dict]) -> Optional[torch.Generator]:
    """The ``torch.Generator`` that :func:`_serialize_key` recorded, in the
    state it had then (``launch/journal.py:104``); None for None.  A
    record of the reference's JAX key (``dtype``/``data``) raises
    ``ValueError``: ``jax.random`` has no torch counterpart."""
    if rec is None:
        return None
    if "generator" not in rec:
        raise ValueError("a JAX PRNG key record cannot be rebuilt as a "
                         f"torch.Generator: {sorted(rec)}")
    key = torch.Generator(device=rec["generator"])
    key.set_state(torch.frombuffer(bytearray.fromhex(rec["state"]),
                                   dtype=torch.uint8))
    return key


def _encode_payload(cp: Checkpoint, fingerprint: Optional[dict]) -> bytes:
    """Serialize one checkpoint into the npz payload (host numpy only)."""
    if not isinstance(cp.state, dict):
        raise ValueError("CheckpointStore persists dict state pytrees; "
                         f"got {type(cp.state).__name__}")
    meta = {
        "it": int(cp.it),
        "done": bool(cp.done),
        "fingerprint": fingerprint,
        "state_keys": sorted(cp.state),
        "has_dir": cp.dir_buf is not None,
        "has_occ": cp.occ_buf is not None,
    }
    arrays: Dict[str, np.ndarray] = {
        "__meta__": np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), np.uint8),
    }
    for k in meta["state_keys"]:
        arrays[f"state:{k}"] = np.asarray(cp.state[k])
    if cp.dir_buf is not None:
        arrays["dir_buf"] = np.asarray(cp.dir_buf)
    if cp.occ_buf is not None:
        arrays["occ_buf"] = np.asarray(cp.occ_buf)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode_payload(payload: bytes) -> Tuple[Checkpoint, Optional[dict]]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        state = {k: z[f"state:{k}"].copy() for k in meta["state_keys"]}
        dir_buf = z["dir_buf"].copy() if meta["has_dir"] else None
        occ_buf = z["occ_buf"].copy() if meta["has_occ"] else None
    cp = Checkpoint(it=int(meta["it"]), done=bool(meta["done"]),
                    state=state, dir_buf=dir_buf, occ_buf=occ_buf)
    return cp, meta.get("fingerprint")


class CheckpointStore:
    """Durable, self-verifying checkpoint generations under one directory.

    ``fingerprint`` identifies the run the checkpoints belong to (the
    resilience layer passes program name, config name, graph shape, a
    content SHA-256 over every graph array, and the serialized PRNG
    key — so a same-shape graph with different edges/weights, or a
    rerun under a different key, never matches); a generation written
    under a different fingerprint is rejected at load with
    ``code="checkpoint_mismatch"`` — a reused directory can therefore
    never resume the wrong run.  ``keep`` bounds how many generations
    stay on disk: the oldest (initial) generation is pinned as the
    cold-restart floor and the newest is always retained as the resume
    point (even with ``keep=1``), the rest rotate out.
    """

    def __init__(self, root, keep: int = DEFAULT_RING_CAPACITY,
                 fingerprint: Optional[dict] = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self.fingerprint = fingerprint
        existing = self.generations()
        self._seq = (self._gen_seq(existing[0]) + 1) if existing else 0

    # -- write ----------------------------------------------------------
    def save(self, cp: Checkpoint) -> Path:
        """Persist one checkpoint atomically; returns its final path.

        The payload is fully written and fsynced under a ``.tmp-`` name
        before ``os.replace`` publishes it — readers (including a
        recovery racing this writer's death) only ever see complete
        generations or none.
        """
        payload = _encode_payload(cp, self.fingerprint)
        header = _HEADER.pack(CHECKPOINT_MAGIC, CHECKPOINT_VERSION,
                              len(payload), hashlib.sha256(payload).digest())
        final = self.root / f"ckpt-{self._seq:08d}.rck"
        tmp = self.root / f".tmp-{final.name}"
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self._seq += 1
        self._prune()
        return final

    def _prune(self) -> None:
        gens = self.generations()          # newest first
        if len(gens) <= self.keep:
            return
        # the newest generation (the resume point — possibly the file
        # just saved) and the oldest (the initial cold-restart floor)
        # are both unconditionally retained: with keep=1 this store
        # holds two files rather than deleting the checkpoint it just
        # wrote and degrading every resume to a cold restart
        pinned = {gens[0], gens[-1]}
        for path in gens[self.keep - 1:]:
            if path not in pinned:
                path.unlink(missing_ok=True)

    # -- read -----------------------------------------------------------
    @staticmethod
    def _gen_seq(path: Path) -> int:
        return int(path.stem.split("-")[1])

    def generations(self) -> List[Path]:
        """Published generation files, newest first."""
        return sorted(self.root.glob("ckpt-*.rck"),
                      key=self._gen_seq, reverse=True)

    def load(self, path) -> Checkpoint:
        """Load and verify one generation.

        Raises :class:`ExecutionFault` with ``code="corrupt_checkpoint"``
        for any integrity failure (short header, bad magic/version,
        truncated payload, digest mismatch, undecodable payload) and
        ``code="checkpoint_mismatch"`` when the file is intact but
        belongs to a different run fingerprint.
        """
        path = Path(path)
        raw = path.read_bytes()
        if len(raw) < _HEADER.size:
            raise ExecutionFault("corrupt_checkpoint", {
                "path": str(path), "reason": "short_header",
                "bytes": len(raw)})
        magic, version, length, digest = _HEADER.unpack_from(raw)
        if magic != CHECKPOINT_MAGIC:
            raise ExecutionFault("corrupt_checkpoint", {
                "path": str(path), "reason": "bad_magic"})
        if version != CHECKPOINT_VERSION:
            raise ExecutionFault("corrupt_checkpoint", {
                "path": str(path), "reason": "unknown_version",
                "version": int(version)})
        payload = raw[_HEADER.size:]
        if len(payload) != length:
            raise ExecutionFault("corrupt_checkpoint", {
                "path": str(path), "reason": "truncated",
                "expected_bytes": int(length), "got_bytes": len(payload)})
        if hashlib.sha256(payload).digest() != digest:
            raise ExecutionFault("corrupt_checkpoint", {
                "path": str(path), "reason": "checksum_mismatch"})
        try:
            cp, fp = _decode_payload(payload)
        except Exception as err:
            raise ExecutionFault("corrupt_checkpoint", {
                "path": str(path), "reason": "undecodable",
                "error": repr(err)}) from err
        if self.fingerprint is not None and fp != self.fingerprint:
            raise ExecutionFault("checkpoint_mismatch", {
                "path": str(path), "expected": self.fingerprint,
                "found": fp})
        return cp

    def load_all(self) -> Tuple[List[Checkpoint], List[dict]]:
        """Every intact generation oldest-first, plus structured fault
        records for the ones that were rejected.

        This is the resume path: the caller seeds a fresh in-memory ring
        with the surviving boundaries (so post-restart retry rollback
        has the same depth an uninterrupted run would) and appends the
        fault records to the run's fault history.  An empty first list
        means cold restart.
        """
        good: List[Checkpoint] = []
        faults: List[dict] = []
        for path in reversed(self.generations()):   # oldest first
            try:
                good.append(self.load(path))
            except ExecutionFault as err:
                faults.append({"kind": err.code, **err.detail})
        return good, faults

    def load_latest(self) -> Tuple[Optional[Checkpoint], List[dict]]:
        """The newest intact generation (or None), plus fault records
        for every newer generation that had to be rejected first."""
        faults: List[dict] = []
        for path in self.generations():             # newest first
            try:
                return self.load(path), faults
            except ExecutionFault as err:
                faults.append({"kind": err.code, **err.detail})
        return None, faults

    def clear(self) -> None:
        """Remove every generation (including stale tmp files)."""
        for path in self.root.glob("ckpt-*.rck"):
            path.unlink(missing_ok=True)
        for path in self.root.glob(".tmp-*"):
            path.unlink(missing_ok=True)
        self._seq = 0

    def __len__(self) -> int:
        return len(self.generations())
