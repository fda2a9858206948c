"""Atomic checkpointing of parameters and optimizer state (counterpart
of ``repro.train.checkpoint``), in the reference's layout::

    <dir>/step_<N>/
        manifest.json   step, leaf paths, shapes, dtypes, extra
        shard_0.npz     the leaves as ``leaf_<i>``

A save fills a temporary directory, fsyncs it, then renames it into
place, and a ``latest`` symlink flips last, so a crash never leaves a
partial ``step_<N>`` visible.  :class:`AsyncCheckpointer` copies the
leaves to the host, then writes them on a thread, one save in flight.

A tree is a nesting of mappings, lists, tuples and ``nn.Module``\\ s
over tensors or numpy arrays.  A leaf's path is its keys joined by
``/``, a module contributing its own ``state_dict`` names (``(model,
opt_state)`` gives ``0/blocks.0.attn.wq.w``, ``1/mu/table_3``,
``1/step``).  numpy has no bfloat16 (and the card's machine has no
``ml_dtypes``), so a bf16 leaf is stored as its raw 16-bit words with
``"bfloat16"`` in the manifest, and restored bit for bit.  A restore
checks the paths and shapes against the tree it fills and raises
``ValueError`` on any difference; it never fills leaves by position
alone.  Resharding on restore comes with the sharding pieces.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order."""
    if isinstance(tree, nn.Module):
        return [(prefix + name, t)
                for name, t in tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}{i}/")
        return out
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return [(prefix.rstrip("/"), tree)]
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__} at "
                    f"{prefix.rstrip('/') or 'the root'}")


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (never a view of it) and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).to("cpu", copy=True).numpy()
            return words.view(np.uint16), _BF16
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _to_host(tree) -> Tuple[List[str], List[np.ndarray], List[str]]:
    pairs = _flatten(tree)
    paths = [p for p, _ in pairs]
    if len(set(paths)) != len(paths):
        raise ValueError("checkpoint: two leaves share a path")
    hosted = [_host(leaf) for _, leaf in pairs]
    return paths, [a for a, _ in hosted], [d for _, d in hosted]


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(directory: Path, step: int, paths, arrays, dtypes,
           extra: Optional[dict]) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "shard_0.npz",
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": int(step),
        "n_leaves": len(arrays),
        "leaves": [{"path": p, "shape": list(a.shape), "dtype": d}
                   for p, a, d in zip(paths, arrays, dtypes)],
        "format": 1,
        "extra": extra or {},
    }
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=2))
    for name in ("shard_0.npz", _MANIFEST):
        _fsync(tmp / name)
    _fsync(tmp)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest = directory / "latest"
    tmp_link = directory / ".latest_tmp"
    if tmp_link.exists() or tmp_link.is_symlink():
        tmp_link.unlink()
    tmp_link.symlink_to(final.name)
    os.replace(tmp_link, latest)
    _fsync(directory)
    return final


def save_checkpoint(directory: str | os.PathLike, step: int, tree: Any,
                    extra: Optional[dict] = None) -> Path:
    """Write ``tree`` as ``<directory>/step_<step>``; returns that path."""
    return _write(Path(directory), step, *_to_host(tree), extra)


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    """The highest step saved under ``directory``, or None."""
    directory = Path(directory)
    steps = sorted(int(p.name.split("_")[1])
                   for p in directory.glob("step_*") if p.is_dir())
    return steps[-1] if steps else None


def _from_words(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy(order="C")
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _fill(tree: Any, values) -> Any:
    """``tree`` with its leaves taken in order from ``values``: tensors
    (and a module's) are written in place, numpy leaves replaced."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in tree.state_dict(keep_vars=True).values():
                t.copy_(next(values))
        return tree
    if isinstance(tree, Mapping):
        return {k: _fill(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, values) for v in tree)
    value = next(values)
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            tree.copy_(value)
        return tree
    return value.numpy().astype(np.asarray(tree).dtype)


def restore_checkpoint(directory: str | os.PathLike, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int, dict]:
    """Fill ``tree_like`` from the checkpoint of ``step`` (default: the
    latest): returns ``(tree, step, extra)``, where ``tree`` holds
    ``tree_like``'s own tensors, now holding the saved values.  Raises
    ``FileNotFoundError`` without a checkpoint and ``ValueError`` when
    the saved leaves' paths or shapes are not ``tree_like``'s."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    pairs = _flatten(tree_like)
    saved = manifest["leaves"]
    if len(saved) != len(pairs):
        raise ValueError(f"checkpoint has {len(saved)} leaves, expected "
                         f"{len(pairs)}")
    for meta, (path, leaf) in zip(saved, pairs):
        if meta["path"] != path:
            raise ValueError(f"checkpoint leaf {meta['path']!r} where "
                             f"{path!r} is expected")
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else np.shape(leaf)
        if tuple(meta["shape"]) != shape:
            raise ValueError(f"checkpoint leaf {path!r} has shape "
                             f"{tuple(meta['shape'])}, expected {shape}")
    with np.load(d / "shard_0.npz") as z:
        arrays = [_from_words(z[f"leaf_{i}"], meta["dtype"])
                  for i, meta in enumerate(saved)]
    return _fill(tree_like, iter(arrays)), step, manifest.get("extra", {})


class AsyncCheckpointer:
    """One background writer thread; ``save`` copies the leaves to the
    host and returns, and the next save (or ``wait``) blocks until the
    previous one has landed.  A writer's error raises at the next
    ``save`` or ``wait``."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = Path(directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        hosted = _to_host(tree)

        def work():
            try:
                _write(self.directory, step, *hosted, extra)
            except BaseException as exc:  # raised by the next wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
