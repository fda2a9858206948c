"""Build and load the port's CUDA sources.

Every kernel package keeps its CUDA C++ under ``csrc/``, with a plain C
interface.  :func:`build` compiles one source with ``nvcc`` for
``sm_90a`` into ``build/kernels/<stem>-<sha16>.so`` at the root of the
checkout.  The name is keyed (:func:`build_key`) on the source, on every
local header it includes (``#include "..."``, followed recursively), and
on ``NVCC_FLAGS``, so a library built from other code or with other
flags is never loaded, and an unchanged one is built once.  No source
takes flags of its own: the attention kernel reaches the driver's
``cuTensorMapEncodeTiled`` at run time, so nothing links ``-lcuda``.
:func:`load` opens the library with ``ctypes``.  Nothing is built when a
module is imported: the wrappers call :func:`load` at their first
launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "KernelBuildError", "build",
           "build_key", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """A kernel library that could not be built or opened.  Callers that
    contain execution faults (the gateway's slices) let it through: a
    missing kernel is not a fault of one request."""


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _local_files(source: Path) -> List[Path]:
    """``source`` and every header it includes with quotes, recursively,
    in the order first met."""
    seen, todo = [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / name.decode()).resolve()
            if not header.exists():
                raise FileNotFoundError(f"{path.name} includes {header}, "
                                        f"which does not exist")
            todo.append(header)
    return seen


def build_key(source: Path) -> str:
    """The 16 hex digits that name ``source``'s library: a hash of the
    source, of its local headers (:func:`_local_files`) and of
    ``NVCC_FLAGS``."""
    h = hashlib.sha256()
    for path in _local_files(Path(source)):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless its library is already built.

    Returns the library's path and the compiler's report (registers and
    shared memory per kernel; empty when the library was already there).
    Raises :class:`KernelBuildError` when ``nvcc`` is missing or fails.
    """
    source = Path(source)
    lib = BUILD_DIR / f"{source.stem}-{build_key(source)}.so"
    if lib.exists():
        return lib, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise KernelBuildError(f"nvcc not found: the CUDA kernels of "
                               f"{source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on {source.name} with code "
            f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, opened once per process."""
    path = build(source)[0]
    try:
        return ctypes.CDLL(str(path))
    except OSError as err:
        raise KernelBuildError(f"cannot open {path.name}: {err}") from err
