"""Build and load the port's CUDA sources.

Every kernel package keeps its CUDA C++ under ``csrc/``, with a plain C
interface.  :func:`build` compiles one source with ``nvcc`` for
``sm_90a`` into ``build/kernels/<stem>-<sha16>.so`` at the root of the
checkout, keyed on the source's hash, so a changed source is rebuilt and
an unchanged one is built once.  :func:`load` opens the library with
``ctypes``.  Nothing is built when a module is imported: the wrappers
call :func:`load` at their first launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless its library is already built.

    Returns the library's path and the compiler's report (registers and
    shared memory per kernel; empty when the library was already there).
    Raises ``RuntimeError`` when ``nvcc`` is missing or fails.
    """
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found: the CUDA kernels of "
                           f"{source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} with code "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, opened once per process."""
    return ctypes.CDLL(str(build(source)[0]))
