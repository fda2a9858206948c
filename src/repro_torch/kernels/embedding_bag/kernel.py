"""Embedding-bag gather and pool on the GPU (counterpart of
``repro.kernels.embedding_bag.kernel``).

:func:`embag_tables` launches the hand-written CUDA kernel of
``csrc/embedding_bag.cu``, which replaces ``embedding_bag_pallas``
(``kernel.py:55-86``): for every bag of every table, gather its P rows
and sum them or take their mean.  All the tables of a call (at most
:data:`MAX_TABLES`, every one ``[R_f, D]``) are pooled in one launch,
into an output with any bag and table strides, so DLRM writes its 26
pooled features straight into the interaction's input.  :func:`embag`,
the single-table counterpart of ``embedding_bag_pallas``, is the same
kernel with one table.

Their plain PyTorch versions are the oracles of ``ref.py`` (bit-equal at
P = 1; to float rounding of the sum's order for P > 1).  The wrappers
run the plain version only for tensors on the CPU; for a CUDA tensor
they launch the kernel or raise.  The kernel has no backward, and
``embag_tables`` writes into a buffer behind autograd's back: under grad
mode, with a table that requires grad, both raise rather than leave the
tables without a gradient; training pools through the plain versions,
which keep autograd.  Both count their launches in ``embag.launches``.
The kernel is built at first use (:mod:`repro_torch.kernels._build`)
and bound with ``ctypes``.

A call checks its tables once: what it learned (row counts, width,
device, the ``ctypes`` arrays of pointers and rows) is kept under the
tables' identities, with weak references, and used again only while the
same tensor objects hold the same data pointers (so a table freed, or
given new storage, is checked again).  A DLRM forward thus pays a few
microseconds of host work for its 26 tables, where checking each and
building the arrays anew took about 47 us on a CPU core.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._build import load
from repro_torch.kernels.embedding_bag.ref import (MODES, embedding_bag_ref,
                                                   embedding_bags_ref)

__all__ = ["embag", "embag_tables", "MAX_TABLES", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"

#: Tables one launch takes (``kMaxTables`` of the source)
MAX_TABLES = 64


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.embag_tables_f32.argtypes = [p, p, i, p, ll, ll, p, ll, ll, ll, i, i,
                                     i, i, i, p]
    lib.embag_tables_f32.restype = ctypes.c_int
    lib.embag_max_tables.argtypes = []
    lib.embag_max_tables.restype = ctypes.c_int
    return lib


class _Tables(NamedTuple):
    """What one check of a sequence of tables found."""
    refs: Tuple[weakref.ref, ...]
    ptrs: Tuple[int, ...]
    rows: Tuple[int, ...]
    d: int
    device: torch.device
    c_ptrs: ctypes.Array
    c_rows: ctypes.Array


_CHECKED: dict = {}


def _tables(tables: Sequence[torch.Tensor], name: str) -> _Tables:
    """Check ``tables`` (contiguous float32 ``[R_f, D]``, one D, one
    device, at most MAX_TABLES), or find them checked before."""
    key = tuple(map(id, tables))
    hit = _CHECKED.get(key)
    if (hit is not None and all(r() is t for r, t in zip(hit.refs, tables))
            and tuple(map(torch.Tensor.data_ptr, tables)) == hit.ptrs):
        return hit
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"{name}: takes 1 to {MAX_TABLES} tables, got "
                         f"{len(tables)}")
    first = tables[0]
    for t in tables:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.dim() != 2:
            raise TypeError(f"{name}: every table must be a 2-D float32 "
                            f"tensor, got {getattr(t, 'dtype', type(t))} "
                            f"{tuple(getattr(t, 'shape', ()))}")
        if t.shape[1] != first.shape[1]:
            raise ValueError(f"{name}: tables of different widths "
                             f"{first.shape[1]} and {t.shape[1]}")
        if t.device != first.device:
            raise ValueError(f"{name}: tables on {first.device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every table must be contiguous")
    ptrs = tuple(t.data_ptr() for t in tables)
    rows = tuple(t.shape[0] for t in tables)
    n = len(tables)
    checked = _Tables(tuple(map(weakref.ref, tables)), ptrs, rows,
                      first.shape[1], first.device,
                      (ctypes.c_void_p * n)(*ptrs),
                      (ctypes.c_longlong * n)(*rows))
    if len(_CHECKED) >= 64:
        _CHECKED.clear()
    _CHECKED[key] = checked
    return checked


def _launch(tabs: _Tables, indices: torch.Tensor, out: torch.Tensor,
            mean: bool, idx_strides, out_strides,
            launch: Optional[Tuple[int, int]]) -> None:
    bags, pool = indices.shape[0], indices.shape[-1]
    items_per_warp, threads = launch or (0, 0)  # 0: the call chooses
    device = tabs.device
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (tabs.c_ptrs, tabs.c_rows, len(tabs.ptrs), indices.data_ptr(),
            *idx_strides, out.data_ptr(), *out_strides, bags, pool, tabs.d,
            int(mean), items_per_warp, threads, stream)
    with torch.cuda.device(device):
        err = _library().embag_tables_f32(*args)
    if err != 0:
        raise RuntimeError(f"embag: kernel launch failed with CUDA error "
                           f"{err}")
    embag.launches += 1


def _check_mode(mode: str, name: str) -> None:
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be one of {MODES}, got {mode!r}")


def _check_no_grad(tables: Sequence[torch.Tensor], name: str) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        raise NotImplementedError(
            f"{name} has no backward: call it under torch.no_grad()/"
            "inference_mode, or train through the plain embedding bag "
            "(impl='plain')")


def embag_tables(tables: Sequence[torch.Tensor], indices: torch.Tensor, *,
                 mode: str = "sum", out: Optional[torch.Tensor] = None,
                 launch: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Pool ``tables[f][indices[b, f, p]]`` over p for every bag b of
    every table f, in one launch: F tables float32 ``[R_f, D]``, indices
    ``[B, F, P]`` int32 with the last dimension contiguous -> ``out``
    ``[B, F, D]`` float32 (allocated when None; any bag and table
    strides, the last dimension contiguous), which is returned.

    Indices follow ``jnp.take`` against each table's own row count:
    ``[-R_f, 0)`` wraps; ``>= R_f`` or ``< -R_f`` gives a NaN row.  The
    sum runs over p in order in float32; ``mean`` divides it by P.
    ``launch``, (items per warp in {1, 2, 4}, threads per CTA), only
    shapes the launch, for measuring it; None, the default, lets the
    kernel's entry point choose from B, F and P.
    """
    _check_mode(mode, "embag_tables")
    _check_no_grad(tables, "embag_tables")
    tabs = _tables(tables, "embag_tables")
    if indices.dtype != torch.int32 or indices.dim() != 3:
        raise TypeError("embag_tables: indices must be a 3-D int32 tensor "
                        f"[B, F, P], got {indices.dtype} "
                        f"{tuple(indices.shape)}")
    bags, n_tables, pool = indices.shape
    if n_tables != len(tabs.ptrs):
        raise ValueError(f"embag_tables: indices name {n_tables} tables, "
                         f"{len(tabs.ptrs)} given")
    if pool == 0:
        raise ValueError("embag_tables: a bag needs at least one index")
    if pool > 1 and indices.stride(2) != 1:
        raise ValueError("embag_tables: the indices of a bag must be "
                         "contiguous")
    if indices.device != tabs.device:
        raise ValueError(f"embag_tables: indices are on {indices.device}, "
                         f"the tables on {tabs.device}")
    shape = (bags, n_tables, tabs.d)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=tabs.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.device != tabs.device
          or (tabs.d > 1 and out.stride(2) != 1)):
        raise ValueError(f"embag_tables: out must be float32 {shape} on "
                         f"{tabs.device} with its last dimension "
                         f"contiguous, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")
    if tabs.device.type == "cpu":
        return embedding_bags_ref(tables, indices, mode=mode, out=out)
    if tabs.device.type != "cuda":
        raise ValueError(f"embag_tables: no kernel for device {tabs.device}")
    if bags:
        _launch(tabs, indices, out, mode == "mean",
                (indices.stride(0), indices.stride(1)),
                (out.stride(0), out.stride(1)), launch)
    return out


def embag(table: torch.Tensor, indices: torch.Tensor, *,
          mode: str = "sum") -> torch.Tensor:
    """Pool the rows ``table[indices[b, p]]`` over p for every bag b:
    table [R, D] float32, indices [B, P] int32 -> [B, D].  The case F = 1
    of :func:`embag_tables`, on the same kernel.

    Indices follow ``jnp.take``: ``[-R, 0)`` wraps; ``>= R`` or ``< -R``
    gives a NaN row.  The sum runs over p in order in float32; ``mean``
    divides it by P.  ``indices`` may be a strided view (a column of a
    ``[B, F, P]`` batch) as long as its last dimension is contiguous.
    """
    _check_mode(mode, "embag")
    _check_no_grad((table,), "embag")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError("embag: table must be a 2-D float32 tensor, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if indices.dtype != torch.int32 or indices.dim() != 2:
        raise TypeError("embag: indices must be a 2-D int32 tensor [B, P], "
                        f"got {indices.dtype} {tuple(indices.shape)}")
    if indices.device != table.device:
        raise ValueError(f"embag: indices are on {indices.device}, the "
                         f"table on {table.device}")
    if not table.is_contiguous():
        raise ValueError("embag: table must be contiguous")
    if indices.shape[1] == 0:
        raise ValueError("embag: a bag needs at least one index")
    if table.device.type == "cpu":
        return embedding_bag_ref(table, indices, mode=mode)
    if table.device.type != "cuda":
        raise ValueError(f"embag: no kernel for device {table.device}")
    bags, pool = indices.shape
    if pool > 1 and indices.stride(1) != 1:
        indices = indices.contiguous()
    out = torch.empty((bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if bags:
        _launch(_tables((table,), "embag"), indices, out, mode == "mean",
                (indices.stride(0), 0), (out.stride(0), 0), None)
    return out


embag.launches = 0
