"""Embedding-bag gather and pool on the GPU (counterpart of
``repro.kernels.embedding_bag.kernel``).

:func:`embag` launches the hand-written CUDA kernel of
``csrc/embedding_bag.cu``, which replaces ``embedding_bag_pallas``
(``kernel.py:55-86``): for every bag, gather its P rows of a table in
device memory and sum them or take their mean.  One warp pools one bag;
no padding of the batch is needed, so the output is exactly ``[B, D]``.

Its plain PyTorch version is the oracle
:func:`~repro_torch.kernels.embedding_bag.ref.embedding_bag_ref` (bit-equal
at P = 1; to float rounding of the sum's order for P > 1).  The wrapper
runs the plain version only for a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
It counts its launches in ``embag.launches``.  The kernel is built at
first use (:mod:`repro_torch.kernels._build`) and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load
from repro_torch.kernels.embedding_bag.ref import MODES, embedding_bag_ref

__all__ = ["embag", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.embag_f32.argtypes = [p, p, p, ll, i, i, i, ll, i, p]
    lib.embag_f32.restype = ctypes.c_int
    return lib


def _check(table: torch.Tensor, indices: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"embag: mode must be one of {MODES}, got {mode!r}")
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


def embag(table: torch.Tensor, indices: torch.Tensor, *,
          mode: str = "sum") -> torch.Tensor:
    """Pool the rows ``table[indices[b, p]]`` over p for every bag b:
    table [R, D] float32, indices [B, P] int32 -> [B, D].

    Indices follow ``jnp.take``: ``[-R, 0)`` wraps; ``>= R`` or ``< -R``
    gives a NaN row.  The sum runs over p in order in float32; ``mean``
    divides it by P.  ``indices`` may be a strided view (a column of a
    ``[B, F, P]`` batch) as long as its last dimension is contiguous.
    """
    _check(table, indices, mode)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, indices, mode=mode)
    if table.device.type != "cuda":
        raise ValueError(f"embag: no kernel for device {table.device}")
    bags, pool = indices.shape
    if pool > 1 and indices.stride(1) != 1:
        indices = indices.contiguous()
    out = torch.empty((bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if bags == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _library().embag_f32(
            table.data_ptr(), indices.data_ptr(), out.data_ptr(),
            table.shape[0], table.shape[1], bags, pool, indices.stride(0),
            int(mode == "mean"), stream)
    if err != 0:
        raise RuntimeError(f"embag: kernel launch failed with CUDA error "
                           f"{err}")
    embag.launches += 1
    return out


embag.launches = 0
