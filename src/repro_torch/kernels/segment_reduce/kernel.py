"""Blocked segment reduction: the DeNovo-coherence analogue on the GPU.

Counterpart of ``repro.kernels.segment_reduce.kernel``.  Edges arrive
binned by destination block (``block_ptr`` gives each block's edge
range).  Each output block of ``block_size`` segments is owned by one
CTA, accumulated in shared memory and written back once, against the
LLC analogue that resolves every update in device memory.

Two wrappers launch the hand-written CUDA kernels of
``csrc/segment_reduce.cu``:

- :func:`seg_sum` replaces ``seg_sum_pallas`` (``kernel.py:100-126``);
- :func:`seg_minmax` replaces ``seg_minmax_pallas`` (``:152-191``).

Beside each is its plain PyTorch version (:func:`seg_sum_plain`,
:func:`seg_minmax_plain`), which follows the TPU kernel's tiling plan
(:func:`plan_tiles`) step for step.  A wrapper runs the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel
or raises.  Each wrapper counts its launches in ``<wrapper>.launches``.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout, under a name keyed on
the source's hash (:mod:`repro_torch.kernels._build`), and bound with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels._build import load
from repro_torch.kernels.segment_reduce.ref import SCATTER_REDUCE, identity

__all__ = ["plan_tiles", "seg_sum", "seg_sum_plain", "seg_minmax",
           "seg_minmax_plain", "SOURCE", "SMEM_LIMIT"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu"
#: Shared memory a CTA may take without opting in to more: the kernels
#: hold a [block_size, D] accumulator of 4-byte words within it.
SMEM_LIMIT = 48 * 1024


def plan_tiles(block_ptr: np.ndarray, tile_e: int):
    """Host-side tiling plan over block-binned edges
    (``repro.kernels.segment_reduce.kernel:32-74``, copied exactly).

    Returns (gather_idx [n_tiles, tile_e] int32 into the binned edge
    order, -1 = padding; tile_block_id [n_tiles]; tile_first [n_tiles]).
    Every output block gets at least one tile so it is always
    initialised.  Tile *t* of block *b* gathers edges
    ``block_ptr[b] + t*tile_e ..``, clipped to the block's edge range.
    """
    block_ptr = np.asarray(block_ptr)
    if block_ptr.size and int(block_ptr[-1]) >= np.iinfo(np.int32).max:
        raise ValueError("plan_tiles: edge count exceeds int32 index range")
    block_ptr = block_ptr.astype(np.int32)
    n_blocks = block_ptr.shape[0] - 1
    counts = np.diff(block_ptr)
    # ceil(counts / tile_e), but empty blocks still get one (all-padding)
    # tile so their output block is initialised
    tiles_per_block = np.maximum(1, -(-counts // tile_e)).astype(np.int32)
    n_tiles = int(tiles_per_block.sum())
    tbid = np.repeat(np.arange(n_blocks, dtype=np.int32), tiles_per_block)
    first_tile = (np.cumsum(tiles_per_block, dtype=np.int32)
                  - tiles_per_block)
    tfirst = np.zeros(n_tiles, np.int32)
    tfirst[first_tile] = 1
    # within-block tile ordinal of every tile
    local = np.arange(n_tiles, dtype=np.int32) - first_tile[tbid]
    offs = (block_ptr[tbid][:, None]
            + local[:, None] * np.int32(tile_e)
            + np.arange(tile_e, dtype=np.int32)[None, :])
    gather = np.where(offs < block_ptr[tbid + 1][:, None], offs,
                      np.int32(-1))
    return (gather, tbid, tfirst)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.seg_sum_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.seg_sum_i32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.seg_minmax_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.seg_minmax_i32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.seg_sum_f32, lib.seg_sum_i32, lib.seg_minmax_f32,
               lib.seg_minmax_i32):
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check(name, values, segment_ids, block_ptr, block_size, num_segments,
           tile_e, dtypes) -> int:
    """Validate what the kernels take; returns the number of blocks."""
    if values.dtype not in dtypes:
        raise TypeError(f"{name}: values must be one of {dtypes}, "
                        f"got {values.dtype}")
    if values.dim() != 2:
        raise ValueError(f"{name}: values must be [E, D], got "
                         f"{tuple(values.shape)}")
    for what, t in (("segment_ids", segment_ids), ("block_ptr", block_ptr)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: {what} must be a 1-D int32 tensor")
        if t.device != values.device:
            raise ValueError(f"{name}: {what} is on {t.device}, values on "
                             f"{values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if not values.is_contiguous():
        raise ValueError(f"{name}: values must be contiguous")
    if segment_ids.shape[0] != values.shape[0]:
        raise ValueError(f"{name}: {segment_ids.shape[0]} segment ids for "
                         f"{values.shape[0]} values")
    n_blocks = -(-num_segments // block_size)
    if block_ptr.shape[0] != n_blocks + 1:
        raise ValueError(f"{name}: block_ptr has {block_ptr.shape[0]} "
                         f"entries, expected {n_blocks + 1}")
    if block_size * values.shape[1] * 4 > SMEM_LIMIT:
        raise ValueError(f"{name}: a [{block_size}, {values.shape[1]}] "
                         f"accumulator exceeds the kernel's {SMEM_LIMIT} "
                         "bytes of shared memory")
    if tile_e % 32 or not 32 <= tile_e <= 1024:
        raise ValueError(f"{name}: tile_e={tile_e} is the CTA's thread "
                         "count: a multiple of 32 in [32, 1024]")
    return n_blocks


def _launch(entry: str, values, segment_ids, block_ptr, out, n_blocks,
            block_size, num_segments, tile_e, *extra) -> None:
    if values.device.type != "cuda":
        raise ValueError(f"{entry}: no kernel for device {values.device}")
    lib = _library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = getattr(lib, entry)(
            values.data_ptr(), segment_ids.data_ptr(), block_ptr.data_ptr(),
            out.data_ptr(), n_blocks, block_size, num_segments,
            values.shape[1], *extra, tile_e, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{err}")


def seg_sum(values: torch.Tensor, segment_ids: torch.Tensor,
            block_ptr: torch.Tensor, *, block_size: int, num_segments: int,
            tile_e: int = 512) -> torch.Tensor:
    """Blocked segment sum of float32 or int32 ``values [E, D]`` into
    ``[num_segments, D]``; edges binned by block as ``block_ptr`` says.

    The int32 sum is exact (two's-complement, wrapping as int32 does),
    as the TPU kernel's integer one-hot dot is.
    """
    n_blocks = _check("seg_sum", values, segment_ids, block_ptr, block_size,
                      num_segments, tile_e, (torch.float32, torch.int32))
    if values.device.type == "cpu":
        return seg_sum_plain(values, segment_ids, block_ptr,
                             block_size=block_size, num_segments=num_segments,
                             tile_e=tile_e)
    out = torch.empty((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    if n_blocks == 0:
        return out
    entry = "seg_sum_f32" if values.dtype == torch.float32 else "seg_sum_i32"
    _launch(entry, values, segment_ids, block_ptr, out, n_blocks, block_size,
            num_segments, tile_e)
    seg_sum.launches += 1
    return out


seg_sum.launches = 0


def seg_minmax(values: torch.Tensor, segment_ids: torch.Tensor,
               block_ptr: torch.Tensor, *, block_size: int,
               num_segments: int, is_min: bool,
               tile_e: int = 512) -> torch.Tensor:
    """Blocked segment min (``is_min``) or max of float32 or int32
    ``values [E, D]`` into ``[num_segments, D]``; bit-exact."""
    n_blocks = _check("seg_minmax", values, segment_ids, block_ptr,
                      block_size, num_segments, tile_e,
                      (torch.float32, torch.int32))
    if values.device.type == "cpu":
        return seg_minmax_plain(values, segment_ids, block_ptr,
                                block_size=block_size,
                                num_segments=num_segments, is_min=is_min,
                                tile_e=tile_e)
    out = torch.empty((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    if n_blocks == 0:
        return out
    entry = ("seg_minmax_f32" if values.dtype == torch.float32
             else "seg_minmax_i32")
    _launch(entry, values, segment_ids, block_ptr, out, n_blocks, block_size,
            num_segments, tile_e, int(bool(is_min)))
    seg_minmax.launches += 1
    return out


seg_minmax.launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _plain(values, segment_ids, block_ptr, block_size, num_segments, tile_e,
           kind) -> torch.Tensor:
    """The TPU kernel's computation in plain PyTorch.

    Gathers the edges into the plan's ``[n_tiles, tile_e]`` tiles, turns
    segment ids into tile-local ids (-1 for padding), drops local ids
    outside the tile's block as the kernel's one-hot does, and reduces
    each tile into its block's rows of an identity-filled output.
    """
    dev, d = values.device, values.shape[1]
    ident = identity(kind, values.dtype)
    n_rows = (block_ptr.shape[0] - 1) * block_size
    out = torch.full((n_rows + 1, d), ident, dtype=values.dtype, device=dev)
    if values.shape[0] == 0:
        return out[:num_segments]
    gather, tbid, _ = plan_tiles(block_ptr.cpu().numpy(), tile_e)
    gather = torch.from_numpy(gather).to(dev).long()
    base = torch.from_numpy(tbid).to(dev).long()[:, None] * block_size
    pad = gather < 0
    safe = torch.where(pad, 0, gather)
    lids = segment_ids.long()[safe] - base
    keep = ~pad & (lids >= 0) & (lids < block_size)
    rows = torch.where(keep, base + lids, n_rows).reshape(-1, 1)
    out.scatter_reduce_(0, rows.expand(-1, d), values[safe.reshape(-1)],
                        SCATTER_REDUCE[kind], include_self=True)
    return out[:num_segments]


def seg_sum_plain(values, segment_ids, block_ptr, *, block_size: int,
                  num_segments: int, tile_e: int = 512) -> torch.Tensor:
    """Plain version of :func:`seg_sum` (same inputs, same result up to
    the order of float additions; int32 bit-equal)."""
    return _plain(values, segment_ids, block_ptr, block_size, num_segments,
                  tile_e, "sum")


def seg_minmax_plain(values, segment_ids, block_ptr, *, block_size: int,
                     num_segments: int, is_min: bool,
                     tile_e: int = 512) -> torch.Tensor:
    """Plain version of :func:`seg_minmax` (bit-equal results)."""
    return _plain(values, segment_ids, block_ptr, block_size, num_segments,
                  tile_e, "min" if is_min else "max")
