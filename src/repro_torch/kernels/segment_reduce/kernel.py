"""Blocked segment reduction: the DeNovo-coherence analogue on the GPU.

Counterpart of ``repro.kernels.segment_reduce.kernel``.  Edges arrive
binned by destination block (``block_ptr`` gives each block's edge
range).  A chunk plan made once on the host (:func:`plan_chunks`) cuts
every block's edges into chunks of at most :data:`CHUNK_E`; one CTA
reduces one chunk into the block's accumulator in shared memory, so no
block's edges are walked by a single CTA.  A block of one chunk is
written back once from shared memory; the chunks of a split block leave
partials in a scratch buffer, and the last of them to finish combines
them in chunk order and writes the rows once.  Every update is resolved
on chip, against the LLC analogue that resolves each one in device
memory.

Two wrappers launch the hand-written CUDA kernels of
``csrc/segment_reduce.cu``:

- :func:`seg_sum` replaces ``seg_sum_pallas`` (``kernel.py:100-126``);
- :func:`seg_minmax` replaces ``seg_minmax_pallas`` (``:152-191``).

Beside each is its plain PyTorch version (:func:`seg_sum_plain`,
:func:`seg_minmax_plain`), which reduces chunk by chunk through the same
plan and then merges the partials of split blocks in chunk order.  A
wrapper runs the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  Each wrapper counts its
launches in ``<wrapper>.launches``.  The TPU kernels' tiling plan
(:func:`plan_tiles`) is kept as the reference's exact copy.

The same library holds the gathered push reduce that
:func:`repro_torch.kernels.segment_reduce.sparse.gathered_segment_reduce`
launches on the card.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout, under a name keyed on
the source's hash (:mod:`repro_torch.kernels._build`), and bound with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels._build import load
from repro_torch.kernels.segment_reduce.ref import SCATTER_REDUCE, identity

__all__ = ["plan_tiles", "plan_chunks", "ChunkPlan", "seg_sum",
           "seg_sum_plain", "seg_minmax", "seg_minmax_plain", "SOURCE",
           "SMEM_LIMIT", "CHUNK_E"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu"
#: Shared memory a CTA may take without opting in to more: the kernels
#: hold a [block_size, D] accumulator of 4-byte words within it, and
#: nothing else
SMEM_LIMIT = 48 * 1024
#: Most edges one CTA reduces: a block with more is split into chunks
CHUNK_E = 4096
_INT32_MAX = np.iinfo(np.int32).max


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


def plan_chunks(block_ptr: np.ndarray, chunk_e: int = CHUNK_E):
    """Host-side chunk plan over block-binned edges: one chunk per CTA.

    Cuts block *b*'s edges ``block_ptr[b] .. block_ptr[b+1]`` into
    consecutive chunks of at most ``chunk_e`` edges; an empty block keeps
    one empty chunk so that its rows are written.  Returns five int32
    arrays over the chunks, in block order: ``(block, start, end, index,
    slot)``, where ``index`` is the chunk's ordinal among its block's
    chunks and ``slot`` its place in the partials buffer of split blocks
    (-1 for a block of one chunk).  The slots of one block are
    consecutive and follow ``index``; all slots are ``0 .. n_slots-1``.
    """
    block_ptr = np.asarray(block_ptr, np.int64)
    if chunk_e < 1:
        raise ValueError(f"plan_chunks: chunk_e={chunk_e} must be >= 1")
    if block_ptr.size and int(block_ptr[-1]) >= _INT32_MAX:
        raise ValueError("plan_chunks: edge count exceeds int32 index range")
    n_blocks = block_ptr.shape[0] - 1
    counts = np.diff(block_ptr)
    per_block = np.maximum(1, -(-counts // chunk_e))
    block = np.repeat(np.arange(n_blocks), per_block)
    first = np.cumsum(per_block) - per_block
    index = np.arange(block.shape[0]) - first[block]
    start = block_ptr[block] + index * chunk_e
    end = np.minimum(start + chunk_e, block_ptr[block + 1])
    split = per_block[block] > 1
    slot = np.where(split, np.cumsum(split) - 1, -1)
    return tuple(a.astype(np.int32)
                 for a in (block, start, end, index, slot))


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkPlan:
    """:func:`plan_chunks` on the device, with what a launch needs.

    ``table`` is the plan as one ``[5, n_chunks]`` int32 tensor (block,
    start, end, index, slot); ``counters`` holds one int32 per block,
    zero between calls (the CTA that merges a split block resets its
    counter), so calls that share a plan must be ordered on one stream.
    ``n_edges`` is the end of the last chunk: the values it reads.
    """

    table: torch.Tensor
    counters: torch.Tensor
    chunk_e: int
    n_slots: int
    longest: int
    n_edges: int

    @classmethod
    def build(cls, block_ptr, chunk_e: int = CHUNK_E,
              device=None) -> "ChunkPlan":
        """Plan ``block_ptr`` (numpy, or a tensor, which is read back to
        the host) and put the plan on ``device`` (default: where a
        ``block_ptr`` tensor lies, else the CPU)."""
        if isinstance(block_ptr, torch.Tensor):
            device = block_ptr.device if device is None else device
            block_ptr = block_ptr.cpu().numpy()
        block, start, end, index, slot = plan_chunks(block_ptr, chunk_e)
        table = torch.from_numpy(np.stack([block, start, end, index, slot]))
        n_blocks = np.asarray(block_ptr).shape[0] - 1
        return cls(table=table.to(device),
                   counters=torch.zeros(n_blocks, dtype=torch.int32,
                                        device=device),
                   chunk_e=int(chunk_e), n_slots=int((slot >= 0).sum()),
                   longest=int((end - start).max(initial=0)),
                   n_edges=int(end.max(initial=0)))

    @property
    def n_chunks(self) -> int:
        return int(self.table.shape[1])


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, p, p, i, i, p, p, p, i, i, i]
    lib.seg_sum_f32.argtypes = head + [i, p]
    lib.seg_sum_i32.argtypes = head + [i, p]
    lib.seg_minmax_f32.argtypes = head + [i, i, p]
    lib.seg_minmax_i32.argtypes = head + [i, i, p]
    # the gathered push reduce of sparse.py: vals, ids, n_slots, d, out,
    # num_segments, kind, stream
    gathered = [p, p, ctypes.c_longlong, i, p, i, i, p]
    lib.gathered_reduce_f32.argtypes = gathered
    lib.gathered_reduce_i32.argtypes = gathered
    for fn in (lib.seg_sum_f32, lib.seg_sum_i32, lib.seg_minmax_f32,
               lib.seg_minmax_i32, lib.gathered_reduce_f32,
               lib.gathered_reduce_i32):
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


def _chunks(name, chunks, block_ptr, values) -> ChunkPlan:
    """The caller's plan, checked against ``block_ptr``, or a new one."""
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {values.device}")
    if chunks is None:
        return ChunkPlan.build(block_ptr)
    if chunks.table.device != values.device:
        raise ValueError(f"{name}: chunk plan is on {chunks.table.device}, "
                         f"values on {values.device}")
    if chunks.counters.shape[0] != block_ptr.shape[0] - 1:
        raise ValueError(f"{name}: chunk plan covers "
                         f"{chunks.counters.shape[0]} blocks, block_ptr "
                         f"{block_ptr.shape[0] - 1}")
    if chunks.n_edges > values.shape[0]:
        raise ValueError(f"{name}: chunk plan reads {chunks.n_edges} edges, "
                         f"values has {values.shape[0]}")
    return chunks


def _launch(entry: str, values, segment_ids, block_ptr, chunks: ChunkPlan,
            out, block_size, num_segments, tile_e, *extra) -> None:
    d = values.shape[1]
    if chunks.longest * d > _INT32_MAX:
        raise ValueError(f"{entry}: a chunk of {chunks.longest} edges x "
                         f"{d} features passes the kernel's 32-bit offsets")
    acc_dtype = values.dtype if "sum" in entry else torch.int32
    partials = torch.empty(chunks.n_slots * block_size * d, dtype=acc_dtype,
                           device=values.device)
    lib = _library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = getattr(lib, entry)(
            values.data_ptr(), segment_ids.data_ptr(), block_ptr.data_ptr(),
            chunks.table.data_ptr(), chunks.n_chunks, chunks.chunk_e,
            out.data_ptr(), partials.data_ptr(), chunks.counters.data_ptr(),
            block_size, num_segments, d, *extra, tile_e, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{err}")


def seg_sum(values: torch.Tensor, segment_ids: torch.Tensor,
            block_ptr: torch.Tensor, *, block_size: int, num_segments: int,
            tile_e: int = 512, chunks: "ChunkPlan | None" = None
            ) -> torch.Tensor:
    """Blocked segment sum of float32 or int32 ``values [E, D]`` into
    ``[num_segments, D]``; edges binned by block as ``block_ptr`` says.

    ``chunks`` is the chunk plan of ``block_ptr`` (:class:`ChunkPlan`, on
    the values' device); without one, a plan is made from ``block_ptr``,
    which costs a copy to the host.  The int32 sum is exact
    (two's-complement, wrapping as int32 does), as the TPU kernel's
    integer one-hot dot is.
    """
    n_blocks = _check("seg_sum", values, segment_ids, block_ptr, block_size,
                      num_segments, tile_e, (torch.float32, torch.int32))
    chunks = _chunks("seg_sum", chunks, block_ptr, values)
    if values.device.type == "cpu":
        return seg_sum_plain(values, segment_ids, block_ptr,
                             block_size=block_size, num_segments=num_segments,
                             tile_e=tile_e, chunks=chunks)
    out = torch.empty((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    if n_blocks == 0:
        return out
    entry = "seg_sum_f32" if values.dtype == torch.float32 else "seg_sum_i32"
    _launch(entry, values, segment_ids, block_ptr, chunks, out, block_size,
            num_segments, tile_e)
    seg_sum.launches += 1
    return out


seg_sum.launches = 0


def seg_minmax(values: torch.Tensor, segment_ids: torch.Tensor,
               block_ptr: torch.Tensor, *, block_size: int,
               num_segments: int, is_min: bool, tile_e: int = 512,
               chunks: "ChunkPlan | None" = None) -> torch.Tensor:
    """Blocked segment min (``is_min``) or max of float32 or int32
    ``values [E, D]`` into ``[num_segments, D]``; bit-exact.  Floats are
    ordered with -0.0 below +0.0, and a row that holds a NaN comes out
    NaN, as ``jax.ops.segment_min``/``segment_max`` give it.  ``chunks``
    as for :func:`seg_sum`."""
    n_blocks = _check("seg_minmax", values, segment_ids, block_ptr,
                      block_size, num_segments, tile_e,
                      (torch.float32, torch.int32))
    chunks = _chunks("seg_minmax", chunks, block_ptr, values)
    if values.device.type == "cpu":
        return seg_minmax_plain(values, segment_ids, block_ptr,
                                block_size=block_size,
                                num_segments=num_segments, is_min=is_min,
                                tile_e=tile_e, chunks=chunks)
    out = torch.empty((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    if n_blocks == 0:
        return out
    entry = ("seg_minmax_f32" if values.dtype == torch.float32
             else "seg_minmax_i32")
    _launch(entry, values, segment_ids, block_ptr, chunks, out, block_size,
            num_segments, tile_e, int(bool(is_min)))
    seg_minmax.launches += 1
    return out


seg_minmax.launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _flip(bits: torch.Tensor) -> torch.Tensor:
    """The kernels' order-preserving map between float32 bits and int32
    keys, -0.0 below +0.0; its own inverse.  A key made by :func:`_key`
    for a NaN maps back to a NaN (0x7fffffff and 0xffffffff)."""
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _key(values: torch.Tensor, kind: str) -> torch.Tensor:
    """The kernels' int32 key of float32 ``values`` for a min or a max:
    :func:`_flip` of the bits, and for a NaN, whatever its sign bit, the
    extreme key of the reduction, so that the NaN wins."""
    nan_key = torch.iinfo(torch.int32).min if kind == "min" else \
        torch.iinfo(torch.int32).max
    return torch.where(torch.isnan(values), nan_key,
                       _flip(values.view(torch.int32)))


def _plain(values, segment_ids, block_ptr, block_size, num_segments,
           chunks, kind) -> torch.Tensor:
    """The kernels' computation in plain PyTorch.

    Reduces every chunk of the plan into its own identity-filled
    ``[block_size, D]`` partial (ids outside the chunk's block are
    dropped, as the TPU kernel's one-hot drops them), then combines the
    partials of each block in chunk order.  Float min/max run on the
    kernels' int32 keys, so they follow the same order and NaN rule.
    """
    chunks = chunks if chunks is not None else ChunkPlan.build(
        block_ptr, device=values.device)
    dev, d = values.device, values.shape[1]
    keyed = kind != "sum" and values.dtype == torch.float32
    vals = _key(values, kind) if keyed else values
    ident = torch.tensor(identity(kind, values.dtype), dtype=values.dtype)
    ident = (_key(ident, kind) if keyed else ident).item()
    n_blocks = block_ptr.shape[0] - 1
    block, start, end, _, _ = chunks.table.to(dev).long()
    n_chunks = block.shape[0]
    partial = torch.full((n_chunks * block_size + 1, d), ident,
                         dtype=vals.dtype, device=dev)
    length = end - start
    chunk = torch.repeat_interleave(torch.arange(n_chunks, device=dev),
                                    length)
    edge = (torch.arange(chunk.shape[0], device=dev)
            + (start - (torch.cumsum(length, 0) - length))[chunk])
    lids = segment_ids.long()[edge] - block[chunk] * block_size
    keep = (lids >= 0) & (lids < block_size)
    rows = torch.where(keep, chunk * block_size + lids,
                       n_chunks * block_size)
    partial.scatter_reduce_(0, rows[:, None].expand(-1, d), vals[edge],
                            SCATTER_REDUCE[kind], include_self=True)
    out = torch.full((n_blocks, block_size * d), ident, dtype=vals.dtype,
                     device=dev)
    out.scatter_reduce_(
        0, block[:, None].expand(-1, block_size * d),
        partial[:-1].reshape(n_chunks, block_size * d),
        SCATTER_REDUCE[kind], include_self=True)
    out = out.reshape(n_blocks * block_size, d)[:num_segments]
    return _flip(out).view(torch.float32) if keyed else out


def seg_sum_plain(values, segment_ids, block_ptr, *, block_size: int,
                  num_segments: int, tile_e: int = 512,
                  chunks: "ChunkPlan | None" = None) -> torch.Tensor:
    """Plain version of :func:`seg_sum` (same inputs, same result up to
    the order of float additions; int32 bit-equal)."""
    return _plain(values, segment_ids, block_ptr, block_size, num_segments,
                  chunks, "sum")


def seg_minmax_plain(values, segment_ids, block_ptr, *, block_size: int,
                     num_segments: int, is_min: bool, tile_e: int = 512,
                     chunks: "ChunkPlan | None" = None) -> torch.Tensor:
    """Plain version of :func:`seg_minmax` (bit-equal results)."""
    return _plain(values, segment_ids, block_ptr, block_size, num_segments,
                  chunks, "min" if is_min else "max")
