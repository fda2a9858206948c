"""Degree-aware tuner of the blocked reducers' plans (counterpart of
``repro.kernels.autotune``).

No single tiling of K1/K2 is best on every graph, as no single system
configuration is: the best output-block size and threads per CTA depend
on the degree distribution.  Three entry points, cheapest first:

- :func:`suggest_plan`: no measurement, a plan from
  :func:`degree_features` (``run(..., autotune="heuristic")``);
- :func:`tune`: time every candidate of :func:`candidate_plans` (the
  default plan always among them) and keep the fastest, which must beat
  the default by more than 2 % to displace it;
- :func:`autotune_plan`: :func:`tune` behind two caches, the
  process-wide ``PLAN_CACHE`` (kind ``"tuned_tiling"``) and a JSON disk
  cache keyed by the quantized :func:`degree_signature`, so that a
  structurally similar graph reuses a tuned plan without measuring.

What follows the reference exactly: :func:`degree_features`,
:func:`degree_signature` (numpy, bit for bit), :func:`_coarsening`, the
disk cache's file format and merge rule, :class:`TuneResult`, the 2 %
margin of :func:`tune`, and the ``block_mult``, ``block_div`` and
``gather_splits`` of every candidate, in the reference's order.

What was re-derived for the card: ``tile_e``.  On the TPU it was edges
per tile, swept over powers of two in ``[128, 4096]`` so that a tile
covered a block.  The CUDA kernels cut every block into chunks of at
most ``CHUNK_E`` edges whatever the tile (the chunk plan), and take
``tile_e`` as the threads of the CTA that reduces a chunk: a multiple
of 32 up to 1,024.  So every blocked candidate is tried at
:data:`THREADS` = {128, 256, 512, 1024} threads, and
:func:`suggest_plan` uses one constant, :data:`HEURISTIC_THREADS`.

The disk cache is ``results/torch/autotune_cache.json`` (never the
reference's ``results/autotune_cache.json``), and its key carries the
device's name as well, so that a plan timed on the CPU never serves the
card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.segment_reduce.kernel import SMEM_LIMIT
from repro_torch.kernels.segment_reduce.ops import (DEFAULT_PLAN,
                                                    BlockedSegmentReducer,
                                                    TilingPlan)
from repro_torch.kernels.segment_reduce.sparse import gathered_segment_reduce

__all__ = [
    "degree_features", "degree_signature", "candidate_plans", "suggest_plan",
    "build_reducer", "measure_plan", "tune", "autotune_plan", "TuneResult",
    "load_disk_cache", "store_disk_entry", "persist_tune_result",
    "DEFAULT_CACHE_PATH", "ORDERS", "THREADS", "HEURISTIC_THREADS",
]

#: Where tuned plans persist across processes: machine state, not a
#: record (ignored by git).
DEFAULT_CACHE_PATH = "results/torch/autotune_cache.json"

#: Edge orders the blocked reducer serves (``autotune.py:61``);
#: "gathered" is the sparse frontier path, whose only tunable is
#: ``gather_splits``.
ORDERS = ("owned", "pull", "gathered")

#: The thread axis of every blocked candidate: K1/K2's threads per CTA.
THREADS = (128, 256, 512, 1024)
#: The heuristic's threads per CTA: ``chip_smoke.py --sweep`` timed
#: K1/K2 on the AMZ stand-in at 256 and 512 threads on an H100 80GB HBM3
#: at 700 W; 256 was 19 % faster at D = 1 and 5 % at D = 8.
HEURISTIC_THREADS = 256

# the reference's tile bounds, which still decide its candidate grid
# (and so which block shapes survive ``max_candidates``)
_MIN_TILE = 128
_MAX_TILE = 4096


def _default_cap_e(n_edges: int) -> int:
    """The executor's default sparse-gather capacity for this edge count
    (``EdgeContext.default_sparse_capacity``)."""
    from repro_torch.core.frontier import ALPHA
    return min(n_edges, max(16, -(-n_edges // int(ALPHA))))


# ---------------------------------------------------------------------------
# degree features and their quantized signature (the reference's, exactly)
# ---------------------------------------------------------------------------
def degree_features(graph) -> Dict[str, float]:
    """Degree-distribution features that steer the candidates
    (``autotune.py:79-110``): per-block edge counts of the block-binned
    orders, and the headline degree statistics."""
    deg = np.asarray(graph.out_degree, np.float64)
    per_block = np.diff(np.asarray(graph.block_ptr, np.int64)).astype(
        np.float64)
    mean_deg = float(deg.mean()) if deg.size else 0.0
    std_deg = float(deg.std()) if deg.size else 0.0
    return {
        "n_nodes": int(graph.n_nodes),
        "n_edges": int(graph.n_edges),
        "block_size": int(graph.block_size),
        "n_blocks": int(per_block.size),
        "mean_out_degree": mean_deg,
        "p95_out_degree": float(np.percentile(deg, 95)) if deg.size else 0.0,
        "max_out_degree": float(deg.max()) if deg.size else 0.0,
        "degree_skew": std_deg / mean_deg if mean_deg else 0.0,
        "nm_ratio": graph.n_nodes / max(graph.n_edges, 1),
        "mean_edges_per_block": float(per_block.mean())
        if per_block.size else 0.0,
        "p95_edges_per_block": float(np.percentile(per_block, 95))
        if per_block.size else 0.0,
        "max_edges_per_block": float(per_block.max())
        if per_block.size else 0.0,
    }


def _log2_bucket(x: float) -> int:
    return int(round(math.log2(x))) if x > 0 else 0


def degree_signature(graph_or_features) -> str:
    """Quantized feature key of the disk cache (``autotune.py:117-135``):
    log2-bucketed sizes and degree shape, so graphs of one generator
    family and scale share a signature."""
    f = (graph_or_features if isinstance(graph_or_features, dict)
         else degree_features(graph_or_features))
    return (f"v{_log2_bucket(f['n_nodes'])}"
            f"e{_log2_bucket(f['n_edges'])}"
            f"b{int(f['block_size'])}"
            f"d{_log2_bucket(max(f['mean_out_degree'], 1.0))}"
            f"p{_log2_bucket(max(f['p95_out_degree'], 1.0))}"
            f"s{_log2_bucket(1.0 + f['degree_skew'])}")


# ---------------------------------------------------------------------------
# candidates and the heuristic
# ---------------------------------------------------------------------------
def _pow2_clamp(x: float, lo: int, hi: int) -> int:
    x = max(float(x), 1.0)
    return int(min(max(2 ** round(math.log2(x)), lo), hi))


def _coarsening(feats: Dict[str, float]) -> int:
    """Largest useful output-block coarsening (``autotune.py:142-154``):
    coarsen while typical blocks underfill the smallest tile and at
    least two coarse blocks remain."""
    mult = 1
    epb = max(feats["mean_edges_per_block"], 1.0)
    while (mult < 8 and feats["n_blocks"] // (mult * 2) >= 2
           and epb * mult < _MIN_TILE):
        mult *= 2
    return mult


def _reference_grid(feats: Dict[str, float], order: str,
                    max_candidates: int) -> List[Tuple[int, int]]:
    """The reference's blocked grid (``autotune.py:157-225``) as
    ``(block_mult, block_div)`` pairs in its order, after its
    ``max_candidates`` cut, one pair per distinct block shape."""
    plans: List[Tuple[int, int, int]] = [(DEFAULT_PLAN.tile_e, 1, 1)]

    def add(tile_e, block_mult=1, block_div=1):
        if (tile_e, block_mult, block_div) not in plans:
            plans.append((tile_e, block_mult, block_div))

    epb = max(feats["mean_edges_per_block"], 1.0)
    if order == "pull":
        # refinements first, deepest first: the fully dst-sorted CSC
        # order is binned under any block partition
        for div in (4, 2):
            eff_bs = feats["block_size"] // div
            if eff_bs < 32 or feats["n_nodes"] // eff_bs < 2:
                continue
            sub_epb = epb / div
            for t in sorted({_pow2_clamp(sub_epb / 2, _MIN_TILE, 1024),
                             _pow2_clamp(sub_epb, _MIN_TILE, 1024)}):
                add(t, block_div=div)
        if epb > 4 * DEFAULT_PLAN.tile_e:
            add(_pow2_clamp(epb / 2, _MIN_TILE, _MAX_TILE))
    else:
        mults = [1]
        best_mult = _coarsening(feats)
        if best_mult > 1:
            mults.append(best_mult)
        lo = max(epb / 2, _MIN_TILE)
        hi = max(feats["p95_edges_per_block"], lo)
        for mult in mults:
            t = _pow2_clamp(lo * mult, _MIN_TILE, _MAX_TILE)
            t_hi = _pow2_clamp(hi * mult, _MIN_TILE, _MAX_TILE)
            while True:
                add(t, block_mult=mult)
                if t >= t_hi:
                    break
                t *= 2
    shapes: List[Tuple[int, int]] = []
    for _, mult, div in plans[:max_candidates]:
        if (mult, div) not in shapes:
            shapes.append((mult, div))
    return shapes


def candidate_plans(graph=None, features: Optional[Dict[str, float]] = None,
                    order: str = "owned", max_candidates: int = 6,
                    cap_e: Optional[int] = None) -> Tuple[TilingPlan, ...]:
    """The candidates of a sweep; :data:`DEFAULT_PLAN` comes first.

    Blocked orders: the reference's block shapes (``block_mult`` for the
    owned order's coarsening, ``block_div`` for the pull order's
    refinements, which come first), in its order and under its
    ``max_candidates`` cut, each at every thread count of
    :data:`THREADS`.  The "gathered" order: the default and 2 or 4
    partial scatters where the slice holds at least 256 edges per split,
    as in the reference.
    """
    feats = features if features is not None else degree_features(graph)
    if order == "gathered":
        cands = [DEFAULT_PLAN]
        cap = int(cap_e) if cap_e else _default_cap_e(int(feats["n_edges"]))
        for splits in (2, 4):
            if cap // splits >= 256:
                cands.append(dataclasses.replace(
                    DEFAULT_PLAN, gather_splits=splits, source="candidate"))
        return tuple(cands[:max_candidates])
    if order not in ("owned", "pull"):
        raise ValueError(f"unknown blocked order {order!r}")
    plans: List[TilingPlan] = [DEFAULT_PLAN]
    for mult, div in _reference_grid(feats, order, max_candidates):
        for threads in THREADS:
            p = TilingPlan(tile_e=threads, block_mult=mult, block_div=div,
                           source="candidate")
            if p.astuple() not in {q.astuple() for q in plans}:
                plans.append(p)
    return tuple(plans)


def suggest_plan(features: Dict[str, float],
                 order: str = "owned") -> TilingPlan:
    """A plan without measurement (``autotune.py:228-263``): the
    reference's block shape (the owned order coarsened by
    :func:`_coarsening`; the pull order refined to the smallest block of
    at least 64 vertices, up to a quarter) at
    :data:`HEURISTIC_THREADS`.  The gathered path keeps its default."""
    if order == "gathered":
        return DEFAULT_PLAN
    if order == "pull":
        div = 1
        while (div < 4 and features["block_size"] // (div * 2) >= 64
               and features["n_nodes"] // (features["block_size"]
                                           // (div * 2)) >= 2):
            div *= 2
        return TilingPlan(tile_e=HEURISTIC_THREADS, block_div=div,
                          source="heuristic")
    return TilingPlan(tile_e=HEURISTIC_THREADS,
                      block_mult=_coarsening(features), source="heuristic")


# ---------------------------------------------------------------------------
# reducer construction and measurement
# ---------------------------------------------------------------------------
def build_reducer(graph, order: str, plan: Optional[TilingPlan] = None,
                  device=None) -> BlockedSegmentReducer:
    """Build the blocked reducer for one edge order of a host ``graph``
    (``autotune.py:266-294``) on ``device`` (None: the CUDA card; raises
    ``RuntimeError`` without one unless ``device="cpu"`` is passed): the
    one construction path of the executor and the tuner.

    ``order`` is "owned" (the dst-block-binned by-src order, the DeNovo
    push path) or "pull" (the CSC order, binned under any blocking since
    it is fully dst-sorted, so ``block_div`` refines it).
    """
    device = resolve_device(device)
    v = int(graph.n_nodes)
    if order == "owned":
        dst_owned = np.asarray(graph.dst)[np.asarray(graph.perm_owned)]
        return BlockedSegmentReducer.from_plan(
            dst_owned, np.asarray(graph.block_ptr), v, graph.block_size,
            plan, device=device)
    if order == "pull":
        plan = plan if plan is not None else DEFAULT_PLAN
        eff_bs = plan.block_size(graph.block_size)
        n_blocks = -(-v // eff_bs)
        bounds = np.minimum(np.arange(n_blocks + 1) * eff_bs, v)
        pull_ptr = np.asarray(graph.row_ptr_in)[bounds]
        return BlockedSegmentReducer(
            np.asarray(graph.dst_in), pull_ptr, v, eff_bs,
            tile_e=plan.tile_e, plan=plan, device=device)
    raise ValueError(f"unknown blocked order {order!r}")


def _bench(fn, repeats: int, device: torch.device) -> float:
    """Best of ``repeats`` timed runs of ``fn`` in seconds, after one
    untimed call.  On the card ``fn``'s launches are captured into a
    CUDA graph once and each replay is timed with CUDA events: device
    time only, as the fused engine runs the reducers, without the host's
    issue time between eager launches.  On the CPU, the host clock."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("measure_plan: cannot time inside a CUDA graph "
                           "capture")
    fn()
    if device.type != "cuda":
        best = math.inf
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        times = []
        for _ in range(max(1, repeats)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        del graph
    return min(times)


def measure_plan(graph, plan: TilingPlan, order: str = "owned",
                 kind: str = "mixed", dtype=torch.float32, d: int = 1,
                 repeats: int = 3, cap_e: Optional[int] = None,
                 device=None) -> float:
    """Best-of-``repeats`` seconds of one reduction under ``plan``
    (``autotune.py:307-348``), after one untimed call.

    On the card the kernels run as a captured CUDA graph timed with CUDA
    events (the reference jits the call, to rank candidates as the
    executor runs them; the port's fused engine replays graphs); on a
    CPU device (the caller's choice) their plain versions run under the
    host clock.
    Values are seeded random and the same for every candidate of a
    sweep.  ``kind="mixed"`` times one sum plus one min per call: one
    bound reducer serves every monoid of a program.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    kinds = ("sum", "min") if kind == "mixed" else (kind,)
    np_dtype = np.float32 if dtype == torch.float32 else np.int32

    def draw(n):
        shape = (n,) if d == 1 else (n, d)
        if np_dtype is np.int32:
            return rng.integers(-64, 64, shape).astype(np.int32)
        return rng.standard_normal(shape).astype(np.float32)

    if order == "gathered":
        cap = int(cap_e) if cap_e else _default_cap_e(int(graph.n_edges))
        ids_np = np.asarray(graph.dst)[
            rng.integers(0, max(graph.n_edges, 1), cap)].astype(np.int32)
        ids_np[rng.random(cap) < 0.1] = -1  # padding and masked slots
        vals = torch.from_numpy(draw(cap)).to(device)
        ids = torch.from_numpy(ids_np).to(device)
        return _bench(lambda: [gathered_segment_reduce(
            vals, ids, graph.n_nodes, k, plan=plan) for k in kinds],
            repeats, device)
    red = build_reducer(graph, order, plan, device=device)
    vals = torch.from_numpy(draw(graph.n_edges)).to(device)
    return _bench(lambda: [red.reduce(vals, k) for k in kinds], repeats,
                  device)


# ---------------------------------------------------------------------------
# disk persistence (keyed by degree signature)
# ---------------------------------------------------------------------------
def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _disk_key(sig: str, order: str, kind: str, dtype, d: int,
              cap_e: Optional[int] = None, device_name: str = "cpu") -> str:
    """The reference's key (``autotune.py:351-358``) and the device's
    name."""
    return (f"{sig}|{order}|{kind}|{str(dtype).replace('torch.', '')}"
            f"|{int(d)}|c{int(cap_e or 0)}|{device_name}")


def load_disk_cache(path=DEFAULT_CACHE_PATH) -> Dict[str, dict]:
    """The persisted ``{disk_key: entry}`` map; {} if the file is absent
    or unreadable."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    entries = data.get("entries") if isinstance(data, dict) else None
    return entries if isinstance(entries, dict) else {}


def store_disk_entry(key: str, entry: dict, path=DEFAULT_CACHE_PATH) -> None:
    """Merge one entry into the JSON cache (an atomic replace)."""
    path = Path(path)
    entries = load_disk_cache(path)
    entries[key] = entry
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps({"version": 1, "entries": entries}, indent=2,
                              sort_keys=True))
    os.replace(tmp, path)


def persist_tune_result(result: "TuneResult", dtype=torch.float32, d: int = 1,
                        cap_e: Optional[int] = None, cache_path=...,
                        device_name: str = "cpu") -> str:
    """Persist a sweep's winner under the key :func:`autotune_plan`
    looks up; returns the key (``autotune.py:372-401``).  ``cache_path``
    None persists nothing."""
    if cache_path is ...:
        cache_path = DEFAULT_CACHE_PATH
    dkey = _disk_key(result.signature, result.order, result.kind, dtype, d,
                     cap_e, device_name)
    if cache_path is None:
        return dkey
    tile_e, block_mult, block_div, gather_splits = result.plan.astuple()
    store_disk_entry(dkey, {
        "tile_e": tile_e, "block_mult": block_mult,
        "block_div": block_div, "gather_splits": gather_splits,
        "order": result.order, "kind": result.kind,
        "signature": result.signature, "device": device_name,
        "best_us": (result.best_seconds or 0.0) * 1e6,
        "default_us": (result.default_seconds or 0.0) * 1e6,
        "n_candidates": len(result.measurements),
    }, path=cache_path)
    return dkey


def _plan_from_entry(entry: dict) -> Optional[TilingPlan]:
    try:
        return TilingPlan(tile_e=int(entry["tile_e"]),
                          block_mult=int(entry["block_mult"]),
                          block_div=int(entry.get("block_div", 1)),
                          gather_splits=int(entry["gather_splits"]),
                          source="disk")
    except (KeyError, TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TuneResult:
    """What one sweep measured (``autotune.py:428-464``)."""
    plan: TilingPlan
    order: str
    kind: str
    signature: str
    #: ``[(plan, best_seconds)]`` per candidate; empty on a disk hit
    measurements: Tuple[Tuple[TilingPlan, float], ...] = ()
    from_disk: bool = False

    def _seconds(self, plan: TilingPlan) -> Optional[float]:
        for p, s in self.measurements:
            if p.astuple() == plan.astuple():
                return s
        return None

    @property
    def default_seconds(self) -> Optional[float]:
        return self._seconds(DEFAULT_PLAN)

    @property
    def best_seconds(self) -> Optional[float]:
        return min((s for _, s in self.measurements), default=None)

    @property
    def plan_seconds(self) -> Optional[float]:
        """Seconds of the chosen plan (the margin may keep the default
        when a candidate measured faster)."""
        return self._seconds(self.plan)

    @property
    def speedup_vs_default(self) -> Optional[float]:
        """Default over chosen seconds: 1.0 when the default was kept."""
        d, c = self.default_seconds, self.plan_seconds
        return d / c if d and c else None


def _fits(plan: TilingPlan, order: str, feats: Dict[str, float],
          d: int) -> bool:
    """Whether K1/K2 can hold the plan's ``[block_size, d]``
    accumulator in shared memory."""
    if order == "gathered":
        return True
    return plan.block_size(int(feats["block_size"])) * d * 4 <= SMEM_LIMIT


def tune(graph, order: str = "owned", kind: str = "mixed",
         dtype=torch.float32, d: int = 1, repeats: int = 3,
         max_candidates: int = 6, cap_e: Optional[int] = None,
         candidates: Optional[Sequence[TilingPlan]] = None,
         margin: float = 0.02, device=None) -> TuneResult:
    """Time every candidate; the fastest wins, but a plan other than the
    default must beat it by more than ``margin`` (``autotune.py:467-500``).
    Candidates whose accumulator does not fit the kernels' shared memory
    at width ``d`` are skipped."""
    feats = degree_features(graph)
    cands = tuple(candidates) if candidates is not None else candidate_plans(
        features=feats, order=order, max_candidates=max_candidates,
        cap_e=cap_e)
    measured = [(plan, measure_plan(graph, plan, order=order, kind=kind,
                                    dtype=dtype, d=d, repeats=repeats,
                                    cap_e=cap_e, device=device))
                for plan in cands if _fits(plan, order, feats, d)]
    best_plan, best_secs = min(measured, key=lambda ps: ps[1])
    default_secs = next((s for p, s in measured
                         if p.astuple() == DEFAULT_PLAN.astuple()), None)
    if default_secs is not None and default_secs <= best_secs * (1 + margin):
        best_plan = DEFAULT_PLAN
    if best_plan.astuple() != DEFAULT_PLAN.astuple():
        best_plan = dataclasses.replace(best_plan, source="tuned")
    return TuneResult(plan=best_plan, order=order, kind=kind,
                      signature=degree_signature(feats),
                      measurements=tuple(measured))


def autotune_plan(graph, order: str = "owned", kind: str = "mixed",
                  dtype=torch.float32, d: int = 1, mode: str = "measure",
                  repeats: int = 3, max_candidates: int = 6,
                  cap_e: Optional[int] = None, cache_path=...,
                  device=None) -> TilingPlan:
    """The cached tuner the executor calls (``autotune.py:503-560``).

    ``PLAN_CACHE`` (kind ``"tuned_tiling"``, keyed by order, kind,
    dtype, D, mode, cache path, capacity and device), then the disk
    cache (``cache_path``; default :data:`DEFAULT_CACHE_PATH`, read at
    call time; None disables it), then a :func:`tune` sweep whose winner
    is persisted.  An unwritable cache path costs the persistence, never
    the run.  ``mode="heuristic"`` returns :func:`suggest_plan` (still
    process-cached) and touches neither timer nor disk.
    """
    if cache_path is ...:
        cache_path = DEFAULT_CACHE_PATH
    if mode not in ("heuristic", "measure"):
        raise ValueError(f"unknown autotune mode {mode!r}; "
                         "expected 'heuristic' or 'measure'")
    device = resolve_device(device)
    from repro_torch.core.plan_cache import PLAN_CACHE
    key = (order, kind, str(dtype), int(d), mode, str(cache_path),
           int(cap_e or 0), str(device))

    def build() -> TilingPlan:
        if mode == "heuristic":
            return suggest_plan(degree_features(graph), order=order)
        name = _device_name(device)
        dkey = _disk_key(degree_signature(graph), order, kind, dtype, d,
                         cap_e, name)
        if cache_path is not None:
            plan = _plan_from_entry(load_disk_cache(cache_path).get(dkey, {}))
            if plan is not None:
                return plan
        result = tune(graph, order=order, kind=kind, dtype=dtype, d=d,
                      repeats=repeats, max_candidates=max_candidates,
                      cap_e=cap_e, device=device)
        try:
            persist_tune_result(result, dtype=dtype, d=d, cap_e=cap_e,
                                cache_path=cache_path, device_name=name)
        except OSError:
            pass  # the disk cache is an optimization, not a dependency
        return result.plan

    return PLAN_CACHE.get(graph, "tuned_tiling", key, build)
