#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

    python3 chip_smoke.py [--out results/torch/chip_smoke.json]

Phases, in order, each printing its lines; any failure raises and the
script exits non-zero:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build: compile the segment-reduce kernels from this checkout's
   sources (``nvcc`` for sm_90a) and print the build seconds.
3. kernels: on the AMZ stand-in (Table II scale, fixed seed), call each
   kernel at the main path's shapes (the owned and the CSC edge order,
   D in {1, 8}) and hold it against its plain PyTorch version on the
   same inputs: min/max bit-equal, float32 sum to rtol=1e-5, atol=1e-6
   (shared-memory atomics add in a run-dependent order).  Time the
   kernel, the plain version and one ``scatter_reduce`` call (CUDA
   events, median of 15 launches, L2 flushed before each).
4. main path: with every launch count set to 0, run BFS, SSSP and
   PageRank through ``repro_torch.core.run`` with ``use_kernels=True``
   under SD1 (owned kernel), TG0 (pull kernel) and DD1 (both kernels
   plus the sparse gather); require each run to launch its kernel; then
   check the states against the numpy oracles (BFS exact, SSSP
   rtol=1e-5, PR atol=1e-6).  The same cells run once more with
   ``use_kernels=False`` (plain scatter reductions) for comparison.
5. print the kernel table as one JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

The full record also goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: AMZ row of Table II: powerlaw arguments of the synthetic stand-in
#: (``graph/datasets.py``'s AMZ branch) at scale 1, with a fixed seed in
#: place of ``hash(name)`` so that every run sees the same graph
AMZ = dict(n=410236, n_edges=6713648 // 2, alpha=1.2, max_degree=2770,
           locality=0.21, degree_order="sorted", seed=20200224,
           weighted=True, block_size=256)
KERNEL_SOURCE = "src/repro_torch/kernels/segment_reduce/csrc/segment_reduce.cu"
REPLACES = {"seg_sum": "src/repro/kernels/segment_reduce/kernel.py:100",
            "seg_minmax": "src/repro/kernels/segment_reduce/kernel.py:152"}
CASES = [("seg_sum", torch.float32, "sum"),
         ("seg_minmax", torch.float32, "min"),
         ("seg_minmax", torch.float32, "max"),
         ("seg_minmax", torch.int32, "min"),
         ("seg_minmax", torch.int32, "max")]
REPS = 15


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over REPS calls, L2 flushed before
    each (CUDA events around each call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(graph, dev, flush) -> list:
    from repro_torch.kernels.autotune import build_reducer
    from repro_torch.kernels.segment_reduce import (identity, seg_minmax,
                                                    seg_minmax_plain,
                                                    seg_sum, seg_sum_plain)
    rng = np.random.default_rng(7)
    rows = []
    for order, label in (("owned", "owned"), ("pull", "csc")):
        red = build_reducer(graph, order, device=dev)
        ids, bp = red.segment_ids, red.block_ptr
        e, v, bs = ids.shape[0], red.num_segments, red.block_size
        ids_long = ids.long()
        for d in (1, 8):
            f32 = torch.from_numpy(
                rng.uniform(1.0, 16.0, (e, d)).astype(np.float32)).to(dev)
            i32 = torch.from_numpy(
                rng.integers(0, 64, (e, d)).astype(np.int32)).to(dev)
            index = ids_long[:, None].expand(e, d)
            for name, dtype, kind in CASES:
                vals = f32 if dtype == torch.float32 else i32
                kw = dict(block_size=bs, num_segments=v, tile_e=red.tile_e)
                if name == "seg_sum":
                    kernel = lambda: seg_sum(vals, ids, bp, **kw)
                    plain = lambda: seg_sum_plain(vals, ids, bp, **kw)
                else:
                    kw["is_min"] = kind == "min"
                    kernel = lambda: seg_minmax(vals, ids, bp, **kw)
                    plain = lambda: seg_minmax_plain(vals, ids, bp, **kw)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                # equal entries (the +-inf of empty rows too) count 0
                err = float(torch.where(
                    got == want, 0.0,
                    (got.double() - want.double()).abs()).max())
                if kind == "sum":
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-6)
                elif not torch.equal(got, want):
                    raise AssertionError(f"{name} {dtype} {kind} {label} "
                                         f"D={d}: not bit-equal to plain")
                base = torch.full((v, d), identity(kind, dtype),
                                  dtype=dtype, device=dev)
                reduce = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
                library = lambda: base.scatter_reduce(0, index, vals, reduce,
                                                      include_self=True)
                lib_out = library()
                torch.cuda.synchronize()
                if kind != "sum" and not torch.equal(lib_out, want):
                    raise AssertionError("scatter_reduce disagrees")
                elt = vals.element_size()
                moved = (vals.numel() * elt + ids.numel() * 4
                         + bp.numel() * 4 + v * d * elt)
                bytes_ms = moved / HBM_BYTES_PER_S * 1e3
                ops_ms = vals.numel() / F32_OPS_PER_S * 1e3
                row = dict(
                    name=f"{name}[{str(dtype)[6:]},{kind},{label},D={d}]",
                    kernel=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=0, max_abs_err=err,
                    ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=time_ms(library, flush),
                    edges=e, segments=v, block_size=bs, d=d, bytes=moved)
                rows.append(row)
                log(f"kernel {row['name']}: ms={row['ms']:.4f} "
                    f"plain_ms={row['plain_ms']:.4f} "
                    f"library_ms={row['library_ms']:.4f} "
                    f"bound_ms={row['bound_ms']:.4f} max_abs_err={err}")
    return rows


def main_path(graph, dev) -> tuple:
    from repro_torch.algorithms import bfs, pagerank, sssp
    from repro_torch.algorithms.reference import (bfs_np, pagerank_np,
                                                  sssp_np)
    from repro_torch.core import SystemConfig, run
    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    apps = {"BFS": (bfs, seg_minmax), "SSSP": (sssp, seg_minmax),
            "PR": (pagerank, seg_sum)}
    seg_sum.launches = 0
    seg_minmax.launches = 0
    results = []
    for cfg in ("SD1", "TG0", "DD1"):
        for app, (factory, kernel) in apps.items():
            before = kernel.launches
            res = run(factory(), graph, SystemConfig.from_name(cfg),
                      use_kernels=True, device=dev)
            launched = kernel.launches - before
            if launched <= 0:
                raise AssertionError(f"{app} under {cfg} launched no "
                                     f"{kernel.__name__} kernel")
            if not res.converged:
                raise AssertionError(f"{app} under {cfg} did not converge")
            results.append((app, cfg, res, kernel.__name__, launched))
    launches = {"seg_sum": seg_sum.launches,
                "seg_minmax": seg_minmax.launches}
    log(f"main path launches: {json.dumps(launches)}")
    # the same cells with the plain scatter reductions, for comparison
    plain_seconds = {}
    for app, cfg, res, _, _ in results:
        plain = run(apps[app][0](), graph, SystemConfig.from_name(cfg),
                    use_kernels=False, device=dev)
        if plain.iterations != res.iterations and app != "PR":
            raise AssertionError(f"{app} {cfg}: iterations differ between "
                                 "kernel and plain reductions")
        plain_seconds[app, cfg] = plain.seconds

    t0 = time.perf_counter()
    oracle = {"BFS": bfs_np(graph), "SSSP": sssp_np(graph),
              "PR": pagerank_np(graph)}
    log(f"oracles: {time.perf_counter() - t0:.1f} s")
    record = []
    for app, cfg, res, kname, launched in results:
        got = res.extract(apps[app][0]()).cpu().numpy()
        if not np.isfinite(got).any() or got.shape != oracle[app].shape:
            raise AssertionError(f"{app} {cfg}: bad result shape/values")
        if app == "BFS":
            np.testing.assert_array_equal(got, oracle[app])
        elif app == "SSSP":
            np.testing.assert_allclose(got, oracle[app], rtol=1e-5)
        else:
            np.testing.assert_allclose(got, oracle[app], atol=1e-6)
        entry = dict(app=app, config=cfg, iterations=res.iterations,
                     seconds=res.seconds, host_syncs=res.host_syncs,
                     host_syncs_per_iteration=res.host_syncs / res.iterations,
                     direction_trace=res.direction_trace,
                     sparse_iterations=res.sparse_iterations,
                     kernel=kname, kernel_launches=launched,
                     seconds_without_kernels=plain_seconds[app, cfg])
        record.append(entry)
        log(f"run {app} {cfg}: ok iterations={res.iterations} "
            f"seconds={res.seconds:.4f} "
            f"seconds_without_kernels={plain_seconds[app, cfg]:.4f} "
            f"host_syncs={res.host_syncs} "
            f"{kname}_launches={launched} "
            f"sparse_iterations={res.sparse_iterations} "
            f"direction_trace={res.direction_trace}")
    return record, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results" / "torch" /
                                         "chip_smoke.json"))
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    from repro_torch.kernels.segment_reduce import build_library
    t0 = time.perf_counter()
    lib, report = build_library()
    build_s = time.perf_counter() - t0
    log(f"build: {lib.name} in {build_s:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    from repro_torch.graph import powerlaw_graph
    t0 = time.perf_counter()
    graph = powerlaw_graph(**AMZ)
    log(f"graph: AMZ stand-in V={graph.n_nodes} E={graph.n_edges} "
        f"block_size={graph.block_size} in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    rows = kernel_phase(graph, dev, flush)
    del flush

    # 4. the main path
    runs, launches = main_path(graph, dev)
    for row in rows:
        row["launches"] = launches[row["kernel"]]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, build_seconds=build_s,
                                   kernels=rows, runs=runs), indent=1))
    # 5. the kernel table, then the last line
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
