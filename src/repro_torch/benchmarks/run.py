"""Benchmark harness entry point: one section per paper artifact.

Counterpart of ``benchmarks/run.py``, with its flags and its
``name,us_per_call,derived`` CSV rows, routed to the port's harnesses;
the detailed JSON lands under ``results/torch/``.  Without a ``--*-only``
flag it runs the paper's own artifacts in order: Table II
(``table2``), the Fig. 5 sweep (a representative subset, or the full
6 x 7 grid with ``--full``), Table V (``table5``) and Fig. 6
(``fig6``).  ``--json`` / ``--dispatch-only`` add or run the dispatch
benchmark alone; each ``--<name>-only`` flag runs one harness (autotune,
batch, serve, resilience, chaos, matrix, specialize).

The last row is the reference's ``roofline``: the dry run's records
(``results/torch/dryrun``) through :mod:`repro_torch.benchmarks.
roofline` at the H100's peaks, single-pod cells, written to
``<out-dir>/roofline.json``.

``--batch-smoke`` and ``--resilience-smoke`` (with ``--batch-only`` /
``--resilience-only``) run the reference's smoke workloads.  Where the
reference's smoke runs overwrite its pinned artifacts, the port's write
``BENCH_batch.json`` / ``BENCH_resilience.json`` under ``--out-dir``,
or under ``results/torch/smoke/`` (ignored by git) in place of the
default ``results/torch/``: never the tracked records the perf gate
reads.

    PYTHONHASHSEED=0 python -m repro_torch.benchmarks.run --scale 1

``paper_graph`` seeds with ``hash(name)``: fix ``PYTHONHASHSEED`` so that
Table V profiles the graphs Fig. 5 timed in another process.  Every
harness runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from repro_torch.benchmarks.fig5 import RESULTS, run_fig5
from repro_torch.benchmarks.fig6 import run_fig6
from repro_torch.benchmarks.table2 import run_table2
from repro_torch.benchmarks.table5 import run_table5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="full Fig. 5 grid (every input and app); default "
                         "is a representative subset")
    ap.add_argument("--scale", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out-dir", default=str(RESULTS),
                    help="where the paper artifacts' and the batch and "
                         "resilience records' JSON goes (a smoke run's "
                         "default: results/torch/smoke/)")
    ap.add_argument("--json", action="store_true",
                    help="also run the host-vs-fused engine benchmark and "
                         "write results/torch/BENCH_dispatch.json")
    ap.add_argument("--dispatch-only", action="store_true",
                    help="with --json: only write BENCH_dispatch.json")
    ap.add_argument("--autotune-only", action="store_true",
                    help="only run the autotuner benchmark and write "
                         "results/torch/BENCH_autotune.json")
    ap.add_argument("--autotune-smoke", action="store_true",
                    help="with --autotune-only: tiny graphs + 2-candidate "
                         "grid")
    ap.add_argument("--batch-only", action="store_true",
                    help="only run the batched-serving benchmark and write "
                         "BENCH_batch.json under --out-dir")
    ap.add_argument("--batch-smoke", action="store_true",
                    help="with --batch-only: tiny graphs, B<=4, written "
                         "under results/torch/smoke/ unless --out-dir "
                         "is given")
    ap.add_argument("--serve-only", action="store_true",
                    help="only run the streaming-gateway benchmark and "
                         "write results/torch/BENCH_serve.json")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="with --serve-only: tiny pool")
    ap.add_argument("--resilience-only", action="store_true",
                    help="only run the checkpoint-overhead / recovery "
                         "benchmark and write "
                         "BENCH_resilience.json under --out-dir")
    ap.add_argument("--resilience-smoke", action="store_true",
                    help="with --resilience-only: R-MAT scale 9, written "
                         "under results/torch/smoke/ unless --out-dir "
                         "is given")
    ap.add_argument("--chaos-only", action="store_true",
                    help="only run the kill-and-restart benchmark and "
                         "write results/torch/BENCH_chaos.json")
    ap.add_argument("--chaos-smoke", action="store_true",
                    help="with --chaos-only: tiny graphs")
    ap.add_argument("--matrix-only", action="store_true",
                    help="only run the workload matrix and write "
                         "results/torch/BENCH_matrix.json")
    ap.add_argument("--matrix-smoke", action="store_true",
                    help="with --matrix-only: tiny stand-ins, reduced "
                         "config set")
    ap.add_argument("--specialize-only", action="store_true",
                    help="only train + evaluate the learned specializer on "
                         "results/torch/BENCH_matrix.json (run "
                         "--matrix-only first)")
    ap.add_argument("--specialize-smoke", action="store_true",
                    help="with --specialize-only: expect a --smoke matrix")
    args = ap.parse_args(argv)
    dev = args.device

    print("name,us_per_call,derived", flush=True)

    if args.matrix_only:
        from repro_torch.benchmarks.matrix import run_matrix
        run_matrix(smoke=args.matrix_smoke, device=dev)
        return

    if args.specialize_only:
        from repro_torch.benchmarks.specialize import run_specialize
        run_specialize(smoke=args.specialize_smoke)
        return

    if args.autotune_only:
        from repro_torch.benchmarks.autotune import run_autotune
        run_autotune(smoke=args.autotune_smoke,
                     repeats=2 if args.autotune_smoke else 5, device=dev)
        return

    if args.batch_only:
        from repro_torch.benchmarks.batch import OUT, run_batch_bench
        run_batch_bench(Path(args.out_dir) / OUT.name, device=dev,
                        smoke=args.batch_smoke)
        return

    if args.serve_only:
        from repro_torch.benchmarks.serve import run_serve_bench
        run_serve_bench(smoke=args.serve_smoke, device=dev)
        return

    if args.resilience_only:
        from repro_torch.benchmarks.resilience import (OUT,
                                                       run_resilience_bench)
        run_resilience_bench(Path(args.out_dir) / OUT.name, device=dev,
                             smoke=args.resilience_smoke)
        return

    if args.chaos_only:
        from repro_torch.benchmarks.chaos import run_chaos_bench
        run_chaos_bench(smoke=args.chaos_smoke, device=dev)
        return

    if args.json or args.dispatch_only:  # --dispatch-only implies --json
        from repro_torch.benchmarks.dispatch import run_dispatch
        run_dispatch(device=dev)
        if args.dispatch_only:
            return

    t0 = time.perf_counter()
    out_dir = Path(args.out_dir)
    rows = run_table2(out_dir=out_dir, device=dev)["rows"]
    dt = (time.perf_counter() - t0) / max(len(rows), 1)
    n_class_ok = sum(
        r["computed_from_published"]["vol_class"]
        == r["published"]["vol_class"] for r in rows)
    print(f"table2_profile,{dt*1e6:.0f},vol_class_match={n_class_ok}/6",
          flush=True)

    graphs = None if args.full else ["DCT", "RAJ", "OLS", "WNG"]
    apps = None if args.full else ["PR", "SSSP", "BFS", "MIS", "CLR", "CC"]
    t0 = time.perf_counter()
    fig5 = run_fig5(out_dir=out_dir, scale=args.scale, graphs=graphs,
                    apps=apps, device=dev)["cells"]
    n_cells = len(fig5)
    dt = (time.perf_counter() - t0) / max(n_cells, 1)
    n_best_not_ref = sum(1 for v in fig5.values()
                         if v["best"] not in ("TG0", "DG1"))
    # dynamic cells whose frontier heuristic used BOTH directions in one
    # run: the per-iteration switching the D configs exist for
    n_mixed = sum(
        1 for v in fig5.values() for c, d in v["configs"].items()
        if c.startswith("D") and "S" in d.get("directions", "")
        and "T" in d.get("directions", ""))
    # dynamic cells where >=1 push iteration ran the O(m_f) sparse-
    # gathered path instead of the dense O(E) masked scan
    n_sparse_cells = sum(
        1 for v in fig5.values() for c, d in v["configs"].items()
        if c.startswith("D") and d.get("n_sparse", 0))
    print(f"fig5_sweep,{dt*1e6:.0f},cells={n_cells};"
          f"best_differs_from_ref={n_best_not_ref};"
          f"dyn_mixed_direction_cells={n_mixed};"
          f"dyn_sparse_gather_cells={n_sparse_cells}", flush=True)

    t0 = time.perf_counter()
    t5 = run_table5(out_dir=out_dir, fig5_path=out_dir / "fig5.json",
                    scale=args.scale, device=dev)
    dt = time.perf_counter() - t0
    print(f"table5_model,{dt*1e6:.0f},"
          f"paper_faithful={t5['paper_faithful']['match_table_v']};"
          f"deployed_hits={t5['deployed_exact_hits']}", flush=True)

    t0 = time.perf_counter()
    f6 = run_fig6(out_dir=out_dir, fig5_path=out_dir / "fig5.json")
    dt = time.perf_counter() - t0
    print(f"fig6_flexibility,{dt*1e6:.0f},cases={f6['n_cases']};"
          f"avg_reduction={f6['avg_reduction_pct']}%", flush=True)

    # roofline (reads the dry run's records; a row either way)
    try:
        from repro_torch.benchmarks.roofline import DRYRUN_DIR, analyze
        rows = analyze(dryrun_dir=DRYRUN_DIR, out=out_dir / "roofline.json",
                       mesh="single")
        if rows:
            worst = min(rows, key=lambda r: r["roofline_fraction"] or 1)
            print(f"roofline,{len(rows)},cells={len(rows)};"
                  f"worst_fraction={worst['roofline_fraction']}"
                  f"@{worst['arch']}/{worst['shape']}", flush=True)
        else:
            print("roofline,0,no_dryrun_artifacts", flush=True)
    except Exception as exc:  # pragma: no cover
        print(f"roofline,0,error={exc}", flush=True)


if __name__ == "__main__":
    main()
