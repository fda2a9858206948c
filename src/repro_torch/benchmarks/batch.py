"""Batched-serving benchmark: batched against sequential µs per graph.

Counterpart of ``benchmarks/batch.py``, at the reference's pinned
workload: ``rmat_batch`` of 64 R-MAT graphs (scale 6, edge factor 8,
seed 7; distinct seeds, in three padding buckets) and BFS, in every cell of
the design space (``ALL_CONFIGS``), for batch sizes B in ``SIZES``.
Per config and B it records

- ``seq_us_per_graph``: the sequential fused ``run`` of each graph,
  best of ``repeats`` after one untimed run that captures, averaged
  over the graphs; graphs beyond ``seq_sample`` take the sample's mean
  (``sequential_basis`` says ``measured`` or ``extrapolated``);
- ``batch_us_per_graph``: the best of ``repeats`` ``run_batch`` wall
  times over the whole batch, after one untimed batch that packs and
  captures, divided by B;
- their ratio ``speedup``; the packed batches ``run_batch`` made (the
  graphs of one B fall in 1–3 padding buckets, one batch each) and
  their launches (one poll each), and ``equal_sequential``: every
  measured graph's batched state and iteration count equal its
  sequential run's (BFS is exact).

    python -m repro_torch.benchmarks.batch [--smoke] [--repeats N]
        [--out PATH]

writes ``results/torch/BENCH_batch.json`` with the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them.  It runs on the CUDA card unless
``--device cpu`` is given.  ``--smoke`` runs the reference's smoke
workload (``SMOKE_WORKLOAD``, B in ``SMOKE_SIZES``, 2 repeats) into a
record with ``"smoke": true`` under ``results/torch/smoke/``, never into
the tracked record the perf gate reads.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.benchmarks import smoke_out
from repro_torch.benchmarks.dispatch import card
from repro_torch.core import ALL_CONFIGS, bucket_key, capture, run, run_batch
from repro_torch.device import resolve_device
from repro_torch.graph import rmat_batch

__all__ = ["PINNED_WORKLOAD", "SMOKE_WORKLOAD", "APP", "SIZES", "SMOKE_SIZES",
           "REPEATS", "SMOKE_REPEATS", "SEQ_SAMPLE", "OUT", "run_batch_bench"]

#: The pinned workload: change it and the trajectory restarts.
PINNED_WORKLOAD = dict(scale=6, edge_factor=8, seed=7)
#: The reference's smoke workload (``benchmarks/batch.py:45-48``).
SMOKE_WORKLOAD = dict(scale=5, edge_factor=8, seed=7)
APP = "BFS"
SIZES = (1, 4, 16, 64)
SMOKE_SIZES = (1, 4)
REPEATS = 5
SMOKE_REPEATS = 2
#: Graphs with a sequential measurement of their own; the rest take the
#: sample's mean.
SEQ_SAMPLE = 16
OUT = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "BENCH_batch.json"


def _geomean(xs) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 1.0


def _equal(a, b) -> bool:
    return a.iterations == b.iterations and all(
        torch.equal(a.state[k], b.state[k]) for k in a.state)


def run_batch_bench(out_path=OUT, repeats: int | None = None, sizes=None,
                    seq_sample: int = SEQ_SAMPLE, device=None,
                    smoke: bool = False) -> dict:
    """Run every cell and write the record to ``out_path`` (None: do not
    write; a smoke run never writes the tracked ``OUT``); returns the
    record."""
    device = resolve_device(device)
    if smoke:
        out_path = smoke_out(out_path, OUT)
    wl = SMOKE_WORKLOAD if smoke else PINNED_WORKLOAD
    sizes = tuple(sizes or (SMOKE_SIZES if smoke else SIZES))
    repeats = repeats or (SMOKE_REPEATS if smoke else REPEATS)
    program = REGISTRY[APP]()
    graphs = rmat_batch(max(sizes), weighted=program.weighted, **wl)
    n_meas = min(len(graphs), seq_sample)
    configs = {}
    for config in ALL_CONFIGS:
        seq_best, seq_runs = [], []
        for g in graphs[:n_meas]:
            seq_runs.append(run(program, g, config, device=device))
            seq_best.append(min(run(program, g, config, device=device).seconds
                                for _ in range(repeats)))
        mean_seq = sum(seq_best) / len(seq_best)
        per_b = {}
        for b in sizes:
            gs = graphs[:b]
            if b <= n_meas:
                seq_total, basis = sum(seq_best[:b]), "measured"
            else:
                seq_total = sum(seq_best) + mean_seq * (b - n_meas)
                basis = "extrapolated"
            run_batch(program, gs, config, device=device)
            best = None
            for _ in range(repeats):
                rs = run_batch(program, gs, config, device=device)
                total = sum(r.seconds for r in rs)
                if best is None or total < best[0]:
                    best = (total, rs)
            total, rs = best
            launches = {}  # per bucket: its batch's launches
            for g, r in zip(gs, rs):
                launches.setdefault(bucket_key(g), r.dispatches)
            seq_us, bat_us = seq_total * 1e6 / b, total * 1e6 / b
            per_b[str(b)] = {
                "seq_us_per_graph": seq_us,
                "batch_us_per_graph": bat_us,
                "speedup": seq_us / max(bat_us, 1e-12),
                "batch_iterations": max(r.iterations for r in rs),
                "batches": len(launches),
                "batch_launches": sum(launches.values()),
                "sequential_basis": basis,
                "equal_sequential": all(
                    _equal(r, s) for r, s in zip(rs, seq_runs)),
            }
        configs[config.name] = per_b
    geomean_by_b = {str(b): _geomean(c[str(b)]["speedup"]
                                     for c in configs.values())
                    for b in sizes}
    headline = str(16 if 16 in sizes else max(sizes))
    result = {
        "card": card(device),
        "device": str(device),
        "torch": torch.__version__,
        "workload": {"generator": "rmat_batch", **wl,
                     "app": APP, "n_nodes": graphs[0].n_nodes,
                     "n_edges": graphs[0].n_edges},
        # the key only on a smoke record: the tracked records have none
        **({"smoke": True} if smoke else {}),
        "steps_per_launch": capture.STEPS_PER_LAUNCH,
        "repeats": repeats,
        "sizes": list(sizes),
        "seq_sample": n_meas,
        "configs": configs,
        "summary": {
            "n_configs": len(configs),
            "geomean_speedup_by_batch_size": geomean_by_b,
            "headline_batch_size": int(headline),
            "headline_geomean_speedup": geomean_by_b[headline],
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    per_b = ";".join(f"B{b}={v:.2f}x" for b, v in geomean_by_b.items())
    print(f"batch_bench,{len(configs) * len(sizes)},headline_B{headline}="
          f"{result['summary']['headline_geomean_speedup']:.2f}x;{per_b}",
          flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke workload, B in 1,4, 2 repeats, written "
                         "under results/torch/smoke/")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--sizes", default=None,
                    help="comma-separated batch sizes (default 1,4,16,64; "
                         "smoke 1,4)")
    ap.add_argument("--seq-sample", type=int, default=SEQ_SAMPLE)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    sizes = (tuple(int(s) for s in args.sizes.split(","))
             if args.sizes else None)
    run_batch_bench(args.out, args.repeats, sizes, args.seq_sample,
                    args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
