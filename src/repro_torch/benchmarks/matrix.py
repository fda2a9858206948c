"""The paper's workload matrix: every registered app on the six Table II
inputs, each workload swept over the design-space configs.

Counterpart of ``benchmarks/matrix.py``, with its constants, its
``REF_CONFIG`` baseline and its record: per workload (``input/app``)
and config the best-of-``repeats`` seconds of ``run`` on the fused
engine (the capture excluded), iterations and ``converged``, for the
dynamic (``D*``) cells also the direction trace and ``n_sparse``; the
workload's ``best`` cell and ``specialization_gain`` (the ``TG0``
cell's seconds over the best cell's); per input its source, size and
degree profile; and a ``summary`` (geomean gain, the histogram of best
configs, ``n_distinct_best``: the paper's "no single best
configuration").  The port adds ``device`` and ``use_kernels`` (the
reference's ``use_pallas``: K1/K2 on the owned push order, the CSC pull
order and every ``D*`` cell), and the header records them, the card's
name and power limit, and the ``PYTHONHASHSEED`` it ran under:
``paper_graph`` seeds with ``hash(name)``, so only a fixed hash seed
lets another process (``repro_torch.benchmarks.specialize``) profile the
graphs this run timed.

Each input is released before the next one (its graphs, its captured
CUDA graphs and their memory pools), and its ``memory_reserved`` after
its cells is recorded.  MIS and CLR draw their priorities from a fresh
``torch.Generator`` seeded 0 in every run (the reference passes
``jax.random.key(0)``; the two draws differ).

    PYTHONHASHSEED=0 python -m repro_torch.benchmarks.matrix --scale 1

writes ``results/torch/BENCH_matrix.json``.  ``--smoke`` is the
reference's CI subset (scale 256, block 64, TG0 / SG1 / DD1, autotune
off).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
from pathlib import Path

import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.benchmarks.dispatch import card
from repro_torch.core import ALL_CONFIGS, PLAN_CACHE, SystemConfig, run
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import (PAPER_GRAPHS, dataset_graph,
                                        degree_profile, paper_graph)

__all__ = ["run_matrix", "REF_CONFIG", "SMOKE_CONFIGS", "SMOKE_SCALE",
           "FULL_SCALE", "OUT"]

REF_CONFIG = "TG0"
SMOKE_CONFIGS = ("TG0", "SG1", "DD1")
FULL_SCALE = 32
SMOKE_SCALE = 256
FULL_BLOCK = 256
SMOKE_BLOCK = 64
REPEATS = 3
SMOKE_REPEATS = 2
#: the apps whose ``init`` draws priorities, and the seed of their
#: generators (the reference's ``key(0)``)
RANDOMIZED = ("MIS", "CLR")
KEY_SEED = 0
OUT = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "BENCH_matrix.json"


def _geomean(xs):
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 1.0


def _release(device: torch.device) -> None:
    """Drop the cached stand-ins and every cache entry of a collected
    graph (its contexts, captured graphs and their pools)."""
    paper_graph.cache_clear()
    gc.collect()
    PLAN_CACHE.kinds()  # prunes the entries of collected graphs
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_matrix(out_path=OUT, smoke: bool = False, scale: int | None = None,
               repeats: int | None = None, apps=None, graphs=None,
               configs=None, autotune=None, device=None,
               use_kernels: bool = True) -> dict:
    """Sweep the matrix; write the record to ``out_path`` (None: do not
    write) and return it."""
    device = resolve_device(device)
    scale = scale or (SMOKE_SCALE if smoke else FULL_SCALE)
    block_size = SMOKE_BLOCK if smoke else FULL_BLOCK
    repeats = repeats or (SMOKE_REPEATS if smoke else REPEATS)
    apps = list(apps or REGISTRY)
    graphs = list(graphs or PAPER_GRAPHS)
    config_names = list(configs or (SMOKE_CONFIGS if smoke
                                    else [c.name for c in ALL_CONFIGS]))
    if REF_CONFIG not in config_names:
        config_names.insert(0, REF_CONFIG)
    if autotune is None:
        autotune = "off" if smoke else "measure"

    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    launches0 = {"seg_sum": seg_sum.launches,
                 "seg_minmax": seg_minmax.launches}
    inputs = {}
    cells = {}
    for gname in graphs:
        # one weighted and one unweighted materialization per input,
        # shared by its apps
        gw, src_w = dataset_graph(gname, scale=scale, weighted=True,
                                  block_size=block_size)
        gu, _ = dataset_graph(gname, scale=scale, weighted=False,
                              block_size=block_size)
        prof = degree_profile(gu)
        inputs[gname] = {
            "source": src_w,
            "n_nodes": int(gu.n_nodes), "n_edges": int(gu.n_edges),
            "profile": prof["profile"], "signature": prof["signature"],
            "degree_skew": round(prof["degree_skew"], 3),
        }
        for app in apps:
            program = REGISTRY[app]()
            g = gw if program.weighted else gu
            row = {}
            for cname in config_names:
                config = SystemConfig.from_name(cname)
                best = float("inf")
                res = None
                for _ in range(repeats):
                    key = (torch.Generator().manual_seed(KEY_SEED)
                           if app in RANDOMIZED else None)
                    r = run(program, g, config, key=key,
                            use_kernels=use_kernels, autotune=autotune,
                            device=device)
                    if r.seconds < best:
                        best, res = r.seconds, r
                cell = {"seconds": best, "iterations": res.iterations,
                        "converged": res.converged}
                if cname.startswith("D") and res.direction_trace:
                    cell["directions"] = res.direction_trace
                    cell["n_sparse"] = res.sparse_iterations
                row[cname] = cell
            ref = row[REF_CONFIG]["seconds"]
            best_cfg = min(row, key=lambda c: row[c]["seconds"])
            gain = ref / max(row[best_cfg]["seconds"], 1e-12)
            cells[f"{gname}/{app}"] = {
                "configs": row, "best": best_cfg,
                "specialization_gain": gain,
            }
            print(f"matrix {gname}/{app}: best={best_cfg} "
                  f"gain={gain:.2f}x over {REF_CONFIG} "
                  + " ".join(f"{c}={row[c]['seconds']*1e3:.3f}ms"
                             for c in config_names), flush=True)
        del gw, gu, g, program
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            inputs[gname]["memory_reserved"] = \
                torch.cuda.memory_reserved(device)
        _release(device)
        if device.type == "cuda":
            inputs[gname]["memory_reserved_after_release"] = \
                torch.cuda.memory_reserved(device)
            print(f"matrix {gname}: memory_reserved="
                  f"{inputs[gname]['memory_reserved']} after its cells, "
                  f"{inputs[gname]['memory_reserved_after_release']} after "
                  "release", flush=True)

    hist: dict = {}
    for cell in cells.values():
        hist[cell["best"]] = hist.get(cell["best"], 0) + 1
    result = {
        "smoke": smoke,
        "card": card(device),
        "device": str(device),
        "torch": torch.__version__,
        "pythonhashseed": os.environ.get("PYTHONHASHSEED"),
        "workload": {"scale": scale, "block_size": block_size,
                     "repeats": repeats, "autotune": autotune,
                     "use_kernels": bool(use_kernels),
                     "ref_config": REF_CONFIG,
                     "configs": config_names,
                     "apps": apps, "graphs": graphs},
        # K1/K2 wrapper calls (captures, warm-ups, the tuner's timing;
        # a replay calls no wrapper)
        "kernel_launches": {
            "seg_sum": seg_sum.launches - launches0["seg_sum"],
            "seg_minmax": seg_minmax.launches - launches0["seg_minmax"]},
        "inputs": inputs,
        "cells": cells,
        "summary": {
            "n_workloads": len(cells),
            "geomean_specialization_gain": _geomean(
                c["specialization_gain"] for c in cells.values()),
            "best_config_histogram": dict(sorted(hist.items())),
            # the paper's headline claim: no single config wins every
            # workload
            "n_distinct_best": len(hist),
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    s = result["summary"]
    print(f"matrix_summary,{s['n_workloads']},geomean_gain="
          f"{s['geomean_specialization_gain']:.2f}x;"
          f"distinct_best={s['n_distinct_best']}", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny inputs, reduced config set")
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    run_matrix(out_path=args.out, smoke=args.smoke, scale=args.scale,
               repeats=args.repeats, device=args.device)


if __name__ == "__main__":
    main()
