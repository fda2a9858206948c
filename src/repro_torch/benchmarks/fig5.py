"""Fig. 5 reproduction: apps x inputs x design-space configs, measured
execution time of converged runs, the capture excluded.

Counterpart of ``benchmarks/fig5.py``, with its configs per app
(``STATIC_SHOWN`` plus DG1 and DD1; CC on ``DYNAMIC_SHOWN`` only), its
``REPEATS`` and its record: per workload (``input/app``) and config the
best-of-``REPEATS`` seconds of ``run`` (host clock, ending in
``torch.cuda.synchronize``), iterations and ``normalized`` (over the
first config's seconds); for the dynamic (``D*``) cells the per-iteration
direction trace ("S" = push, "T" = pull), its push and pull counts, and
the sparse-gather residency (``n_sparse``, ``n_dense``,
``mean_sparse_occupancy``); and the workload's ``best`` config.  The
port adds ``converged`` to every cell.

As in the reference, ``use_kernels`` is left at its default (the plain
scatter reductions) and so is ``autotune``: Fig. 5 ranks the design
space's own configs, not K1/K2's tilings (``benchmarks/matrix.py`` runs
the kernel orders).  MIS and CLR draw their priorities from a fresh
``torch.Generator`` seeded 0 in every run (the reference passes
``jax.random.key(0)``; the two draws differ, so their iterations are
the port's own).  Each input is released before the next (its graphs,
captured CUDA graphs and their pools).

    PYTHONHASHSEED=0 python -m repro_torch.benchmarks.fig5 --scale 1

writes ``results/torch/fig5.json``: the reference's workloads under
``"cells"``, beside the card's name and power limit, the hash seed
(``paper_graph`` seeds with ``hash(name)``) and the workload.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.benchmarks import RESULTS
from repro_torch.benchmarks.dispatch import card
from repro_torch.benchmarks.matrix import KEY_SEED, RANDOMIZED, _release
from repro_torch.core import SystemConfig, run
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import PAPER_GRAPHS, paper_graph

__all__ = ["run_fig5", "STATIC_SHOWN", "DYNAMIC_SHOWN",
           "TRAVERSAL_APPS", "SCALE", "REPEATS", "RESULTS"]

STATIC_SHOWN = ("TG0", "SG1", "SGR", "SD1", "SDR")
DYNAMIC_SHOWN = ("DG1", "DGR", "DD1", "DDR")
#: frontier-protocol traversal apps (kept for harness consumers); every
#: registered app speaks the protocol and runs the dynamic cells with a
#: populated direction trace.
TRAVERSAL_APPS = ("BFS", "SSSP", "BC")
SCALE = 32
REPEATS = 3


def _configs_for(app: str):
    if app == "CC":
        # CC's hooking direction is inherently per-round (alternating):
        # the paper shows it on the dynamic cells only
        return DYNAMIC_SHOWN
    return STATIC_SHOWN + ("DG1", "DD1")


def run_fig5(out_dir=RESULTS, scale=SCALE, apps=None, graphs=None,
             engine="fused", device=None) -> dict:
    """Sweep apps x inputs x configs under one execution engine; writes
    ``fig5.json`` under ``out_dir`` (None: do not write) and returns the
    record, whose ``"cells"`` are the reference's workloads.

    ``engine="fused"`` (default) times device work: replays of a
    captured CUDA graph with one poll per replay (the first run of each
    cell captures, outside the timer of its later runs).
    """
    device = resolve_device(device)
    apps = list(apps or REGISTRY)
    graphs = list(graphs or PAPER_GRAPHS)
    results = {}
    for gname in graphs:
        for app in apps:
            program = REGISTRY[app]()
            g = paper_graph(gname, scale=scale, weighted=program.weighted)
            configs = _configs_for(app)
            row = {}
            for cname in configs:
                cfg = SystemConfig.from_name(cname)
                best = float("inf")
                res = None
                for _ in range(REPEATS):
                    key = (torch.Generator().manual_seed(KEY_SEED)
                           if app in RANDOMIZED else None)
                    r = run(program, g, cfg, key=key, engine=engine,
                            device=device)
                    best = min(best, r.seconds)
                    res = r
                row[cname] = {"seconds": best,
                              "iterations": res.iterations,
                              "converged": res.converged}
                if cname.startswith("D") and res.direction_trace is not None:
                    trace = res.direction_trace
                    row[cname]["directions"] = trace
                    row[cname]["n_push"] = trace.count("S")
                    row[cname]["n_pull"] = trace.count("T")
                    if res.occupancy_trace is not None:
                        row[cname]["n_sparse"] = res.sparse_iterations
                        row[cname]["n_dense"] = (res.iterations
                                                 - res.sparse_iterations)
                        occ = res.mean_sparse_occupancy
                        row[cname]["mean_sparse_occupancy"] = (
                            round(occ, 4) if occ is not None else None)
            base = row[configs[0]]["seconds"]
            for cname in configs:
                row[cname]["normalized"] = row[cname]["seconds"] / base
            best_cfg = min(row, key=lambda c: row[c]["seconds"])
            results[f"{gname}/{app}"] = {"configs": row, "best": best_cfg}
            dyn = " ".join(f"{c}:{row[c]['directions']}"
                           for c in configs
                           if "directions" in row[c])
            occ = " ".join(
                f"{c}:{row[c]['n_sparse']}/{row[c]['iterations']}"
                f"@{row[c]['mean_sparse_occupancy']}"
                for c in configs
                if row[c].get("n_sparse"))  # 0 sparse iters: nothing to show
            print(f"{gname}/{app}: best={best_cfg} "
                  + " ".join(f"{c}={row[c]['seconds']*1e3:.3f}ms"
                             for c in configs)
                  + (f" dirs[{dyn}]" if dyn else "")
                  + (f" sparse[{occ}]" if occ else ""), flush=True)
        del g, program
        _release(device)
    record = {"card": card(device), "device": str(device),
              "torch": torch.__version__,
              "pythonhashseed": os.environ.get("PYTHONHASHSEED"),
              "workload": {"scale": scale, "apps": apps, "graphs": graphs,
                           "engine": engine, "repeats": REPEATS,
                           "use_kernels": False, "autotune": "off"},
              "cells": results}
    if out_dir is not None:
        Path(out_dir).mkdir(exist_ok=True, parents=True)
        Path(out_dir, "fig5.json").write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(RESULTS))
    ap.add_argument("--scale", type=int, default=SCALE)
    ap.add_argument("--apps", default=None, help="comma-separated subset")
    ap.add_argument("--graphs", default=None, help="comma-separated subset")
    ap.add_argument("--engine", default="fused", choices=("fused", "host"))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    split = lambda s: s.split(",") if s else None  # noqa: E731
    run_fig5(out_dir=args.out_dir, scale=args.scale, apps=split(args.apps),
             graphs=split(args.graphs), engine=args.engine,
             device=args.device)


if __name__ == "__main__":
    main()
