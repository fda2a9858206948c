"""Engine dispatch benchmark: host against fused, µs per iteration.

Counterpart of ``benchmarks/dispatch.py``.  The pinned workload is the
reference's: a Graph500-parameter R-MAT graph (scale 10, edge factor 8,
seed 7) and BFS, run in every cell of the design space
(``ALL_CONFIGS``: the 12 static and the 6 dynamic configs) under both
engines on one device.  Per cell and engine it keeps the best of
``repeats`` runs (after one untimed run that builds and captures):
seconds (host clock, ending in ``torch.cuda.synchronize``), iterations,
dispatches, host syncs and µs per iteration, and per cell the fused
engine's speedup; the summary holds their geometric mean.  The host
engine pays a dispatch of every launch of a step plus one to three
blocking reads per iteration; the fused engine replays a captured graph
of ``STEPS_PER_LAUNCH`` guarded steps and reads once per replay.

    python -m repro_torch.benchmarks.dispatch [--repeats N] [--out PATH]

writes ``results/torch/BENCH_dispatch.json`` (never under
``results/baselines/``) with the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
from pathlib import Path

import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.core import ALL_CONFIGS, SystemConfig, capture, run
from repro_torch.device import resolve_device
from repro_torch.graph import rmat_graph

__all__ = ["PINNED_WORKLOAD", "APP", "ENGINES", "REPEATS", "OUT",
           "run_dispatch", "card"]

#: The pinned workload: change it and the trajectory restarts.
PINNED_WORKLOAD = dict(scale=10, edge_factor=8, seed=7)
APP = "BFS"
ENGINES = ("host", "fused")
REPEATS = 10
OUT = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "BENCH_dispatch.json"


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (the device's name alone off a CUDA device)."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"], check=True,
        capture_output=True, text=True).stdout.strip()


def run_dispatch(out_path=OUT, repeats: int = REPEATS, device=None,
                 scale: int | None = None) -> dict:
    """Run every cell and write the record to ``out_path`` (None: do not
    write); returns the record."""
    device = resolve_device(device)
    wl = dict(PINNED_WORKLOAD)
    if scale is not None:
        wl["scale"] = scale
    program = REGISTRY[APP]()
    g = rmat_graph(weighted=program.weighted, **wl)
    configs = {}
    for cfg in ALL_CONFIGS:
        cell = {}
        for engine in ENGINES:
            config = SystemConfig.from_name(cfg.name)
            run(program, g, config, engine=engine, device=device)
            best = None
            for _ in range(repeats):
                r = run(program, g, config, engine=engine, device=device)
                if best is None or r.seconds < best.seconds:
                    best = r
            cell[engine] = {
                "seconds": best.seconds,
                "iterations": best.iterations,
                "dispatches": best.dispatches,
                "host_syncs": best.host_syncs,
                "us_per_iteration": best.seconds * 1e6
                / max(best.iterations, 1),
            }
        if cell["host"]["iterations"] != cell["fused"]["iterations"]:
            raise AssertionError(f"{cfg.name}: the engines ran "
                                 f"{cell['host']['iterations']} and "
                                 f"{cell['fused']['iterations']} iterations")
        cell["fused_speedup"] = (cell["host"]["us_per_iteration"]
                                 / max(cell["fused"]["us_per_iteration"],
                                       1e-12))
        configs[cfg.name] = cell
    speedups = [c["fused_speedup"] for c in configs.values()]
    result = {
        "card": card(device),
        "device": str(device),
        "torch": torch.__version__,
        "workload": {"generator": "rmat", **wl, "app": APP,
                     "n_nodes": g.n_nodes, "n_edges": g.n_edges},
        "steps_per_launch": capture.STEPS_PER_LAUNCH,
        "repeats": repeats,
        "configs": configs,
        "summary": {
            "n_configs": len(configs),
            "fused_beats_host": sum(s > 1.0 for s in speedups),
            "geomean_fused_speedup": math.exp(
                sum(math.log(s) for s in speedups) / len(speedups)),
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    s = result["summary"]
    print(f"dispatch_bench,{len(configs)},"
          f"fused_beats_host={s['fused_beats_host']}/{s['n_configs']};"
          f"geomean_fused_speedup={s['geomean_fused_speedup']:.2f}x",
          flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args()
    run_dispatch(args.out, args.repeats, args.device)


if __name__ == "__main__":
    main()
