"""The check's control: the plain reference put in the program's place,
computed in the precision below the one the program states, or, where
the configuration states no float precision, breaking the guarantee it
states (``reference/<program>.py``'s ``control``).

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's graph as a run does, solves every
program of the mix with the reference in float64 to its fixpoint (the
yardstick) and with the reference's control, and prints the control's
readings, the numbers the check compares, beside the cell's limits as
one JSON line a seed.  The control must fail the check: a reading
above its limit.  The benchmark's own runs never run it.

    python3 -m perfbench.control --workload <cell> --seeds <n> ... \
        --program-args '{"tol": 1e-5}' ...

reads the program itself, on the timed path, with the mix's arguments
changed by each JSON object (a PageRank stopped early by a looser
``tol``): a fault planted in the program, to show what the limit
catches.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import generators, registry


def control_readings(bench, cell, seed: int, device) -> tuple:
    """The control's readings of ``cell`` on ``seed`` (for each number,
    the worst over the mix's programs) and the graph's size."""
    mix = cell.mix
    coo = generators.generate(cell.config, seed, mix.get("sources", 0),
                              device)
    reference = bench.reference(mix["program"])
    readings: dict = {}
    top = 0.0
    for source in coo.sources or [None]:
        expected = reference.solve(coo, mix["args"], source, device,
                                   torch.float64, exact=True)
        control = reference.control(coo, mix["args"], source, device)
        for name, value in reference.readings([control], expected).items():
            readings[name] = max(readings.get(name, value), value)
        finite = expected[np.isfinite(expected)]
        top = max(top, float(finite.max()))
    deg = np.bincount(coo.src, minlength=coo.n_nodes)
    return readings, {"n_nodes": coo.n_nodes, "n_edges": coo.n_edges,
                      "max_degree": int(deg.max()),
                      "isolated": int((deg == 0).sum()),
                      "largest_expected": top}


def program_readings(bench, cell, seed: int, device, changes: list
                     ) -> tuple:
    """The check's readings, and the mean iterations, of the cell's
    programs run on the timed path with the mix's arguments updated by
    each of ``changes``; the second run of each program is read."""
    from repro_torch import algorithms
    from repro_torch.core import SystemConfig, run
    from repro_torch.graph import Graph

    mix = cell.mix
    coo = generators.generate(cell.config, seed, mix.get("sources", 0),
                              device)
    graph = Graph.from_coo(coo.src, coo.dst, coo.n_nodes, weight=coo.weight)
    config = SystemConfig.from_name(mix["config"])
    reference = bench.reference(mix["program"])
    sources = coo.sources or [None]
    expected = [reference.solve(coo, mix["args"], s, device, torch.float64,
                                exact=True) for s in sources]
    out = []
    for change in changes:
        args = {**mix["args"], **change}
        readings: dict = {}
        iters = []
        for s, want in zip(sources, expected):
            extra = {} if s is None else {mix["source_arg"]: s}
            program = getattr(algorithms, mix["program"])(**args, **extra)
            for _ in range(2):
                res = run(program, graph, config, use_kernels=True,
                          engine="fused", autotune="off", device=device)
            iters.append(res.iterations)
            got = res.extract(program).cpu().numpy()
            for name, value in reference.readings([got], want).items():
                readings[name] = max(readings.get(name, value), value)
        out.append({"args": change, "readings": readings,
                    "iterations": sum(iters) / len(iters)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program-args", type=json.loads, nargs="+",
                   default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    bench = registry.load()
    cell = bench.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.program_args:
            for row in program_readings(bench, cell, seed, args.device,
                                        args.program_args):
                print(json.dumps({
                    "workload": cell.name, "seed": seed, **row,
                    "limits": cell.limits,
                    "fails": any(row["readings"][k] > cell.limits[k]
                                 for k in row["readings"]),
                    "seconds": time.perf_counter() - t0}), flush=True)
            continue
        readings, size = control_readings(bench, cell, seed, args.device)
        print(json.dumps({
            "workload": cell.name, "seed": seed, **size,
            "readings": readings, "limits": cell.limits,
            "fails": any(readings[k] > cell.limits[k] for k in readings),
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
