#!/usr/bin/env python3
"""Time the graph engines of several checkouts, in turns, on one card.

    python3 tools/engine_ab.py [--out FILE] [--repeats N] DIR [DIR ...]

Each DIR is a checkout of this repository, for example an unpacked
``git archive`` of another commit under ``build/``; the checkout this
script is in runs as ``cur``.  A run is one process that imports its
checkout's ``repro_torch``, builds the AMZ stand-in of this checkout's
``chip_smoke.AMZ`` and runs BFS, SSSP and PR under SD1, TG0 and DD1 with
the kernels, under each engine the checkout has ("host", and "fused"
where it exists): one program per cell and engine, one untimed run,
then ``--repeats`` timed ones (host clock, as ``RunResult.seconds``),
whose median is kept.  Runs go in the order cur, DIR..., DIR...
reversed, cur.  At the end every run's medians are printed, and with
``--out`` written as JSON.  Needs CUDA and ``nvcc``.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RUN = """
import json, statistics, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.algorithms import bfs, pagerank, sssp
from repro_torch.core import SystemConfig, run
from repro_torch.graph import powerlaw_graph
graph = powerlaw_graph(**json.loads(sys.argv[3]))
repeats = int(sys.argv[4])
dev = torch.device("cuda", 0)
out = {}
for cfg in ("SD1", "TG0", "DD1"):
    for name, app in (("BFS", bfs), ("SSSP", sssp), ("PR", pagerank)):
        for engine in ("host", "fused"):
            program = app()
            try:
                runs = [run(program, graph, SystemConfig.from_name(cfg),
                            use_kernels=True, engine=engine, device=dev)
                        for _ in range(repeats + 1)]
            except NotImplementedError:
                continue
            seconds = [r.seconds for r in runs[1:]]
            out[f"{name} {cfg} {engine}"] = dict(
                median_s=statistics.median(seconds), seconds=seconds,
                iterations=runs[-1].iterations,
                dispatches=runs[-1].dispatches,
                host_syncs=runs[-1].host_syncs)
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def main() -> int:
    from chip_smoke import AMZ
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the records as JSON")
    args = ap.parse_args()
    checkouts = [("cur", ROOT)] + [(Path(d).name, Path(d).resolve())
                                   for d in args.dirs]
    order = checkouts + checkouts[1:][::-1] + checkouts[:1]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, path) in enumerate(order):
            print(f"run {i} {name}: {path}", flush=True)
            result = Path(tmp) / f"{i}.json"
            proc = subprocess.run(
                [sys.executable, "-c", RUN, str(path), str(result),
                 json.dumps(AMZ), str(args.repeats)], cwd=path)
            if proc.returncode != 0:
                print(f"run {i} {name}: exit {proc.returncode}",
                      file=sys.stderr)
                return proc.returncode
            runs.append(dict(run=i, name=name,
                             cells=json.loads(result.read_text())))
    for r in runs:
        for cell, c in r["cells"].items():
            print(f"run {r['run']} {r['name']} {cell}: median_s="
                  f"{c['median_s']:.6f} iterations={c['iterations']} "
                  f"dispatches={c['dispatches']} "
                  f"host_syncs={c['host_syncs']}")
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
