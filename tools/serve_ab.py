#!/usr/bin/env python3
"""Serve the capped MLPerf DLRM with the port of several checkouts, in
turns, on one card.

    python3 tools/serve_ab.py [--out FILE] DIR [DIR ...]

Each DIR is a checkout of this repository, for example an unpacked
``git archive`` of another commit under ``build/``; the checkout this
script is in runs as ``cur``.  A run is one process that imports its
checkout's ``chip_smoke`` and calls its phase 5, ``dlrm_phase``: the same
model, requests, seeds and timing in every checkout that has that phase,
each through its own port and its own kernels (built into its own
``build/kernels``).  Runs go in the order cur, DIR..., DIR... reversed,
cur, and each prints its own lines.  At the end, every run's median
request time and median host issue time per cell, and its
``max_memory_allocated``, are printed, and with ``--out`` written as
JSON.  Needs CUDA and ``nvcc``.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
torch.cuda.init()
record = chip_smoke.dlrm_phase(torch.device("cuda", 0))[0]
record.pop("profiles", None)
with open(sys.argv[2], "w") as f:
    json.dump(record, f)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
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
            proc = subprocess.run([sys.executable, "-c", RUN, str(path),
                                   str(result)], cwd=path)
            if proc.returncode != 0:
                print(f"run {i} {name}: exit {proc.returncode}",
                      file=sys.stderr)
                return proc.returncode
            runs.append(dict(run=i, name=name,
                             record=json.loads(result.read_text())))
    for run in runs:
        record = run["record"]
        cells = " ".join(
            f"{cell} median_ms={c['median_ms']:.4f} "
            f"median_host_issue_ms={c['median_host_issue_ms']:.4f}"
            for cell, c in record["cells"].items())
        print(f"run {run['run']} {run['name']}: {cells} "
              f"max_memory_allocated={record['max_memory_allocated']}")
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
