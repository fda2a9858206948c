"""One cell's perf report (counterpart of ``repro.launch.perf``): run ONE
dry-run cell and print its memory, cost, collective totals and the top
collectives, each attributed to the function of the port that issued it.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch command-r-plus-104b \\
        --shape train_4k [--multi-pod] [--top 15] [--dump-trace out.json]

The reference parses its compiled HLO and flags collectives in
while-loop bodies ``[SCAN]``: XLA counts a scanned layer once, so those
repeat ``n_layers`` times at run time.  The port loops its layers in
Python and counts every collective of every layer, so it has no such
flag.  Its attribution is the innermost frame of the port's model,
optimizer or config code on the stack when DTensor issued the
collective (``models/transformer.py:_attention``, ...): the models keep
their parameters in modules but do not run as ``nn.Module.forward``, so
``CommDebugMode``'s module tracking would attribute everything to the
top level.  ``--dump-trace`` writes every (kind, caller) total and the
FLOPs by op as JSON, in place of ``--dump-hlo``.
"""
from __future__ import annotations

import argparse
import collections
import json

from repro_torch.launch.dryrun import run_cell

__all__ = ["top_collectives", "main"]


def top_collectives(sites, top: int = 15):
    """(kind, caller) byte totals, largest first, and the totals by kind."""
    rows = sorted(({"kind": k, "caller": c, "bytes": b}
                   for (k, c), b in sites), key=lambda r: -r["bytes"])
    agg = collections.Counter()
    for r in rows:
        agg[r["kind"]] += r["bytes"]
    return rows[:top], dict(agg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--dump-trace", default=None)
    args = ap.parse_args(argv)

    sites = []
    res = run_cell(args.arch, args.shape, args.multi_pod, verbose=False,
                   sites=sites)
    print(json.dumps({"memory": res["memory"],
                      "cost": {k: v for k, v in res["cost"].items()
                               if k != "flops_by_op"},
                      "step_s": res["step_s"]}, indent=2))
    rows, agg = top_collectives(sites, args.top)
    if args.dump_trace:
        with open(args.dump_trace, "w") as f:
            json.dump({"collectives": [dict(kind=k, caller=c, bytes=b)
                                       for (k, c), b in sites],
                       "flops_by_op": res["cost"]["flops_by_op"]}, f,
                      indent=1)
    print("\n== collective totals (per rank, every layer counted)")
    for k, v in sorted(agg.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<20} {v / 1e9:8.3f} GB   "
              f"({res['collectives'][k]['count']} calls)")
    print("\n== top collectives")
    for r in rows:
        print(f"  {r['kind']:<18} {r['bytes'] / 1e9:8.3f} GB  "
              f"in {r['caller']}")


if __name__ == "__main__":
    main()
