"""Fig. 6 reproduction: workloads where SGR is NOT optimal, the time of
the best config relative to SGR (DGR for CC, which runs the dynamic
cells only).

Counterpart of ``benchmarks/fig6.py``: pure JSON over this port's
``results/torch/fig5.json``.

    python -m repro_torch.benchmarks.fig6

writes ``results/torch/fig6.json`` (the reference's keys beside the card
Fig. 5 ran on).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.benchmarks.fig5 import RESULTS

__all__ = ["run_fig6"]


def run_fig6(out_dir=RESULTS, fig5_path=RESULTS / "fig5.json") -> dict:
    """The cases and their reductions; writes ``fig6.json`` under
    ``out_dir`` (None: do not write) and returns the record."""
    record = json.loads(Path(fig5_path).read_text())
    fig5 = record["cells"]
    rows = {}
    reductions = []
    for key, entry in fig5.items():
        cfgs = entry["configs"]
        ref = "SGR" if "SGR" in cfgs else "DGR"
        best = entry["best"]
        if best == ref:
            continue
        red = 1.0 - cfgs[best]["seconds"] / cfgs[ref]["seconds"]
        rows[key] = {
            "ref": ref,
            "best": best,
            "best_over_ref": round(cfgs[best]["seconds"]
                                   / cfgs[ref]["seconds"], 4),
            "reduction_pct": round(100 * red, 1),
        }
        reductions.append(red)
    out = {
        "card": record["card"],
        "cases": rows,
        "n_cases": len(rows),
        "avg_reduction_pct": round(100 * sum(reductions)
                                   / max(len(reductions), 1), 1),
        "max_reduction_pct": round(100 * max(reductions, default=0.0), 1),
    }
    if out_dir is not None:
        Path(out_dir).mkdir(exist_ok=True, parents=True)
        Path(out_dir, "fig6.json").write_text(json.dumps(out, indent=2))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(RESULTS))
    ap.add_argument("--fig5", default=str(RESULTS / "fig5.json"))
    args = ap.parse_args(argv)
    res = run_fig6(out_dir=args.out_dir, fig5_path=args.fig5)
    print(f"{res['n_cases']} workloads where the reference config is "
          f"not optimal; avg reduction {res['avg_reduction_pct']}%, "
          f"max {res['max_reduction_pct']}%", flush=True)


if __name__ == "__main__":
    main()
