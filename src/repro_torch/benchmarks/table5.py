"""Table V reproduction: the specialization model's predictions.

Counterpart of ``benchmarks/table5.py``:

(a) *Paper-faithful*: predictions from the published Table II classes,
    which must equal Table V exactly (36/36).
(b) *Deployed*: predictions from the classes measured on the
    recreations (``profile_graph`` under ``PAPER_GPU``) against the
    empirical best of this port's Fig. 5 sweep (``results/torch/
    fig5.json``) on the card: exact hits and the performance gap of the
    mispredictions, as the paper's Sec. VI reports them.

    PYTHONHASHSEED=0 python -m repro_torch.benchmarks.table5 --scale 1

writes ``results/torch/table5.json`` (the reference's keys beside the
card's name and power limit).  ``--scale`` must be the scale Fig. 5 ran
at, so that (b) profiles the graphs Fig. 5 timed; the hash seed must be
Fig. 5's too (``paper_graph`` seeds with ``hash(name)``).
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


from repro_torch.benchmarks.dispatch import card
from repro_torch.benchmarks.fig5 import RESULTS, SCALE
from repro_torch.core import TABLE_III, GraphProfile, specialize
from repro_torch.core.taxonomy import profile_graph
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import PAPER_STATS, paper_graph

__all__ = ["run_table5", "TABLE_V"]

TABLE_V = {
    "AMZ": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR", CC="DD1"),
    "DCT": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR", CC="DD1"),
    "EML": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR", CC="DD1"),
    "OLS": dict(PR="SDR", SSSP="SDR", MIS="TG0", CLR="TG0", BC="SDR", CC="DD1"),
    "RAJ": dict(PR="SDR", SSSP="SDR", MIS="SDR", CLR="SDR", BC="SDR", CC="DD1"),
    "WNG": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR", CC="DD1"),
}


def run_table5(out_dir=RESULTS, fig5_path=RESULTS / "fig5.json",
               scale=SCALE, device=None) -> dict:
    """Both sections; writes ``table5.json`` under ``out_dir`` (None: do
    not write) and returns the record."""
    device = resolve_device(device)
    # (a) paper-faithful
    exact = 0
    preds = {}
    for gname, stats in PAPER_STATS.items():
        prof = GraphProfile.from_classes(*stats[7:10])
        preds[gname] = {}
        for app in TABLE_V[gname]:
            p = specialize(TABLE_III[app], prof).name
            preds[gname][app] = p
            exact += p == TABLE_V[gname][app]
    paper_faithful = {"predictions": preds, "match_table_v": f"{exact}/36"}

    # (b) deployed (measured classes + measured best)
    deployed = {}
    fig5 = (json.loads(Path(fig5_path).read_text())["cells"]
            if Path(fig5_path).exists() else {})
    hits, within = 0, []
    for gname in TABLE_V:
        prof = profile_graph(paper_graph(gname, scale=scale))
        for app in TABLE_V[gname]:
            pred = specialize(TABLE_III[app], prof).name
            key = f"{gname}/{app}"
            entry = {"predicted": pred,
                     "measured_classes": [prof.volume_class,
                                          prof.reuse_class,
                                          prof.imbalance_class]}
            if key in fig5:
                row = fig5[key]["configs"]
                best = fig5[key]["best"]
                entry["empirical_best"] = best
                entry["hit"] = pred == best
                if pred in row:
                    gap = row[pred]["seconds"] / row[best]["seconds"] - 1
                    entry["gap_vs_best"] = round(gap, 4)
                    within.append(gap)
                hits += entry.get("hit", False)
            deployed[key] = entry
    out = {
        "card": card(device),
        "pythonhashseed": os.environ.get("PYTHONHASHSEED"),
        "scale": scale,
        "paper_faithful": paper_faithful,
        "deployed": deployed,
        "deployed_exact_hits": hits,
        "deployed_mean_gap": (sum(within) / len(within)) if within else None,
    }
    if out_dir is not None:
        Path(out_dir).mkdir(exist_ok=True, parents=True)
        Path(out_dir, "table5.json").write_text(json.dumps(out, indent=2))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(RESULTS))
    ap.add_argument("--fig5", default=str(RESULTS / "fig5.json"))
    ap.add_argument("--scale", type=int, default=SCALE)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    res = run_table5(out_dir=args.out_dir, fig5_path=args.fig5,
                     scale=args.scale, device=args.device)
    print("paper-faithful:", res["paper_faithful"]["match_table_v"])
    print("deployed exact hits:", res["deployed_exact_hits"],
          "mean gap:", res["deployed_mean_gap"], flush=True)


if __name__ == "__main__":
    main()
