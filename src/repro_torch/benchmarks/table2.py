"""Table II reproduction: taxonomy metrics for the six inputs.

Counterpart of ``benchmarks/table2.py``, with its two sections per
input: (a) metric classes computed from the PUBLISHED graph statistics
(volume is a pure function of |V|, |E|; reuse comes from AN_L, AN_R and
the average degree), which must equal the paper's exactly; (b) Eqs. 1-7
measured on the synthetic recreation at ``scale=16``.  Both under
``PAPER_GPU``, the paper's simulated GPU, as the reference does: Table
II is that GPU's table.  Profiling is host numpy; ``profile_seconds`` is
the host clock around building and profiling one recreation.

    PYTHONHASHSEED=0 python -m repro_torch.benchmarks.table2

writes ``results/torch/table2.json``: the reference's rows under
``"rows"``, beside the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them and the
hash seed (``paper_graph`` seeds with ``hash(name)``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from repro_torch.benchmarks import RESULTS
from repro_torch.benchmarks.dispatch import card
from repro_torch.core.taxonomy import (PAPER_GPU, classify_reuse,
                                       classify_volume_kb, profile_graph,
                                       reuse_from_an, volume_kb)
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import PAPER_AN, PAPER_STATS, paper_graph

__all__ = ["run_table2", "RESULTS", "SCALE"]

#: the recreations' scale of section (b)
SCALE = 16


def run_table2(out_dir=RESULTS, device=None) -> dict:
    """Both sections for every input; writes ``table2.json`` under
    ``out_dir`` (None: do not write) and returns the record."""
    device = resolve_device(device)
    rows = []
    for name, stats in PAPER_STATS.items():
        v, e, maxd, avgd, volkb, reu, imb, vc, rc, ic = stats
        kb = volume_kb(v, e, PAPER_GPU)
        an_l, an_r = PAPER_AN[name]
        r = reuse_from_an(an_l, an_r, avgd)
        t0 = time.perf_counter()
        g = paper_graph(name, scale=SCALE)
        prof = profile_graph(g, PAPER_GPU)
        dt = time.perf_counter() - t0
        rows.append({
            "graph": name,
            "published": dict(volume_kb=volkb, vol_class=vc, reuse=reu,
                              reuse_class=rc, imb=imb, imb_class=ic),
            "computed_from_published": dict(
                volume_kb=round(kb, 3),
                vol_class=classify_volume_kb(kb, PAPER_GPU),
                reuse=round(r, 4), reuse_class=classify_reuse(r, PAPER_GPU)),
            "measured_on_recreation": dict(
                n_nodes=g.n_nodes, n_edges=g.n_edges,
                volume_kb=round(prof.volume_kb, 3),
                vol_class=prof.volume_class,
                reuse=round(prof.reuse, 4), reuse_class=prof.reuse_class,
                imbalance=round(prof.imbalance, 4),
                imb_class=prof.imbalance_class),
            "profile_seconds": round(dt, 3),
        })
    record = {"card": card(device), "device": str(device),
              "torch": torch.__version__,
              "pythonhashseed": os.environ.get("PYTHONHASHSEED"),
              "hw": PAPER_GPU.name, "scale": SCALE, "rows": rows}
    if out_dir is not None:
        Path(out_dir).mkdir(exist_ok=True, parents=True)
        Path(out_dir, "table2.json").write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(RESULTS))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    for row in run_table2(out_dir=args.out_dir, device=args.device)["rows"]:
        print(row["graph"], row["computed_from_published"],
              row["measured_on_recreation"], flush=True)


if __name__ == "__main__":
    main()
