"""Autotuner benchmark: tuned against default µs per iteration.

Counterpart of ``benchmarks/autotune.py``, with its three pinned degree
profiles (``PINNED_WORKLOADS``: the Graph500 R-MAT workload the dispatch
benchmark uses, a high-skew power-law graph and a near-regular graph)
and its ``SMOKE_WORKLOADS``.  Each runs BFS in **all 18 configs**
(``ALL_CONFIGS``) on the fused engine with the kernels
(``use_kernels=True``: K1/K2 on the owned push order, the CSC pull order
and every ``D*`` cell), once under the default plans (``autotune="off"``)
and once under tuned plans (``autotune="measure"``).  Per cell the record
keeps both µs-per-iteration figures, their ratio (``speedup``),
whether the two final states are equal (``states_equal``: state,
iterations and traces bit for bit; BFS is exact) and whether both equal
one run of the plain version (``use_kernels=False``) on the same device
(``plain_equal``), so that the kernels are held to their plain versions
at this benchmark's own graphs and tuned plans.  Per workload it keeps
the tuner's own sweeps (``kernels/autotune.py:tune``, candidates timed
as captured CUDA graphs with CUDA events on the card), so the ratios
can be traced to the kernel.

Cells whose tuned context resolves the *same* plans as the default one
(the ``S*G`` cells, which use no blocked reducer, and every cell where
the default won its sweep) replay the same captured graph, so the
default's time is reused and their ratio is exactly 1.0; their
``measure`` run is still made once, untimed, to hold its state against
the default's.

    python -m repro_torch.benchmarks.autotune [--smoke] [--repeats N]

writes ``results/torch/BENCH_autotune.json`` with the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, and the K1/K2 wrapper calls of the
run (captures, warm-ups and the tuner's timing; a replay calls no
wrapper).  Tuned plans persist to ``results/torch/autotune_cache.json``
(ignored by git), keyed by degree signature and card.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.benchmarks.dispatch import card
from repro_torch.core import ALL_CONFIGS, EdgeContext, SystemConfig, run
from repro_torch.device import resolve_device
from repro_torch.graph import powerlaw_graph, regular_graph, rmat_graph
from repro_torch.kernels.autotune import (ORDERS, _device_name,
                                          autotune_plan, degree_features,
                                          degree_signature,
                                          persist_tune_result, tune)

__all__ = ["run_autotune", "PINNED_WORKLOADS", "SMOKE_WORKLOADS", "APP",
           "REPEATS", "ORDERS", "OUT"]

#: The pinned degree profiles: change them and the trajectory restarts.
PINNED_WORKLOADS = {
    "rmat": (rmat_graph, dict(scale=10, edge_factor=8, seed=7)),
    "skew": (powerlaw_graph,
             dict(n=2048, n_edges=24576, alpha=1.6, seed=5)),
    "regular": (regular_graph, dict(n=2048, degree=8, seed=5)),
}
#: CI smoke profiles: same shapes, tiny sizes.
SMOKE_WORKLOADS = {
    "rmat": (rmat_graph, dict(scale=7, edge_factor=8, seed=7)),
    "skew": (powerlaw_graph, dict(n=384, n_edges=4096, alpha=1.6, seed=5)),
    "regular": (regular_graph, dict(n=384, degree=6, seed=5)),
}
APP = "BFS"
REPEATS = 5
PLAN_FIELDS = ("tile_e", "block_mult", "block_div", "gather_splits")
OUT = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "BENCH_autotune.json"


def _best_run(program, g, cfg, repeats, device, **kw):
    best = None
    for _ in range(repeats):
        r = run(program, g, cfg, use_kernels=True, device=device, **kw)
        if best is None or r.seconds < best.seconds:
            best = r
    return best


def _cell(result):
    return {
        "seconds": result.seconds,
        "iterations": result.iterations,
        "us_per_iteration": result.seconds * 1e6
        / max(result.iterations, 1),
    }


def _same(a, b) -> bool:
    """Equal final states, iterations and traces, bit for bit."""
    return (a.iterations == b.iterations
            and a.direction_trace == b.direction_trace
            and a.occupancy_trace == b.occupancy_trace
            and a.state.keys() == b.state.keys()
            and all(torch.equal(a.state[k], b.state[k]) for k in a.state))


def run_autotune(out_path=OUT, smoke: bool = False, repeats: int = REPEATS,
                 device=None) -> dict:
    """Sweep and run every workload; write the record to ``out_path``
    (None: do not write) and return it."""
    device = resolve_device(device)
    workloads = SMOKE_WORKLOADS if smoke else PINNED_WORKLOADS
    max_candidates = 2 if smoke else 6
    program = REGISTRY[APP]()
    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    launches0 = {"seg_sum": seg_sum.launches,
                 "seg_minmax": seg_minmax.launches}
    out_workloads = {}
    for name, (gen, params) in workloads.items():
        g = gen(weighted=program.weighted, **params)
        feats = degree_features(g)

        # Kernel-level sweeps, recorded verbatim.  The winner is >= the
        # default by construction (the default is always a candidate).
        # The sweep's result seeds the disk cache (overwriting a stale
        # entry for this signature and card), so autotune_plan, and
        # through it every autotune="measure" context below, recalls
        # this sweep instead of paying a second one; the *resolved* plan
        # the config runs execute is recorded beside it.
        tuning = {}
        for order in ORDERS:
            cap = (EdgeContext.default_sparse_capacity(g)
                   if order == "gathered" else None)
            res = tune(g, order=order, repeats=repeats,
                       max_candidates=max_candidates, cap_e=cap,
                       device=device)
            tuning[order] = {
                "plan": dict(zip(PLAN_FIELDS, res.plan.astuple())),
                "kernel_speedup_vs_default": res.speedup_vs_default,
                "candidates": [
                    {"tile_e": p.tile_e, "block_mult": p.block_mult,
                     "block_div": p.block_div,
                     "gather_splits": p.gather_splits,
                     "us": s * 1e6} for p, s in res.measurements],
            }
            persist_tune_result(res, cap_e=cap,
                                device_name=_device_name(device))
            resolved = autotune_plan(g, order=order, mode="measure",
                                     repeats=repeats,
                                     max_candidates=max_candidates,
                                     cap_e=cap, device=device)
            tuning[order]["resolved_plan"] = dict(zip(
                PLAN_FIELDS, resolved.astuple()))
            tuning[order]["resolved_source"] = resolved.source

        configs = {}
        for cfg in ALL_CONFIGS:
            config = SystemConfig.from_name(cfg.name)
            ctx_def = EdgeContext.create(g, config, use_kernels=True,
                                         device=device)
            ctx_tuned = EdgeContext.create(g, config, use_kernels=True,
                                           autotune="measure", device=device)
            default = _best_run(program, g, config, repeats, device)
            plans_differ = ctx_tuned.plan_signature != ctx_def.plan_signature
            if plans_differ:
                tuned = _best_run(program, g, config, repeats, device,
                                  autotune="measure")
                if tuned.seconds > default.seconds * 0.95:
                    # near-tie: best-of a second interleaved round for
                    # both modes so scheduler noise, not tiling, can't
                    # decide the reported ratio
                    d2 = _best_run(program, g, config, repeats, device)
                    t2 = _best_run(program, g, config, repeats, device,
                                   autotune="measure")
                    default = min(default, d2, key=lambda r: r.seconds)
                    tuned = min(tuned, t2, key=lambda r: r.seconds)
                checked = tuned
            else:
                # identical resolved plans => the same captured graph;
                # reuse the measurement instead of re-timing it, and
                # check the measure run's state once
                tuned = default
                checked = run(program, g, config, use_kernels=True,
                              device=device, autotune="measure")
            plain = run(program, g, config, use_kernels=False,
                        device=device)
            cell = {"default": _cell(default), "tuned": _cell(tuned),
                    "plans_differ": plans_differ,
                    "states_equal": _same(default, checked),
                    "plain_equal": (_same(default, plain)
                                    and _same(checked, plain))}
            cell["speedup"] = (cell["default"]["us_per_iteration"]
                               / max(cell["tuned"]["us_per_iteration"],
                                     1e-12))
            configs[cfg.name] = cell

        speedups = [c["speedup"] for c in configs.values()]
        out_workloads[name] = {
            "generator": gen.__name__,
            "params": params,
            "n_nodes": g.n_nodes,
            "n_edges": g.n_edges,
            "degree_signature": degree_signature(feats),
            "features": feats,
            "tuning": tuning,
            "configs": configs,
            "summary": {
                "n_configs": len(configs),
                "regressions": sum(s < 1.0 for s in speedups),
                "tuned_cells": sum(c["plans_differ"]
                                   for c in configs.values()),
                "geomean_speedup": math.exp(
                    sum(math.log(s) for s in speedups) / len(speedups)),
                "max_speedup": max(speedups),
            },
        }
        print(f"autotune {name}: "
              + json.dumps(out_workloads[name]["summary"]), flush=True)

    geomeans = {n: w["summary"]["geomean_speedup"]
                for n, w in out_workloads.items()}
    result = {
        "app": APP,
        "repeats": repeats,
        "smoke": smoke,
        "card": card(device),
        "device": str(device),
        "torch": torch.__version__,
        "use_kernels": True,
        "kernel_launches": {
            "seg_sum": seg_sum.launches - launches0["seg_sum"],
            "seg_minmax": seg_minmax.launches - launches0["seg_minmax"]},
        "workloads": out_workloads,
        "summary": {
            "total_regressions": sum(w["summary"]["regressions"]
                                     for w in out_workloads.values()),
            "geomean_by_workload": geomeans,
            "best_workload_geomean": max(geomeans.values()),
            "states_equal": all(c["states_equal"]
                                for w in out_workloads.values()
                                for c in w["configs"].values()),
            "plain_equal": all(c["plain_equal"]
                               for w in out_workloads.values()
                               for c in w["configs"].values()),
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    s = result["summary"]
    per_wl = ";".join(f"{n}={v:.2f}x" for n, v in geomeans.items())
    print(f"autotune_bench,{len(out_workloads) * len(ALL_CONFIGS)},"
          f"regressions={s['total_regressions']};{per_wl}", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny graphs + 2-candidate grid (the CI job)")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    repeats = args.repeats if args.repeats is not None else \
        (2 if args.smoke else REPEATS)
    run_autotune(out_path=args.out, smoke=args.smoke, repeats=repeats,
                 device=args.device)


if __name__ == "__main__":
    main()
