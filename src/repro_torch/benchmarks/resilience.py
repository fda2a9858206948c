"""Resilience benchmark: what checkpointing costs, and what it buys.

Counterpart of ``benchmarks/resilience.py``, on the reference's pinned
dispatch workload (R-MAT scale 10, edge factor 8, seed 7; PR, the
longest-converging pinned app):

1. **Cost when nothing goes wrong.**  Every cell of the 18-config design
   space under the plain fused engine and under ``checkpoint_every=32``
   with the full sentinel battery, best of ``repeats`` after one untimed
   run each (which captures): ``efficiency`` is the plain seconds over
   the checkpointed seconds (1.0 = free).  The two final states must
   agree: bit for bit on the CPU, to atol 1e-6 (iterations +-1) on the
   card, where float sums are not repeatable.
2. **What a checkpoint buys.**  A NaN injected late into PR DG1
   (``checkpoint_every=4``) is recovered from a warm ring and from
   ``ring_capacity=1`` (only the initial snapshot: a cold restart);
   ``recovery_speedup`` is the cold seconds over the warm seconds
   (host clock around the whole ``run`` call, best of ``repeats``).

    python -m repro_torch.benchmarks.resilience [--repeats N] [--out PATH]

writes ``results/torch/BENCH_resilience.json`` with the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.benchmarks.dispatch import PINNED_WORKLOAD, card
from repro_torch.core import (ALL_CONFIGS, DEFAULT_CHECKPOINT_EVERY,
                              DEFAULT_RING_CAPACITY, RetryPolicy,
                              SystemConfig, run)
from repro_torch.device import resolve_device
from repro_torch.graph import rmat_graph
from repro_torch.testing import NaNFault

__all__ = ["APP", "REPEATS", "RECOVERY_K", "OUT", "run_resilience_bench"]

#: PR: long enough (~20 pinned iterations) to amortize a boundary
APP = "PR"
REPEATS = 10
#: short against PR's convergence, so the warm ring resumes near the
#: fault while a cold restart replays the whole prefix
RECOVERY_K = 4
OUT = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "BENCH_resilience.json"


def _best(fn, repeats: int):
    best = None
    for _ in range(repeats):
        r = fn()
        if best is None or r.seconds < best.seconds:
            best = r
    return best


def _agree(a, b, device) -> tuple:
    """(bit_identical, within tolerance) of two PR results."""
    same = all(torch.equal(a.state[k], b.state[k]) for k in a.state)
    if device.type == "cpu":
        return same, same and a.iterations == b.iterations
    close = (abs(a.iterations - b.iterations) <= 1 and torch.allclose(
        a.state["rank"], b.state["rank"], rtol=0, atol=1e-6))
    return same, close


def run_resilience_bench(out_path=OUT, repeats: int = REPEATS, device=None,
                         scale: int | None = None) -> dict:
    """Run both questions and write the record to ``out_path`` (None: do
    not write); returns the record."""
    device = resolve_device(device)
    wl = dict(PINNED_WORKLOAD)
    if scale is not None:
        wl["scale"] = scale
    program = REGISTRY[APP]()
    g = rmat_graph(weighted=program.weighted, **wl)
    K = DEFAULT_CHECKPOINT_EVERY

    configs = {}
    for cfg in ALL_CONFIGS:
        config = SystemConfig.from_name(cfg.name)

        def plain():
            return run(program, g, config, device=device)

        def ckpt():
            return run(program, g, config, checkpoint_every=K, device=device)

        plain(), ckpt()
        p, c = _best(plain, repeats), _best(ckpt, repeats)
        if c.outcome != "converged" or c.fault is not None:
            raise AssertionError(f"{cfg.name}: checkpointed run "
                                 f"{c.outcome}, fault {c.fault}")
        same, close = _agree(p, c, device)
        if not close:
            raise AssertionError(f"{cfg.name}: checkpointed run differs "
                                 "from the plain run")
        configs[cfg.name] = {
            "fused_seconds": p.seconds, "ckpt_seconds": c.seconds,
            "iterations": c.iterations, "plain_iterations": p.iterations,
            "segments": c.resilience["segments"],
            "fused_dispatches": p.dispatches, "ckpt_dispatches": c.dispatches,
            "ckpt_host_syncs": c.host_syncs,
            "boundary_seconds": c.resilience["boundary_seconds"],
            "snapshot_bytes": c.resilience["snapshot_bytes"],
            "sentinel_ms": c.resilience["sentinel_ms"],
            "snapshot_ms": c.resilience["snapshot_ms"],
            "efficiency": p.seconds / max(c.seconds, 1e-12),
            "bit_identical": same, "within_tolerance": close,
        }

    # recovery: a NaN late in the run, from a warm ring and from the
    # initial snapshot alone
    rcfg = SystemConfig.from_name("DG1")
    clean = run(program, g, rcfg, device=device)
    at = max(2 * RECOVERY_K, clean.iterations - RECOVERY_K)
    retry = RetryPolicy(max_attempts=3)

    def recover(capacity):
        def once():
            t0 = time.perf_counter()
            r = run(program, g, rcfg, checkpoint_every=RECOVERY_K,
                    retry=retry, ring_capacity=capacity, device=device,
                    fault_injector=NaNFault(at_iteration=at))
            if not (r.converged and r.fault["recovered"]):
                raise AssertionError(f"recovery: {r.outcome}")
            r.seconds = time.perf_counter() - t0
            return r
        once()
        return _best(once, repeats)

    warm = recover(DEFAULT_RING_CAPACITY)
    cold = recover(1)
    recovery = {
        "app": APP, "config": rcfg.name, "fault": "nan",
        "at_iteration": int(at), "checkpoint_every": RECOVERY_K,
        "clean_iterations": clean.iterations,
        "ckpt_seconds": warm.seconds, "cold_restart_seconds": cold.seconds,
        "ckpt_dispatches": warm.dispatches,
        "cold_dispatches": cold.dispatches,
        "recovery_speedup": cold.seconds / max(warm.seconds, 1e-12),
    }

    effs = [c["efficiency"] for c in configs.values()]
    geomean = math.exp(sum(math.log(max(e, 1e-12)) for e in effs)
                       / len(effs))
    result = {
        "card": card(device), "device": str(device),
        "torch": torch.__version__,
        "workload": {"generator": "rmat", **wl, "app": APP,
                     "n_nodes": g.n_nodes, "n_edges": g.n_edges},
        "checkpoint_every": K, "repeats": repeats,
        "configs": configs, "recovery": recovery,
        "summary": {
            "n_configs": len(configs),
            "n_bit_identical": sum(c["bit_identical"]
                                   for c in configs.values()),
            "n_within_tolerance": sum(c["within_tolerance"]
                                      for c in configs.values()),
            "geomean_efficiency": geomean,
            "geomean_overhead_pct": (1.0 / geomean - 1.0) * 100.0,
            "recovery_speedup": recovery["recovery_speedup"],
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    s = result["summary"]
    print(f"resilience_bench,{len(configs)},"
          f"within_tolerance={s['n_within_tolerance']}/{s['n_configs']};"
          f"bit_identical={s['n_bit_identical']}/{s['n_configs']};"
          f"ckpt_overhead={s['geomean_overhead_pct']:.1f}%;"
          f"recovery_speedup={s['recovery_speedup']:.2f}x", flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    run_resilience_bench(args.out, args.repeats, args.device)


if __name__ == "__main__":
    main()
