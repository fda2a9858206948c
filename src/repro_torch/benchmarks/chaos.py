"""Chaos benchmark: kill-and-restart durability.

Counterpart of ``benchmarks/chaos.py``.  The process itself "dies" (a
:class:`~repro_torch.testing.faults.SimulatedProcessDeath`, which no
in-process retry net catches) and a fresh one resumes from what reached
disk.  Three seeded scenarios:

1. **Core kill -> resume** (``checkpoint_dir``): a PR run on the pinned
   dispatch workload (R-MAT 10) is killed after a segment ran but before
   its boundary was persisted, then resumed from the on-disk
   :class:`~repro_torch.core.durability.CheckpointStore`: recovery
   seconds, the lost-work ratio (iterations replayed over total) and the
   resumed state against an uninterrupted run (``bit_identical``; and
   ``agrees``: bit for bit on the CPU, atol 1e-6 with iterations +-1 on
   the card, where float sums are not repeatable).
2. **Gateway kill -> journal recovery**: a journaled
   :class:`~repro_torch.launch.serve.ContinuousScheduler` serving BFS,
   SSSP and CC (exact min monoids: bit-identical whatever the cohort) is
   killed mid-stream; a fresh scheduler replays the write-ahead journal
   and drives the recovered tickets to convergence: recovery seconds,
   lost-work ratio and per-app bit identity against the uninterrupted
   gateway.
3. **Overload at 2x capacity**: after a warm-up wave teaches the
   gateway its service time, a burst of deadline-carrying requests hits
   ``submit``; hopeless deadlines must be shed with ``OverloadError``
   while every admitted request completes.

    python -m repro_torch.benchmarks.chaos [--smoke] [--out PATH]
        [--device DEV]

writes ``results/torch/BENCH_chaos.json`` with the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.  It runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from tempfile import TemporaryDirectory

import numpy as np
import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.benchmarks.dispatch import PINNED_WORKLOAD, card
from repro_torch.core import SystemConfig, run
from repro_torch.core.durability import CheckpointStore
from repro_torch.device import resolve_device
from repro_torch.graph import rmat_batch, rmat_graph
from repro_torch.launch.serve import ContinuousScheduler, OverloadError
from repro_torch.testing.faults import (GatewayKillFault, ProcessKillFault,
                                        SimulatedProcessDeath)

__all__ = ["run_chaos_bench", "OUT"]

#: PR: the longest pinned convergence, so the kill lands deep enough
#: that a cold restart is expensive
CORE_APP = "PR"
CORE_K = 4
#: exact min monoids: bit identity holds across cohort changes
GATEWAY_APPS = ("BFS", "SSSP", "CC")
SMOKE_SCALE = 9
GATEWAY_SCALE = 6
GATEWAY_POOL = 3
GATEWAY_REQUESTS = 6
KILL_AFTER_SLICES = 2
OUT = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "BENCH_chaos.json"


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _states_equal(a, b) -> bool:
    return set(a) == set(b) and all(
        np.array_equal(_host(a[k]), _host(b[k])) for k in a)


# ----------------------------------------------------------------------
def _core_chaos(smoke: bool, device) -> dict:
    wl = dict(PINNED_WORKLOAD)
    if smoke:
        wl["scale"] = SMOKE_SCALE
    program = REGISTRY[CORE_APP]()
    g = rmat_graph(weighted=program.weighted, **wl)
    config = SystemConfig.from_name("DG1")

    clean = run(program, g, config, checkpoint_every=CORE_K, device=device)
    total = clean.iterations
    kill_at = max(CORE_K, total - CORE_K)

    with TemporaryDirectory() as d:
        try:
            run(program, g, config, checkpoint_every=CORE_K,
                checkpoint_dir=d, device=device,
                fault_injector=ProcessKillFault(at_iteration=kill_at,
                                                point="after_segment"))
            raise RuntimeError("kill injector never fired")
        except SimulatedProcessDeath:
            pass
        # the killed segment's end minus the newest persisted boundary
        # is the work that must be replayed
        cp, _ = CheckpointStore(d).load_latest()
        resume_it = cp.it if cp is not None else 0
        killed_it = min(resume_it + CORE_K, total)
        t0 = time.perf_counter()
        resumed = run(program, g, config, checkpoint_every=CORE_K,
                      checkpoint_dir=d, device=device)
        recovery_seconds = time.perf_counter() - t0

    same = _states_equal(clean.state, resumed.state)
    if device.type == "cpu":
        agrees = same and clean.iterations == resumed.iterations
    else:
        agrees = (abs(clean.iterations - resumed.iterations) <= 1
                  and bool(torch.allclose(resumed.state["rank"],
                                          clean.state["rank"], rtol=0,
                                          atol=1e-6)))
    replayed = killed_it - resume_it
    return {
        "app": CORE_APP, "checkpoint_every": CORE_K, "scale": wl["scale"],
        "total_iterations": int(total), "kill_at": int(killed_it),
        "resume_iteration": int(resume_it),
        "replayed_iterations": int(replayed),
        "lost_work_ratio": replayed / max(total, 1),
        "cold_restart_ratio": killed_it / max(total, 1),
        "recovery_seconds": recovery_seconds,
        "bit_identical": same,
        "agrees": agrees,
        "converged": bool(resumed.converged),
    }


# ----------------------------------------------------------------------
def _gateway_chaos(smoke: bool, device) -> dict:
    scale = GATEWAY_SCALE if smoke else GATEWAY_SCALE + 2
    pool = rmat_batch(GATEWAY_POOL, scale, seed=7)
    apps = {}
    total_replayed = 0
    total_killed = 0
    total_iters = 0
    recovery_seconds = 0.0
    for app in GATEWAY_APPS:
        program = REGISTRY[app]()
        config = SystemConfig.from_name("DG1")

        ref = ContinuousScheduler(max_batch=4, slice_len=2, device=device)
        ref_tickets = [ref.submit(program, pool[i % GATEWAY_POOL], config)
                       for i in range(GATEWAY_REQUESTS)]
        ref.run_until_idle()
        ref_results = [t.result(0) for t in ref_tickets]

        with TemporaryDirectory() as d:
            sched = ContinuousScheduler(
                max_batch=4, slice_len=2, journal_dir=d, device=device,
                fault_injector=GatewayKillFault(
                    after_slices=KILL_AFTER_SLICES))
            tickets = [sched.submit(program, pool[i % GATEWAY_POOL],
                                    config)
                       for i in range(GATEWAY_REQUESTS)]
            try:
                sched.run_until_idle()
                raise RuntimeError("gateway kill never fired")
            except SimulatedProcessDeath:
                pass
            # the progress the dead gateway had committed
            killed_it = {}
            for lane in sched._lanes.values():
                for i, t in enumerate(lane.tickets):
                    if t is not None:
                        killed_it[t.jid] = lane.it_b[i]
                for t in lane.queue:
                    killed_it[t.jid] = 0

            t0 = time.perf_counter()
            fresh = ContinuousScheduler(max_batch=4, slice_len=2,
                                        device=device)
            recovered = fresh.recover(d)
            resume_it = {t.jid: (t._restore[1] if t._restore else 0)
                         for t in recovered}
            fresh.run_until_idle()
            recovery_seconds += time.perf_counter() - t0

        by_jid = {t.jid: t.result(0) for t in tickets if t.done()}
        by_jid.update({t.jid: t.result(0) for t in recovered})
        ordered = [by_jid[t.jid] for t in tickets]
        identical = all(_states_equal(r.state, c.state)
                        for r, c in zip(ref_results, ordered))
        replayed = sum(killed_it[j] - resume_it[j] for j in resume_it)
        total_replayed += replayed
        total_killed += sum(killed_it.values())
        total_iters += sum(r.iterations for r in ordered)
        apps[app] = {
            "requests": GATEWAY_REQUESTS,
            "recovered": len(recovered),
            "replayed_iterations": int(replayed),
            "bit_identical": bool(identical),
            "all_converged": all(r.converged for r in ordered),
        }
    return {
        "apps": apps, "pool": GATEWAY_POOL, "scale": scale,
        "kill_after_slices": KILL_AFTER_SLICES,
        "recovery_seconds": recovery_seconds,
        "replayed_iterations": int(total_replayed),
        "total_iterations": int(total_iters),
        "lost_work_ratio": total_replayed / max(total_iters, 1),
        "cold_restart_ratio": total_killed / max(total_iters, 1),
        "n_bit_identical": sum(a["bit_identical"] for a in apps.values()),
    }


# ----------------------------------------------------------------------
def _overload_chaos(device) -> dict:
    program = REGISTRY["BFS"]()
    config = SystemConfig.from_name("DG1")
    g = rmat_graph(scale=GATEWAY_SCALE, edge_factor=8, seed=3,
                   weighted=False)
    sched = ContinuousScheduler(max_batch=2, slice_len=2, device=device)

    # warm-up wave: teach the gateway its service time
    warm = [sched.submit(program, g, config) for _ in range(4)]
    sched.run_until_idle()
    for t in warm:
        t.result(0)
    mean_latency = float(np.mean(sched.stats.latencies_s))

    # a 2x-capacity burst with deadlines one wave of service can meet
    # but a growing queue cannot: the projection sheds the hopeless tail
    offered = 4 * sched.max_batch
    deadline = 1.5 * mean_latency
    admitted, shed = [], 0
    for _ in range(offered):
        try:
            admitted.append(sched.submit(program, g, config,
                                         deadline_s=deadline))
        except OverloadError:
            shed += 1
    sched.run_until_idle()
    completed = sum(1 for t in admitted
                    if t.done() and t.result(0) is not None)
    return {
        "offered": offered, "admitted": len(admitted), "shed": shed,
        "shed_rate": shed / max(offered, 1),
        "deadline_s": deadline, "mean_warm_latency_s": mean_latency,
        "completed": completed,
        "contained": bool(shed > 0 and completed == len(admitted)),
    }


# ----------------------------------------------------------------------
def run_chaos_bench(out_path=OUT, smoke: bool = False, device=None) -> dict:
    """Run the three scenarios and write the record to ``out_path``
    (None: do not write); returns the record."""
    device = resolve_device(device)
    core = _core_chaos(smoke, device)
    gateway = _gateway_chaos(smoke, device)
    overload = _overload_chaos(device)
    result = {
        "card": card(device),
        "device": str(device),
        "torch": torch.__version__,
        "smoke": bool(smoke),
        "workload": {"core_app": CORE_APP, "core_k": CORE_K,
                     "gateway_apps": list(GATEWAY_APPS),
                     "gateway_pool": GATEWAY_POOL,
                     "gateway_requests": GATEWAY_REQUESTS},
        "core": core,
        "gateway": gateway,
        "overload": overload,
        "summary": {
            "core_lost_work_ratio": core["lost_work_ratio"],
            "gateway_lost_work_ratio": gateway["lost_work_ratio"],
            "recovery_seconds": (core["recovery_seconds"]
                                 + gateway["recovery_seconds"]),
            "n_bit_identical": (int(core["bit_identical"])
                                + gateway["n_bit_identical"]),
            "n_identity_checks": 1 + len(gateway["apps"]),
            "core_agrees": core["agrees"],
            "shed_rate": overload["shed_rate"],
            "overload_contained": overload["contained"],
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    s = result["summary"]
    print(f"chaos_bench,"
          f"bit_identical={s['n_bit_identical']}/{s['n_identity_checks']};"
          f"core_agrees={s['core_agrees']};"
          f"core_lost_work={s['core_lost_work_ratio']:.3f};"
          f"gateway_lost_work={s['gateway_lost_work_ratio']:.3f};"
          f"shed_rate={s['shed_rate']:.2f};"
          f"recovery={s['recovery_seconds']:.2f}s", flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    run_chaos_bench(args.out, args.smoke, args.device)


if __name__ == "__main__":
    main()
