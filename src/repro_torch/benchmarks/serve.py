"""Serving-gateway load benchmark: continuous batching against a serial
``run()`` server.

Counterpart of ``benchmarks/serve.py``.  One pinned request stream
(``requests`` queries cycling through a pool of same-bucket R-MAT
graphs, one app, one config) in two arrival modes:

- **closed loop**: ``clients`` concurrent clients, each submitting its
  next request when the previous one completes (saturation
  throughput).  The gateway serves the stream through
  :class:`~repro_torch.launch.serve.GraphGateway`; the serial baseline
  replays the same stream against one ``run()`` server (measured
  per-graph service times, FIFO queue simulated).
- **open loop**: seeded Poisson arrivals at ``LAMBDA_X`` times the serial
  server's measured capacity (latency under load): timed submissions to
  the gateway, the same schedule through the serial queue model.

Per mode the record holds the gateway's and the serial server's
``{throughput_rps, p50_ms, p99_ms}``, ``throughput_speedup`` (gateway
over serial) and ``p99_gain`` (serial p99 over gateway p99), and the
gateway's slices, replays, roster rebuilds and mean occupancy.  A
serial request's time covers ``run()`` and the copy of its state to
the host, since the gateway hands out host arrays.

Both sides are warm before timing: each gateway window grows its roster
with one warm-up wave, and the serial server runs each graph once (the
fused engine captures there).  The two sides are measured in turns
under the same host load: before every gateway window the serial
server's per-graph service seconds are measured again (best of
``SOLO_REPEATS`` each), and that window's ratios are taken against them
(one serial measurement before all the windows goes stale as the host's
load drifts).  The windows run solo, closed, solo, open, ...
(``windows`` in the record), ``repeats`` of each mode: 15 at the pinned
workload, where the reference takes 5.  Each mode keeps the best of its
pairs: throughput from the pair of the highest ``throughput_speedup``,
p99 from the pair of the highest ``p99_gain``.  ``pairs`` lists every
pair with the slice graphs its gateway window captured (a roster the
gateway has not packed before is captured inside the window that meets
it, a cost a real stream pays).  The open loop's arrival schedule is
fixed by a first serial measurement.  The port's gateway sits below the
gate's caps, so its ratios are read unclamped.

    python -m repro_torch.benchmarks.serve [--smoke] [--repeats N]
        [--out PATH] [--device DEV]

writes ``results/torch/BENCH_serve.json`` with the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.  It runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.benchmarks.dispatch import card
from repro_torch.core import PLAN_CACHE, SystemConfig, run
from repro_torch.device import resolve_device
from repro_torch.graph import rmat_batch
from repro_torch.launch.serve import GraphGateway

__all__ = ["run_serve_bench", "PINNED_WORKLOAD", "SMOKE_WORKLOAD", "OUT"]

#: The pinned stream: change it and the trajectory restarts.
PINNED_WORKLOAD = dict(scale=6, edge_factor=8, seed=7, pool=8,
                       requests=96, clients=16)
SMOKE_WORKLOAD = dict(scale=5, edge_factor=8, seed=7, pool=4,
                      requests=64, clients=8)
#: windows per mode at the pinned workload
PINNED_REPEATS = 15
#: timed runs per graph of each serial measurement (after one untimed)
SOLO_REPEATS = 5
APP = "BFS"
CONFIG = "DG1"
MAX_BATCH = 8
SLICE_LEN = 8
#: open-loop arrival rate as a multiple of the serial server's capacity
LAMBDA_X = 1.2
OUT = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "BENCH_serve.json"


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def _measure_solo(program, pool, config, repeats: int, device):
    """Warm per-graph service seconds of a serial server: ``run()`` and
    the copy of its state to the host, best of ``repeats`` after one
    untimed run."""
    def serve(g):
        res = run(program, g, config, device=device)
        return {k: v.cpu() for k, v in res.state.items()}

    service = []
    for g in pool:
        serve(g)
        best = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            serve(g)
            dt = time.perf_counter() - t0
            best = dt if best is None or dt < best else best
        service.append(best)
    return service


def _solo_closed(service_by_req, clients: int):
    """Closed-loop FIFO replay against one serial server: client k
    resubmits the instant its previous request completes."""
    n = len(service_by_req)
    next_submit = [0.0] * clients
    server_free = 0.0
    latencies = []
    for i in range(n):
        arr = next_submit[i % clients]
        done = max(server_free, arr) + service_by_req[i]
        server_free = done
        latencies.append(done - arr)
        next_submit[i % clients] = done
    return latencies, n / server_free


def _solo_open(service_by_req, arrivals):
    """Open-loop FIFO replay: fixed arrival schedule, serial server."""
    server_free = 0.0
    latencies = []
    for arr, s in zip(arrivals, service_by_req):
        done = max(server_free, arr) + s
        server_free = done
        latencies.append(done - arr)
    return latencies, len(arrivals) / server_free


def _warmup(gw, program, pool, config, max_batch):
    """Grow the roster to steady state (captures included), then reset
    the stats so the measured window starts warm."""
    warm = [gw.submit(program, pool[i % len(pool)], config)
            for i in range(max(max_batch, len(pool)))]
    for t in warm:
        t.result(timeout=600)
    gw.reset_stats()


def _captures() -> int:
    """Captured engines built so far (``exec_fn`` misses)."""
    return PLAN_CACHE.stats()["by_kind"].get("exec_fn", {}).get("misses", 0)


def _gateway_closed(program, pool, config, n_requests, clients,
                    max_batch, slice_len, device):
    """Serve the closed-loop stream through the gateway."""
    with GraphGateway(max_batch=max_batch, slice_len=slice_len,
                      device=device) as gw:
        _warmup(gw, program, pool, config, max_batch)
        captures = _captures()
        latencies = [None] * n_requests

        def client(k):
            for i in range(k, n_requests, clients):
                t = gw.submit(program, pool[i % len(pool)], config)
                latencies[i] = t.result(timeout=600).seconds
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        snap = dict(gw.stats(), captures=_captures() - captures)
    return latencies, n_requests / wall, snap


def _gateway_open(program, pool, config, n_requests, interarrivals,
                  max_batch, slice_len, device):
    """Timed Poisson submissions against the running gateway."""
    with GraphGateway(max_batch=max_batch, slice_len=slice_len,
                      max_queue=4 * n_requests, device=device) as gw:
        _warmup(gw, program, pool, config, max_batch)
        captures = _captures()
        tickets = []
        t0 = time.perf_counter()
        due = 0.0
        for i in range(n_requests):
            due += interarrivals[i]
            lag = due - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            tickets.append(gw.submit(program, pool[i % len(pool)], config))
        results = [t.result(timeout=600) for t in tickets]
        wall = time.perf_counter() - t0
        snap = dict(gw.stats(), captures=_captures() - captures)
    return [r.seconds for r in results], n_requests / wall, snap


def _mode_entry(pairs: list) -> dict:
    """One mode's entry from its (serial, gateway) pairs: throughput from
    the pair of the best ``throughput_speedup``, p99 from the pair of the
    best ``p99_gain``."""
    for p in pairs:
        p["speedup"] = p["gw_rps"] / p["solo_rps"]
        p["gw_p99"], p["solo_p99"] = _pct(p["gw_lat"], 99), _pct(
            p["solo_lat"], 99)
        p["p99_gain"] = p["solo_p99"] / max(p["gw_p99"], 1e-12)
    t = max(pairs, key=lambda p: p["speedup"])
    q = max(pairs, key=lambda p: p["p99_gain"])
    snap = t["snap"]
    return {
        "gateway": {
            "throughput_rps": t["gw_rps"],
            "p50_ms": _pct(t["gw_lat"], 50) * 1e3,
            "p99_ms": q["gw_p99"] * 1e3,
            "mean_occupancy": snap["mean_occupancy"],
            "slices": snap["slices"],
            "replays": snap["replays"],
            "roster_rebuilds": snap["roster_rebuilds"],
        },
        "solo": {
            "throughput_rps": t["solo_rps"],
            "p50_ms": _pct(t["solo_lat"], 50) * 1e3,
            "p99_ms": q["solo_p99"] * 1e3,
        },
        "throughput_speedup": t["speedup"],
        "p99_gain": q["p99_gain"],
        "pairs": [{"throughput_speedup": p["speedup"],
                   "p99_gain": p["p99_gain"],
                   "gateway_rps": p["gw_rps"], "solo_rps": p["solo_rps"],
                   "roster_rebuilds": p["snap"]["roster_rebuilds"],
                   "captures": p["snap"]["captures"]} for p in pairs],
    }


def run_serve_bench(out_path=OUT, smoke: bool = False,
                    repeats: int | None = None, device=None) -> dict:
    """Measure both modes, serial and gateway windows in turns, and write
    the record to ``out_path`` (None: do not write); returns the
    record."""
    device = resolve_device(device)
    wl = dict(SMOKE_WORKLOAD if smoke else PINNED_WORKLOAD)
    repeats = repeats or (3 if smoke else PINNED_REPEATS)
    program = REGISTRY[APP]()
    config = SystemConfig.from_name(CONFIG)
    pool = rmat_batch(wl["pool"], wl["scale"],
                      edge_factor=wl["edge_factor"], seed=wl["seed"],
                      weighted=program.weighted)
    n, clients = wl["requests"], wl["clients"]
    # the open loop's arrival schedule (seeded), from a first serial
    # measurement
    first = _measure_solo(program, pool, config, SOLO_REPEATS, device)
    rng = np.random.default_rng(wl["seed"])
    lam = LAMBDA_X / (sum(first) / len(first))
    inter = rng.exponential(1.0 / lam, size=n)
    arrivals = np.cumsum(inter)
    windows = {
        "closed": lambda: _gateway_closed(program, pool, config, n, clients,
                                          MAX_BATCH, SLICE_LEN, device),
        "open": lambda: _gateway_open(program, pool, config, n, list(inter),
                                      MAX_BATCH, SLICE_LEN, device)}
    order, services = [], [first]
    pairs = {"closed": [], "open": []}

    def measure(mode: str) -> None:
        service = _measure_solo(program, pool, config, SOLO_REPEATS, device)
        services.append(service)
        by_req = [service[i % len(pool)] for i in range(n)]
        solo_lat, solo_rps = (_solo_closed(by_req, clients)
                              if mode == "closed"
                              else _solo_open(by_req, arrivals))
        gw_lat, gw_rps, snap = windows[mode]()
        order.extend(["solo", mode])
        pairs[mode].append(dict(solo_lat=solo_lat, solo_rps=solo_rps,
                                gw_lat=gw_lat, gw_rps=gw_rps, snap=snap))

    for _ in range(repeats):
        for mode in windows:
            measure(mode)
    closed = _mode_entry(pairs["closed"])
    opened = _mode_entry(pairs["open"])

    result = {
        "card": card(device),
        "device": str(device),
        "torch": torch.__version__,
        "workload": {"generator": "rmat_batch", "app": APP,
                     "config": CONFIG, **wl,
                     "n_nodes": pool[0].n_nodes,
                     "n_edges": pool[0].n_edges,
                     "max_batch": MAX_BATCH, "slice_len": SLICE_LEN,
                     "lambda_x": LAMBDA_X},
        "smoke": smoke,
        "repeats": repeats,
        "solo_repeats": SOLO_REPEATS,
        "windows": order,
        # per graph, the best of every serial measurement
        "solo_service_ms": [min(col) * 1e3 for col in zip(*services)],
        "modes": {"closed": closed, "open": opened},
        "summary": {
            "headline_mode": "closed",
            "headline_throughput_speedup": closed["throughput_speedup"],
            "headline_p99_gain": closed["p99_gain"],
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    print(f"serve_bench,{n},"
          f"closed={closed['throughput_speedup']:.2f}x"
          f"@p99_gain={closed['p99_gain']:.2f};"
          f"open={opened['throughput_speedup']:.2f}x"
          f"@p99_gain={opened['p99_gain']:.2f};"
          f"occupancy={closed['gateway']['mean_occupancy']:.2f}",
          flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny pool, 64 requests")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    run_serve_bench(args.out, args.smoke, args.repeats, args.device)


if __name__ == "__main__":
    main()
