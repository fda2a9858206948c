"""The program's host phases and the device's idle time by phase, for
one cell.

    python3 -m perfbench.phases --workload <cell> --seed <n> \
        [--seconds 10] [--runs 16]

While a profiler runs, ``repro_torch.core.run`` opens a
``repro_torch.run`` range and, under it, one ``repro_torch.run.<phase>``
range for each of its host phases (``repro_torch.spans``); every call
returns the phases' host seconds as ``RunResult.phases`` and the
engines it built as ``RunResult.captures``.  The command sets the cell
up as :mod:`perfbench.run` does, runs a closed-loop window of
``--seconds`` and then ``--runs`` runs under ``torch.profiler``, each in
a ``perfbench.run`` span, and prints one JSON line: the window's mean
phases (ms), the set-up's capture seconds beside ``warm_s``, and the
profiled window's idle seconds by span beside its window and busy
seconds.  It makes no check of the answers: :mod:`perfbench.run` does.

:func:`idle_by_span` takes :mod:`perfbench.trace`'s window (the first
``perfbench.run`` annotation's start to the last one's end) and busy
union (the kernel, memcpy and memset events inside it).  Every instant
of idle time inside the window goes to the innermost (shortest)
``repro_torch.*`` span that covers it, or to :data:`OUTSIDE` where none
does; idle time inside ``repro_torch.run`` but in none of its phases
goes to ``repro_torch.run`` itself.  A program without these spans
reads only :data:`OUTSIDE`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

from perfbench.trace import DEVICE_CATS, RUN_SPAN, _union

__all__ = ["PREFIX", "OUTSIDE", "idle_by_span", "load_idle_by_span",
           "trace_cell"]

#: The prefix of the program's own spans.
PREFIX = "repro_torch."
#: Where idle time covered by no program span goes.
OUTSIDE = "no program span"


def _x(events, cats) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def idle_by_span(events: list) -> Optional[dict]:
    """Idle seconds of Chrome trace ``events`` by program span name,
    every span seen listed (0.0 where it holds no idle time), or None
    when the trace holds no ``perfbench.run`` span or no device
    operation.  The values add up to the window's idle time."""
    runs = [e for e in _x(events, ("user_annotation",))
            if e["name"] == RUN_SPAN]
    if not runs:
        return None
    w_lo = min(float(e["ts"]) for e in runs)
    w_hi = max(float(e["ts"]) + float(e["dur"]) for e in runs)
    dev = []
    for e in _x(events, DEVICE_CATS):
        lo = max(float(e["ts"]), w_lo)
        hi = min(float(e["ts"]) + float(e.get("dur", 0.0)), w_hi)
        if hi > lo:
            dev.append((lo, hi))
    if not dev:
        return None
    gaps, t = [], w_lo
    for lo, hi in _union(dev) + [[w_hi, w_hi]]:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e["name"])
                   for e in _x(events, ("user_annotation",))
                   if e["name"].startswith(PREFIX))
    idle = dict.fromkeys([name for _, _, name in spans] + [OUTSIDE], 0.0)
    for lo, hi in gaps:
        over = [s for s in spans if s[0] < hi and s[1] > lo]
        cuts = sorted({lo, hi} | {x for s in over for x in s[:2]
                                  if lo < x < hi})
        for a, b in zip(cuts, cuts[1:]):
            cover = [s for s in over if s[0] <= a and s[1] >= b]
            name = (min(cover, key=lambda s: s[1] - s[0])[2] if cover
                    else OUTSIDE)
            idle[name] += (b - a) * 1e-6
    return idle


def load_idle_by_span(path) -> Optional[dict]:
    """:func:`idle_by_span` of an exported Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    return idle_by_span(data["traceEvents"] if isinstance(data, dict)
                        else data)


def trace_cell(bench, cell, seed: int, seconds: float, runs: int,
               device) -> dict:
    """Set-up, window and ``runs`` profiled runs of ``cell`` on
    ``device``; returns the line :func:`main` prints."""
    import torch

    from perfbench import generators, trace as tracing
    from repro_torch import algorithms
    from repro_torch.core import SystemConfig, run
    from repro_torch.graph import Graph

    device = torch.device(device)
    mix = cell.mix
    coo = generators.generate(cell.config, seed, mix.get("sources", 0),
                              device)
    graph = Graph.from_coo(coo.src, coo.dst, coo.n_nodes, weight=coo.weight)
    factory = getattr(algorithms, mix["program"])
    programs = ([factory(**mix["args"], **{mix["source_arg"]: s})
                 for s in coo.sources] if coo.sources
                else [factory(**mix["args"])])
    config = SystemConfig.from_name(mix["config"])

    def once(n):
        return run(programs[n % len(programs)], graph, config,
                   use_kernels=True, engine="fused", autotune="off",
                   device=device)

    t_warm = time.perf_counter()
    warm = [once(i) for i in range(len(programs))
            for _ in range(mix["warm_runs"])]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warm_s = time.perf_counter() - t_warm
    window, start = [], time.perf_counter()
    while time.perf_counter() - start < seconds:
        window.append(once(len(window)).phases)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for n in range(runs):
            with torch.profiler.record_function(RUN_SPAN):
                res = once(n)
                res.extract(programs[n % len(programs)]).cpu()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        profile = tracing.load_trace(path)
        idle = load_idle_by_span(path)
    finally:
        os.unlink(path)
    return {"runs": len(window),
            "phases_ms": {k: sum(p[k] for p in window) / len(window) * 1e3
                          for k in window[0]} if window else None,
            "capture_s": sum(r.phases["run.engine"] for r in warm
                             if r.captures),
            "warm_s": warm_s,
            "window_s": profile.window_s if profile else None,
            "busy_s": profile.busy_s if profile else None,
            "idle_by_span_s": idle}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.phases",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--runs", type=int, default=16)
    args = p.parse_args(argv)
    import torch

    from perfbench import registry
    from perfbench.run import ROOT

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    bench = registry.load(ROOT)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    print(json.dumps(trace_cell(bench, bench.cell(args.workload), args.seed,
                                args.seconds, args.runs, device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
