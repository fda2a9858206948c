"""Reading a ``torch.profiler`` trace of the profiled runs.

The trace is the profiler's Chrome trace (``traceEvents``: ``ts`` and
``dur`` in microseconds on one clock for host and device).  Device
operations are the events of the kernel, memcpy and memset categories;
the window is the span from the first ``perfbench.run`` annotation's
start to the last one's end.  Busy time is the union of the device
operations inside the window, and each idle gap is put down to the
innermost host event that covers its middle.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import List, Optional, Tuple

__all__ = ["RUN_SPAN", "Profile", "DEVICE_CATS", "HOST_CATS", "load_trace",
           "profile_from_events"]

#: The annotation the harness puts around every ``run()`` call.
RUN_SPAN = "perfbench.run"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Profile:
    """What the metric readers take from a trace."""
    window_s: float
    busy_s: float
    #: (name, seconds) of every device operation inside the window
    device_ops: List[Tuple[str, float]]
    #: (host activity, seconds) of every idle gap inside the window
    idle_gaps: List[Tuple[str, float]]

    def kernels(self, *parts: str) -> List[float]:
        """Seconds of each device operation whose name holds all
        ``parts``."""
        return [s for name, s in self.device_ops
                if all(p in name for p in parts)]

    @staticmethod
    def top(pairs, n: int = 10) -> list:
        """The ``n`` names with the most seconds, summed by name."""
        total = defaultdict(float)
        for name, s in pairs:
            total[name] += s
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top(self.device_ops),
                "idle_gaps": self.top(self.idle_gaps)}


def _union(intervals) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _host_names(host, times) -> list:
    """For each of the ascending ``times``, the name of the shortest
    host event that covers it ("idle host" where none does)."""
    host = sorted(host)
    names, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        names.append(min(active, key=lambda h: h[1] - h[0])[2]
                     if active else "idle host")
    return names


def profile_from_events(events: list) -> Optional[Profile]:
    """A :class:`Profile` of Chrome trace events, or None when the trace
    holds no run span or no device operation."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == RUN_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    w_lo = min(float(e["ts"]) for e in spans)
    w_hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev, ops = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        lo = max(float(e["ts"]), w_lo)
        hi = min(float(e["ts"]) + float(e.get("dur", 0.0)), w_hi)
        if hi > lo:
            dev.append((lo, hi))
            ops.append((e["name"], (hi - lo) * 1e-6))
    if not dev:
        return None
    busy = _union(dev)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    gaps, t = [], w_lo
    for lo, hi in busy + [[w_hi, w_hi]]:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    names = _host_names(host, [(lo + hi) / 2 for lo, hi in gaps])
    return Profile(window_s=(w_hi - w_lo) * 1e-6,
                   busy_s=sum(hi - lo for lo, hi in busy) * 1e-6,
                   device_ops=ops,
                   idle_gaps=[(name, (hi - lo) * 1e-6)
                              for name, (lo, hi) in zip(names, gaps)])


def load_trace(path) -> Optional[Profile]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return profile_from_events(events)
