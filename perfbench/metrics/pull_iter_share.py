"""The share of the window's iterations that pulled (``T`` in
``RunResult.direction_trace``), in %."""


def read(rec):
    traces = [r.direction_trace for r in rec.runs if r.direction_trace]
    n = sum(len(t) for t in traces)
    if not n:
        return None
    return 100.0 * sum(t.count("T") for t in traces) / n
