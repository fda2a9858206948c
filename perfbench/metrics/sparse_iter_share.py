"""The share of the window's iterations that ran the gathered O(m_f)
path (an occupancy >= 0 in ``RunResult.occupancy_trace``), in %."""


def read(rec):
    traces = [r.occupancy_trace for r in rec.runs if r.occupancy_trace]
    n = sum(len(t) for t in traces)
    if not n:
        return None
    return 100.0 * sum(o >= 0.0 for t in traces for o in t) / n
