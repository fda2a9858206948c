"""Graphalytics' EVPS: (V + E) x runs completed, over the window's
seconds, in millions.  E counts directed edges, both directions of an
undirected edge."""


def read(rec):
    done = sum(r.ok for r in rec.runs)
    return (rec.n_nodes + rec.n_edges) * done / rec.window_s / 1e6
