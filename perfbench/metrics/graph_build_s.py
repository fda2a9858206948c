"""Seconds of ``Graph.from_coo`` on the generated COO arrays."""


def read(rec):
    return rec.graph_build_s
