from repro_torch.graph.structure import (ARRAY_FIELDS, Graph,
                                         graph_from_arrays, validate_graph)
from repro_torch.graph.generators import (powerlaw_graph, random_graph,
                                          regular_graph, rmat_graph)
from repro_torch.graph.datasets import PAPER_GRAPHS, PAPER_STATS, paper_graph

__all__ = [
    "ARRAY_FIELDS", "Graph", "graph_from_arrays", "validate_graph",
    "powerlaw_graph", "random_graph", "regular_graph", "rmat_graph",
    "PAPER_GRAPHS", "PAPER_STATS", "paper_graph",
]
