from repro_torch.graph.structure import (ARRAY_FIELDS, Graph, GraphStats,
                                         graph_from_arrays, graph_stats,
                                         validate_graph)
from repro_torch.graph.generators import (grid_graph, powerlaw_graph,
                                          random_graph, regular_graph,
                                          rmat_batch, rmat_graph)
from repro_torch.graph.datasets import (DEGREE_PROFILES, PAPER_AN,
                                        PAPER_GRAPHS, PAPER_SOURCES,
                                        PAPER_STATS, dataset_graph,
                                        degree_profile, fetch_instructions,
                                        load_real_graph, paper_graph,
                                        real_graph_path)
from repro_torch.graph.partition import (EdgePartition, VertexPartition,
                                         partition_edges_1d,
                                         partition_vertices)
from repro_torch.graph.sampler import NeighborSampler, SampledBlock

__all__ = [
    "ARRAY_FIELDS", "Graph", "GraphStats", "graph_stats",
    "graph_from_arrays", "validate_graph",
    "grid_graph", "powerlaw_graph", "random_graph", "regular_graph",
    "rmat_graph", "rmat_batch",
    "PAPER_GRAPHS", "PAPER_STATS", "PAPER_AN", "PAPER_SOURCES",
    "DEGREE_PROFILES", "paper_graph", "dataset_graph", "load_real_graph",
    "real_graph_path", "degree_profile", "fetch_instructions",
    "EdgePartition", "VertexPartition", "partition_edges_1d",
    "partition_vertices", "NeighborSampler", "SampledBlock",
]
