"""The applications ported so far, as VertexPrograms."""
from repro_torch.algorithms.bfs import bfs
from repro_torch.algorithms.pagerank import pagerank
from repro_torch.algorithms.sssp import sssp

__all__ = ["bfs", "pagerank", "sssp"]
