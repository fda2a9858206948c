"""The paper's six applications (Sec. V-B) as VertexPrograms, plus BFS
(counterpart of ``repro.algorithms``)."""
from repro_torch.algorithms.bc import bc
from repro_torch.algorithms.bfs import bfs
from repro_torch.algorithms.cc import cc
from repro_torch.algorithms.coloring import coloring
from repro_torch.algorithms.mis import mis
from repro_torch.algorithms.pagerank import pagerank
from repro_torch.algorithms.sssp import sssp

#: name -> zero-argument factory with the paper's default parameters
REGISTRY = {
    "PR": pagerank,
    "SSSP": sssp,
    "MIS": mis,
    "CLR": coloring,
    "BC": bc,
    "CC": cc,
    "BFS": bfs,
}

__all__ = ["pagerank", "sssp", "mis", "coloring", "bc", "cc", "bfs",
           "REGISTRY"]
