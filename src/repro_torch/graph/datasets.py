"""The paper's six graph inputs (Table II), recreated synthetically.

Counterpart of the synthetic part of ``repro.graph.datasets``
(``PAPER_STATS`` and ``paper_graph``, ``datasets.py:110-143``).  The
loader of real edge-list files is not ported yet.

``paper_graph`` seeds its generator with ``hash(name)``, as the
original does, so its graph is the same within one Python process but
changes between processes unless ``PYTHONHASHSEED`` is fixed.  A run
that must see the same graph every time calls :func:`powerlaw_graph` or
:func:`regular_graph` with the row's arguments and a fixed seed.
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.graph.generators import powerlaw_graph, regular_graph
from repro_torch.graph.structure import Graph

__all__ = ["PAPER_GRAPHS", "PAPER_STATS", "paper_graph"]

PAPER_GRAPHS = ("AMZ", "DCT", "EML", "OLS", "RAJ", "WNG")

# name -> (vertices, edges, max_deg, avg_deg, volume_kb, reuse, imbalance,
#          vol_class, reuse_class, imb_class) from Table II.
PAPER_STATS = {
    "AMZ": (410236, 6713648, 2770, 16.265, 1855.178, 0.160, 0.000, "H", "M", "L"),
    "DCT": (52652, 178076, 38, 3.382, 60.078, 0.359, 0.083, "M", "M", "M"),
    "EML": (265214, 837912, 7636, 3.159, 287.272, 0.053, 1.000, "H", "L", "H"),
    "OLS": (88263, 683186, 10, 7.740, 200.898, 0.445, 0.000, "M", "H", "L"),
    "RAJ": (20640, 163178, 3469, 7.906, 47.869, 0.594, 0.617, "L", "H", "H"),
    "WNG": (61032, 243088, 4, 3.919, 79.458, 0.0051, 0.000, "M", "L", "L"),
}


@lru_cache(maxsize=None)
def paper_graph(name: str, scale: int = 1, weighted: bool = False,
                block_size: int = 256) -> Graph:
    """Synthetic recreation of a Table II input, optionally divided by
    ``scale`` in vertices and edges."""
    if name not in PAPER_STATS:
        raise KeyError(f"unknown paper graph {name!r}; one of {PAPER_GRAPHS}")
    v, e, max_deg, avg_deg = PAPER_STATS[name][:4]
    n = max(4 * block_size, v // scale)
    ne = max(n * 2, e // scale)
    seed = hash(name) % (2**31)
    if name == "AMZ":      # skewed, degree-ordered ids -> Imbalance L
        return powerlaw_graph(n, ne // 2, alpha=1.2, max_degree=max_deg,
                              locality=0.21, degree_order="sorted", seed=seed,
                              weighted=weighted, block_size=block_size)
    if name == "DCT":      # light skew, moderate locality, mild imbalance
        return powerlaw_graph(n, ne // 2, alpha=0.7, max_degree=max_deg,
                              locality=0.31, hub_fraction=0.12, seed=seed,
                              weighted=weighted, block_size=block_size)
    if name == "EML":      # heavy power law, low locality, hubs everywhere
        return powerlaw_graph(n, ne // 2, alpha=1.6, max_degree=max_deg,
                              locality=0.05, hub_fraction=1.0, seed=seed,
                              weighted=weighted, block_size=block_size)
    if name == "OLS":      # near-regular, high locality
        return regular_graph(n, degree=max(2, int(avg_deg / 2)), locality=0.56,
                             seed=seed, weighted=weighted,
                             block_size=block_size)
    if name == "RAJ":      # small, skewed, high locality
        return powerlaw_graph(n, ne // 2, alpha=1.1, max_degree=max_deg,
                              locality=0.62, hub_fraction=0.7, seed=seed,
                              weighted=weighted, block_size=block_size)
    # WNG: degree ~4, almost perfectly regular, no locality
    return regular_graph(n, degree=2, locality=0.005, seed=seed,
                         weighted=weighted, block_size=block_size)
