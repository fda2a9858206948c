"""The paper's six graph inputs (Table II), recreated synthetically.

Counterpart of ``repro.graph.datasets``: ``PAPER_STATS``, ``PAPER_AN``
and ``paper_graph`` (the synthetic stand-ins), and the real inputs.
``dataset_graph(name)`` loads the SuiteSparse / SNAP edge list when a
local copy exists under ``$REPRO_DATA_DIR`` (or ``./data``) and
otherwise falls back to the stand-in, saying which it returned.  Nothing
downloads: ``fetch_instructions()`` only gives the commands that place
the real files.  ``degree_profile(graph)`` reports the degree-profile
class (near-regular, social, web-crawl) a graph lands in.

``paper_graph`` seeds its generator with ``hash(name)``, as the
original does, so its graph is the same within one Python process but
changes between processes unless ``PYTHONHASHSEED`` is fixed.  A run
that must see the same graph every time calls :func:`powerlaw_graph` or
:func:`regular_graph` with the row's arguments and a fixed seed.
"""
from __future__ import annotations

import gzip
import os
from functools import lru_cache
from pathlib import Path

import numpy as np

from repro_torch.graph.generators import powerlaw_graph, regular_graph
from repro_torch.graph.structure import Graph

__all__ = ["PAPER_GRAPHS", "PAPER_STATS", "PAPER_AN", "PAPER_SOURCES",
           "DEGREE_PROFILES", "paper_graph", "dataset_graph",
           "load_real_graph", "real_graph_path", "degree_profile",
           "fetch_instructions"]

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

# Published AN_L / AN_R (Table II).
PAPER_AN = {
    "AMZ": (2.616, 13.749),
    "DCT": (1.215, 2.167),
    "EML": (0.167, 2.992),
    "OLS": (3.446, 4.295),
    "RAJ": (4.697, 3.209),
    "WNG": (0.020, 3.899),
}

# name -> (degree-profile class, upstream dataset, fetch URL).
#   near-regular : tight degree band, no hubs (road-network-like)
#   social       : power-law tail, moderate hubs
#   web-crawl    : heavy power-law, extreme hubs dominate edge mass
PAPER_SOURCES = {
    "AMZ": ("social", "SNAP com-Amazon (co-purchase)",
            "https://snap.stanford.edu/data/bigdata/communities/com-amazon.ungraph.txt.gz"),
    "DCT": ("near-regular", "SuiteSparse Pajek/dictionary28",
            "https://suitesparse-collection-website.herokuapp.com/MM/Pajek/dictionary28.tar.gz"),
    "EML": ("web-crawl", "SNAP email-EuAll",
            "https://snap.stanford.edu/data/email-EuAll.txt.gz"),
    "OLS": ("near-regular", "SuiteSparse olesnik0",
            "https://suitesparse-collection-website.herokuapp.com/MM/GHS_indef/olesnik0.tar.gz"),
    "RAJ": ("social", "SuiteSparse raj1 (circuit)",
            "https://suitesparse-collection-website.herokuapp.com/MM/Rajat/rajat01.tar.gz"),
    "WNG": ("near-regular", "SuiteSparse wing (FE mesh)",
            "https://suitesparse-collection-website.herokuapp.com/MM/DIMACS10/wing.tar.gz"),
}

# profile class -> the band of ``degree_skew`` (coefficient of variation
# of out-degree, ``kernels.autotune.degree_features``) its members fall in
DEGREE_PROFILES = {
    "near-regular": {"degree_skew": (0.0, 0.6)},
    "social": {"degree_skew": (0.6, 3.0)},
    "web-crawl": {"degree_skew": (3.0, float("inf"))},
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


# ---------------------------------------------------------------------------
# real inputs: local edge lists with the synthetic fallback
# ---------------------------------------------------------------------------
def _data_dir() -> Path:
    return Path(os.environ.get("REPRO_DATA_DIR", "data"))


def real_graph_path(name: str) -> Path | None:
    """Path of a local edge list for ``name`` under ``$REPRO_DATA_DIR``
    (default ``./data``), or None: ``<NAME>.txt`` / ``.edges``
    (whitespace ``src dst [weight]`` rows, ``#``/``%`` comments) or
    ``<NAME>.mtx`` (MatrixMarket coordinate, 1-based), each also
    gzipped (``.gz``)."""
    base = _data_dir()
    for ext in (".txt", ".edges", ".mtx", ".txt.gz", ".edges.gz",
                ".mtx.gz"):
        p = base / f"{name}{ext}"
        if p.is_file():
            return p
    return None


def load_real_graph(path, weighted: bool = False,
                    block_size: int = 256) -> Graph:
    """Parse a local edge-list or MatrixMarket file into a symmetric
    :class:`Graph` (self loops and duplicates dropped by
    ``Graph.from_coo``, vertex ids compacted to ``0..V-1``)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    is_mtx = ".mtx" in path.suffixes or path.suffix == ".mtx"
    rows = []
    with opener(path, "rt") as fh:
        header_skipped = False
        for line in fh:
            line = line.strip()
            if not line or line[0] in "#%":
                continue
            if is_mtx and not header_skipped:
                header_skipped = True  # the dimensions line
                continue
            parts = line.split()
            s, d = int(float(parts[0])), int(float(parts[1]))
            w = float(parts[2]) if weighted and len(parts) > 2 else 1.0
            rows.append((s, d, w))
    if not rows:
        raise ValueError(f"no edges parsed from {path}")
    arr = np.asarray(rows, np.float64)
    src, dst = arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64)
    if is_mtx:
        src, dst = src - 1, dst - 1
    ids, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    src, dst = inv[:src.size], inv[src.size:]
    weight = arr[:, 2].astype(np.float32) if weighted else None
    return Graph.from_coo(src, dst, n_nodes=int(ids.size), weight=weight,
                          block_size=block_size, symmetrize=True)


def dataset_graph(name: str, scale: int = 1, weighted: bool = False,
                  block_size: int = 256, prefer_real: bool = True):
    """A Table II input and its source: ``(graph, "real")`` when a local
    file exists (``scale`` does not apply to it), else the stand-in,
    ``(paper_graph(...), "synthetic")``."""
    if prefer_real:
        p = real_graph_path(name)
        if p is not None:
            return (load_real_graph(p, weighted=weighted,
                                    block_size=block_size), "real")
    return (paper_graph(name, scale=scale, weighted=weighted,
                        block_size=block_size), "synthetic")


def degree_profile(graph) -> dict:
    """``kernels.autotune.degree_features`` of ``graph`` with its
    :data:`DEGREE_PROFILES` class (``profile``) and its quantized
    ``signature``."""
    from repro_torch.kernels.autotune import degree_features, degree_signature
    feats = degree_features(graph)
    skew = feats["degree_skew"]
    profile = next((cls for cls, bands in DEGREE_PROFILES.items()
                    if bands["degree_skew"][0] <= skew
                    < bands["degree_skew"][1]), "near-regular")
    return {**feats, "profile": profile,
            "signature": degree_signature(feats)}


def fetch_instructions(name: str | None = None) -> str:
    """Shell commands that place the real inputs where
    :func:`dataset_graph` finds them.  Returned as text, never run."""
    names = [name] if name else list(PAPER_GRAPHS)
    lines = [f"mkdir -p {_data_dir()}"]
    for n in names:
        profile, source, url = PAPER_SOURCES[n]
        lines.append(f"# {n}: {source} ({profile})")
        tgt = f"{_data_dir()}/{n}.txt.gz"
        if url.endswith(".tar.gz"):
            lines.append(f"curl -L {url} | tar -xzO '*.mtx' "
                         f"| gzip > {_data_dir()}/{n}.mtx.gz")
        else:
            lines.append(f"curl -L -o {tgt} {url}")
    return "\n".join(lines)
