"""Graph-structure taxonomy: Volume, Reuse, Imbalance (paper Sec. III-A).

Counterpart of ``repro.core.taxonomy``: Equations 1-7 and the paper's
thresholds (Sec. V-A) for the H/M/L classes.  Every function reads the
host numpy arrays of a :class:`~repro_torch.graph.structure.Graph`
(never its device copy) and computes in float64 as the reference does,
so the figures and classes are the reference's bit for bit.

Two hardware profiles:

- ``PAPER_GPU``: the simulated GPU of Table IV (15 SMs, 32 KB L1, 4 MB
  L2, |TB| = 256).  ``profile_graph`` defaults to it, so the Fig. 4
  decisions are the reference's; with the published |V|, |E| the Volume
  classes of Table II come out exactly.
- ``H100``: the card the port runs on (132 SMs, 256 KB of L1 / shared
  memory per SM, 50 MB of L2, 256 threads per CTA, K1/K2's tuned
  default).  Its Volume knees are 384.0 and ~387.9 KB per SM, so every
  Table II input is Volume L on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = ["HwProfile", "PAPER_GPU", "H100", "GraphProfile",
           "volume_kb", "an_local_remote", "reuse_from_an", "reuse",
           "imbalance", "classify", "classify_volume_kb", "classify_reuse",
           "classify_imbalance", "profile_graph"]

BYTES_PER_ELEMENT = 4  # one fp32/int32 property word per vertex + per edge


@dataclasses.dataclass(frozen=True)
class HwProfile:
    name: str
    n_cores: int            # |SM| in Eq. 1
    l1_bytes: int           # per-core fast memory
    l2_bytes: int           # shared capacity
    tb_size: int            # |TB| in Eqs. 2-7 (vertex tile size)
    # classification thresholds (Sec. V-A)
    vol_low_factor: float = 1.5     # low: < 1.5 x L1
    reuse_low: float = 0.15
    reuse_high: float = 0.40
    imb_low: float = 0.05
    imb_high: float = 0.25
    kmeans_threshold: float = 10.0  # max-degree centroid differential

    @property
    def vol_low_kb(self) -> float:
        return self.vol_low_factor * self.l1_bytes / 1024.0

    @property
    def vol_high_kb(self) -> float:
        return self.l2_bytes / self.n_cores / 1024.0


#: Table IV simulated hardware.
PAPER_GPU = HwProfile(name="paper_gpu", n_cores=15, l1_bytes=32 * 1024,
                      l2_bytes=4 * 1024 * 1024, tb_size=256)

#: NVIDIA H100 SXM: 132 SMs, 256 KB L1 / shared memory per SM, 50 MB L2;
#: |TB| is the 256 threads per CTA of K1/K2's default plan.
H100 = HwProfile(name="h100", n_cores=132, l1_bytes=256 * 1024,
                 l2_bytes=50 * 1024 * 1024, tb_size=256)


# --------------------------------------------------------------------------
# Eq. 1 - Volume
# --------------------------------------------------------------------------
def volume_kb(n_nodes: int, n_edges: int, hw: HwProfile = PAPER_GPU) -> float:
    """Eq. 1 scaled to KB: average working set per core."""
    return (n_nodes + n_edges) * BYTES_PER_ELEMENT / hw.n_cores / 1024.0


def classify_volume_kb(kb: float, hw: HwProfile = PAPER_GPU) -> str:
    if kb < hw.vol_low_kb:
        return "L"
    if kb > hw.vol_high_kb:
        return "H"
    return "M"


# --------------------------------------------------------------------------
# Eqs. 2-6 - Reuse
# --------------------------------------------------------------------------
def an_local_remote(g: Graph, tb_size: int) -> tuple[float, float]:
    """AN_L (Eq. 4) and AN_R (Eq. 5): average local and remote
    neighbours, local meaning the same vertex tile (Eqs. 2-3)."""
    src = np.asarray(g.src, dtype=np.int64)
    dst = np.asarray(g.dst, dtype=np.int64)
    same = (src // tb_size) == (dst // tb_size)
    non_self = src != dst  # self edges count for neither (Eqs. 2-3)
    an_l = float(np.count_nonzero(same & non_self)) / g.n_nodes
    an_r = float(np.count_nonzero(~same & non_self)) / g.n_nodes
    return an_l, an_r


def reuse_from_an(an_l: float, an_r: float, avg_degree: float) -> float:
    """Eq. 6."""
    if avg_degree == 0:
        return 0.0
    return 0.5 * (1.0 + (an_l - an_r) / avg_degree)


def reuse(g: Graph, hw: HwProfile = PAPER_GPU) -> float:
    an_l, an_r = an_local_remote(g, hw.tb_size)
    avg_degree = g.n_edges / max(g.n_nodes, 1)
    return reuse_from_an(an_l, an_r, avg_degree)


def classify_reuse(r: float, hw: HwProfile = PAPER_GPU) -> str:
    if r < hw.reuse_low:
        return "L"
    if r > hw.reuse_high:
        return "H"
    return "M"


# --------------------------------------------------------------------------
# Eq. 7 - Imbalance (k-means over per-warp max degree)
# --------------------------------------------------------------------------
WARP_SIZE = 32


def _kmeans2(values: np.ndarray, iters: int = 16) -> tuple[float, float]:
    """Fixed k = 2 one-dimensional k-means; returns the two centroids."""
    lo, hi = float(values.min()), float(values.max())
    if lo == hi:
        return lo, hi
    c0, c1 = lo, hi
    for _ in range(iters):
        mid = (c0 + c1) / 2.0
        left = values[values <= mid]
        right = values[values > mid]
        n0 = c0 if left.size == 0 else float(left.mean())
        n1 = c1 if right.size == 0 else float(right.mean())
        if n0 == c0 and n1 == c1:
            break
        c0, c1 = n0, n1
    return c0, c1


def imbalance(g: Graph, hw: HwProfile = PAPER_GPU) -> float:
    """Eq. 7: the fraction of vertex tiles marked imbalanced, a tile
    being marked when 2-means of its warps' largest degrees gives
    centroids further apart than the threshold (Sec. III-A3, V-A)."""
    deg = np.asarray(g.out_degree, dtype=np.float64)
    tb, warp = hw.tb_size, WARP_SIZE
    n_blocks = int(np.ceil(g.n_nodes / tb))
    pad = n_blocks * tb - g.n_nodes
    if pad:
        deg = np.concatenate([deg, np.zeros(pad)])
    # [n_blocks, warps_per_block]: the largest degree each warp handles
    warp_max = deg.reshape(n_blocks, tb // warp, warp).max(axis=2)
    marked = 0
    for b in range(n_blocks):
        c0, c1 = _kmeans2(warp_max[b])
        if (c1 - c0) > hw.kmeans_threshold:
            marked += 1
    return marked / max(n_blocks, 1)


def classify_imbalance(i: float, hw: HwProfile = PAPER_GPU) -> str:
    if i < hw.imb_low:
        return "L"
    if i > hw.imb_high:
        return "H"
    return "M"


# --------------------------------------------------------------------------
# Combined profile
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GraphProfile:
    """Taxonomy inputs to the specialization model (Sec. IV)."""
    volume_kb: float
    reuse: float
    imbalance: float
    volume_class: str
    reuse_class: str
    imbalance_class: str

    @classmethod
    def from_classes(cls, vol: str, reu: str, imb: str) -> "GraphProfile":
        return cls(float("nan"), float("nan"), float("nan"), vol, reu, imb)


def classify(vol_kb: float, r: float, i: float,
             hw: HwProfile = PAPER_GPU) -> GraphProfile:
    return GraphProfile(
        volume_kb=vol_kb, reuse=r, imbalance=i,
        volume_class=classify_volume_kb(vol_kb, hw),
        reuse_class=classify_reuse(r, hw),
        imbalance_class=classify_imbalance(i, hw),
    )


def profile_graph(g: Graph, hw: HwProfile = PAPER_GPU) -> GraphProfile:
    """Eqs. 1-7 of ``g`` (host arrays) classified under ``hw``."""
    return classify(volume_kb(g.n_nodes, g.n_edges, hw), reuse(g, hw),
                    imbalance(g, hw), hw)
