"""DIMACS10 "rgg_n_2_<k>_s0": a random geometric graph.

The 10th DIMACS Implementation Challenge (Bader, Meyerhenke, Sanders,
Wagner), family ``rgg_n_2_<k>_s0``, from Holtgrewe, Sanders and Schulz,
IPDPS 2010: n = 2**k points uniform in the unit square, two of them
joined when they lie closer than r = 0.55 * sqrt(ln n / n).  Here k is
``scale`` and 0.55 is ``radius_coef``.  DIMACS10 drew its own points;
this is the same definition with another draw, from ``gen``, in
float64.

The pairs are found on the device with a grid of cells of side at
least r: each point is tested against the points of its own cell and
of the eight around it, in chunks of at most ``max_candidates``
candidate pairs.  Every pair closer than r is emitted once, as (i, j)
with i < j: ``symmetrize`` keeps the smaller weight of a duplicate, so
a pair emitted twice would get the smaller of two draws and its weights
would no longer be uniform.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: The most candidate pairs tested at once: about 1 GB of temporaries.
MAX_CANDIDATES = 1 << 24


def n_nodes(cfg: dict) -> int:
    return 1 << cfg["scale"]


def radius(cfg: dict) -> float:
    n = n_nodes(cfg)
    return cfg["radius_coef"] * math.sqrt(math.log(n) / n)


def edges(cfg: dict, gen: torch.Generator, device,
          max_candidates: int = MAX_CANDIDATES) -> tuple:
    pts = torch.rand((n_nodes(cfg), 2), generator=gen, dtype=torch.float64,
                     device=device)
    return pairs_within(pts, radius(cfg), max_candidates)


def pairs_within(pts: torch.Tensor, r: float,
                 max_candidates: int = MAX_CANDIDATES) -> tuple:
    """Every pair (i, j), i < j, of points in the unit square whose
    squared distance ``dx * dx + dy * dy`` is below ``r * r``."""
    n, device = pts.shape[0], pts.device
    # a margin over 1 / r, so that rounding x * g at a cell's border
    # never parts two points closer than r by two cells
    g = max(1, int(1.0 / (r * (1.0 + 1e-9))))
    cxy = (pts * g).long().clamp_(0, g - 1)
    cell = cxy[:, 0] * g + cxy[:, 1]
    order = torch.argsort(cell, stable=True)
    count = torch.bincount(cell, minlength=g * g)
    start = torch.cumsum(count, 0) - count
    off = torch.tensor([-1, 0, 1], device=device)
    nx = (cxy[:, 0, None, None] + off[:, None]).expand(n, 3, 3).reshape(n, 9)
    ny = (cxy[:, 1, None, None] + off[None, :]).expand(n, 3, 3).reshape(n, 9)
    inside = (nx >= 0) & (nx < g) & (ny >= 0) & (ny < g)
    near = nx.clamp(0, g - 1) * g + ny.clamp(0, g - 1)
    cnt = torch.where(inside, count[near], 0)
    first = start[near]
    ends = torch.cumsum(cnt.sum(1), 0).cpu().numpy()
    r2 = r * r
    src, dst = [], []
    a = 0
    while a < n:
        base = int(ends[a - 1]) if a else 0
        b = max(a + 1, int(np.searchsorted(ends, base + max_candidates,
                                           side="right")))
        c = cnt[a:b].reshape(-1)
        total = int(ends[b - 1]) - base
        i = torch.arange(a, b, device=device).repeat_interleave(9)
        i = i.repeat_interleave(c, output_size=total)
        # the k-th candidate of a (point, cell) slot is the k-th point of
        # that cell in ``order``
        lead = first[a:b].reshape(-1) - (torch.cumsum(c, 0) - c)
        pos = (torch.arange(total, device=device)
               + lead.repeat_interleave(c, output_size=total))
        j = order[pos]
        keep = i < j
        i, j = i[keep], j[keep]
        dx = pts[i, 0] - pts[j, 0]
        dy = pts[i, 1] - pts[j, 1]
        close = dx * dx + dy * dy < r2
        src.append(i[close])
        dst.append(j[close])
        a = b
    return torch.cat(src), torch.cat(dst)
