"""PageRank by power iteration in plain torch.

``rank' = (1 - d) / V + d * (sum over in-edges of rank[u] / outdeg[u]
+ dangling / V)``, where ``dangling`` is the rank held by vertices of
out-degree 0, from ``rank = 1 / V``.  The check compares the L1
distance of a run's ranks to the float64 fixpoint.
"""
from __future__ import annotations

import numpy as np
import torch

#: The float64 yardstick iterates until an L1 change below this.
FIXPOINT_TOL = 1e-13
FIXPOINT_ITERS = 2000


def solve(coo, args: dict, source, device, dtype=torch.float64,
          exact: bool = True) -> np.ndarray:
    v = coo.n_nodes
    damping = float(args.get("damping", 0.85))
    tol = FIXPOINT_TOL if exact else float(args.get("tol", 1e-6))
    limit = FIXPOINT_ITERS if exact else int(args.get("max_iters", 256))
    src = torch.as_tensor(coo.src, device=device)
    dst = torch.as_tensor(coo.dst, device=device)
    out_deg = torch.bincount(src, minlength=v)
    dangling = out_deg == 0
    inv_out = (1.0 / out_deg.clamp(min=1).to(torch.float64)).to(dtype)
    base = torch.tensor((1.0 - damping) / v, dtype=dtype, device=device)
    inv_v = torch.tensor(1.0 / v, dtype=dtype, device=device)
    rank = torch.full((v,), 1.0 / v, dtype=dtype, device=device)
    for _ in range(limit):
        acc = torch.zeros(v, dtype=dtype, device=device)
        acc.index_add_(0, dst, (rank * inv_out)[src])
        mass = torch.where(dangling, rank, 0).sum()
        new = base + damping * (acc + mass * inv_v)
        change = float((new - rank).abs().sum())
        rank = new
        if change < tol:
            break
    return rank.to(torch.float64).cpu().numpy()


def control(coo, args: dict, source, device) -> np.ndarray:
    """The control: this solver in the program's place, under its
    stopping rule, in bfloat16, the precision below the float32 that
    the program states."""
    return solve(coo, args, source, device, torch.bfloat16, exact=False)


def readings(outputs: list, expected: np.ndarray) -> dict:
    """``pr_l1_err``: the largest L1 distance of a run's ranks to
    ``expected`` (inf for a missing or non-finite answer)."""
    worst = 0.0
    for out in outputs:
        if out is None or out.shape != expected.shape:
            return {"pr_l1_err": float("inf")}
        err = float(np.abs(out.astype(np.float64) - expected).sum())
        worst = max(worst, err if np.isfinite(err) else float("inf"))
    return {"pr_l1_err": worst}
