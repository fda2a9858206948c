"""Real spherical harmonics and Wigner rotation blocks for eSCN-style
models (counterpart of ``repro.models.gnn.sh``).

:func:`real_sph_harm` evaluates real SH up to ``l_max`` by the
associated-Legendre recurrence (differentiable, every op the
reference's in its order).  :func:`wigner_blocks` builds the per-degree
rotation matrices D_l(R) from the sample-projection identity
``Y_l(R r) = D_l Y_l(r)``: for a fixed, well-conditioned set of sample
directions S, ``D_l = Y_l(R S) pinv(Y_l(S))``.  The sample directions
and the pseudo-inverses are host constants: numpy float64 ``pinv`` of
the port's own :func:`real_sph_harm` at float32 directions (the
reference evaluates its SH through JAX, float32 by default, before its
float64 ``pinv``).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

__all__ = ["real_sph_harm", "align_z_rotation", "wigner_blocks",
           "n_coeffs", "kept_rows"]


def n_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def kept_rows(l_max: int, m_max: int) -> np.ndarray:
    """Indices of the coefficients with |m| <= m_max (the eSCN cut)."""
    rows = []
    off = 0
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            if abs(m) <= m_max:
                rows.append(off + m + l)
        off += 2 * l + 1
    return np.asarray(rows, np.int32)


def real_sph_harm(dirs: torch.Tensor, l_max: int) -> torch.Tensor:
    """dirs [..., 3] (unit vectors) -> [..., (l_max+1)^2] real SH values,
    l-major, m from -l to l (``sh.py:41-74``)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ct = torch.clamp(z, -1.0, 1.0)                        # cos(theta)
    st = torch.sqrt(torch.maximum(1.0 - ct * ct, ct.new_tensor(1e-12)))
    phi = torch.atan2(y, x)

    # associated Legendre P_l^m(ct) for 0 <= m <= l <= l_max
    p = {(0, 0): torch.ones_like(ct)}
    for m in range(1, l_max + 1):
        p[(m, m)] = -(2 * m - 1) * st * p[(m - 1, m - 1)]
    for m in range(0, l_max):
        p[(m + 1, m)] = (2 * m + 1) * ct * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = ((2 * l - 1) * ct * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)

    fact = [float(math.factorial(i)) for i in range(2 * l_max + 1)]
    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = float(np.sqrt((2 * l + 1) / (4 * np.pi)
                              * fact[l - am] / fact[l + am]))
            if m == 0:
                out.append(k * p[(l, 0)])
            elif m > 0:
                out.append(math.sqrt(2.0) * k * torch.cos(m * phi)
                           * p[(l, m)])
            else:
                out.append(math.sqrt(2.0) * k * torch.sin(am * phi)
                           * p[(l, am)])
    return torch.stack(out, dim=-1)


def align_z_rotation(e: torch.Tensor) -> torch.Tensor:
    """The rotation R with ``R @ e = z`` (Rodrigues; e [..., 3] unit)."""
    z = torch.zeros_like(e)
    z[..., 2] = 1.0
    v = torch.linalg.cross(e, z)            # rotation axis * sin
    c = e[..., 2]                           # cos angle
    s2 = torch.sum(v * v, dim=-1)
    zero = torch.zeros_like(c)
    k = torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=e.dtype, device=e.device).expand(k.shape)
    coef = torch.where(s2 > 1e-12,
                       (1.0 - c) / torch.maximum(s2, s2.new_tensor(1e-12)),
                       s2.new_tensor(0.5))
    r = eye + k + coef[..., None, None] * (k @ k)
    # antipodal case e = -z: rotate pi about x
    flip = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
                        dtype=e.dtype, device=e.device).expand(k.shape)
    return torch.where((c < -1.0 + 1e-9)[..., None, None], flip, r)


@lru_cache(maxsize=None)
def _sample_dirs(n_pts: int = 64) -> np.ndarray:
    """Fibonacci-sphere sample directions (float64)."""
    i = np.arange(n_pts, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n_pts)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=-1)


@lru_cache(maxsize=None)
def _pinv_blocks(l_max: int, n_pts: int = 64):
    dirs = _sample_dirs(n_pts)
    y = real_sph_harm(torch.from_numpy(dirs).float(), l_max) \
        .double().numpy()                         # [n_pts, (L+1)^2]
    pinvs = []
    off = 0
    for l in range(l_max + 1):
        a = y[:, off:off + 2 * l + 1]             # [n_pts, 2l+1]
        pinvs.append(np.linalg.pinv(a.T))         # [n_pts, 2l+1]
        off += 2 * l + 1
    return dirs, pinvs


def wigner_blocks(rot: torch.Tensor, l_max: int, n_pts: int = 64,
                  m_max: Optional[int] = None) -> List[torch.Tensor]:
    """rot [..., 3, 3] -> the blocks D_l, l = 0..l_max, each
    ``[..., 2l+1, 2l+1]``; with ``m_max`` only the rows |m| <= m_max
    (``[..., n_kept_l, 2l+1]``), the eSCN cut at construction
    (``sh.py:129-153``)."""
    dirs_np, pinvs = _pinv_blocks(l_max, n_pts)
    dirs = torch.as_tensor(dirs_np, dtype=rot.dtype, device=rot.device)
    rdirs = torch.einsum("...ij,pj->...pi", rot, dirs)       # [..., P, 3]
    y_rot = real_sph_harm(rdirs, l_max)                      # [..., P, K]
    blocks = []
    off = 0
    for l in range(l_max + 1):
        b = y_rot[..., off:off + 2 * l + 1]                  # [..., P, 2l+1]
        if m_max is not None and l > m_max:
            b = b[..., l - m_max:l + m_max + 1]     # rows m = -m_max..m_max
        pinv = torch.as_tensor(pinvs[l], dtype=rot.dtype, device=rot.device)
        blocks.append(torch.einsum("...pm,pn->...mn", b, pinv))
        off += 2 * l + 1
    return blocks
