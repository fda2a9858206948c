"""Shared neural building blocks (counterpart of ``repro.models.layers``).

Only the dense layer is ported so far (``layers.py:33-52``), in the one
form DLRM's towers use: float32 with a bias.  Its parameters live in a
small ``nn.Module`` whose attribute names are the reference pytree's keys
(``w``, ``b``), and :func:`dense` takes the module as the reference takes
the dict.  ``w`` keeps the reference's ``[d_in, d_out]`` layout:
``dense`` computes ``x @ w + b``.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Dense", "init_dense", "dense"]


class Dense(nn.Module):
    """``w [d_in, d_out]`` and a bias ``b [d_out]``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)


def init_dense(d_in: int, d_out: int, *, generator: torch.Generator,
               device) -> Dense:
    """float32 normal weights times ``d_in ** -0.5``; zero bias."""
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32) * d_in ** -0.5
    return Dense(w, torch.zeros((d_out,), dtype=torch.float32,
                                device=device))


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; the output's type is the input's."""
    return x @ p.w + p.b
