"""Shared GNN helpers (counterpart of ``repro.models.gnn.common``).

Only the MLP stack is ported so far (``common.py:97-116``), in the form
DLRM's bottom and top towers use: float32 dense layers with bias, ReLU,
no final layer norm.  ``aggregate`` and ``segment_softmax`` come with
the GNN models.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.models import layers as L

__all__ = ["MLPStack", "init_mlp_stack", "mlp_stack"]


class MLPStack(nn.Module):
    """``layers[i]`` are :class:`~repro_torch.models.layers.Dense`."""

    def __init__(self, layers: Sequence[L.Dense]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def init_mlp_stack(dims: Sequence[int], *, generator: torch.Generator,
                   device) -> MLPStack:
    return MLPStack([L.init_dense(dims[i], dims[i + 1], use_bias=True,
                                  dtype=torch.float32, generator=generator,
                                  device=device)
                     for i in range(len(dims) - 1)])


def mlp_stack(p: MLPStack, x: torch.Tensor,
              final_act: bool = False) -> torch.Tensor:
    """Dense layers with ReLU between them (and after the last one with
    ``final_act``), applied in float32 and cast back."""
    n = len(p.layers)
    for i, lp in enumerate(p.layers):
        x = L.dense(lp, x)
        if i < n - 1 or final_act:
            x = torch.relu(x.float()).to(x.dtype)
    return x
