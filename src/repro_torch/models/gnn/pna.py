"""PNA, Principal Neighbourhood Aggregation [arXiv:2004.05718]
(counterpart of ``repro.models.gnn.pna``).

4 layers, hidden 75, aggregators {mean, max, min, std} x scalers
{identity, amplification, attenuation}: 12 aggregated views, concatenated
and mixed by a linear tower.  The four reductions of a layer each go
through ``common.aggregate`` under the model's ``SystemConfig``.  An
empty neighbourhood's max and min are the identities ``-inf`` / ``+inf``,
replaced by 0 (``pna.py:73-74``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from repro_torch.core.config_space import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.gnn.common import (DEFAULT_GNN_CONFIG, MLPStack,
                                           aggregate, graph_inputs,
                                           init_mlp_stack, layer_of,
                                           mlp_stack, mlp_stack_from_jax)

__all__ = ["PNAConfig", "PNA", "init_pna", "pna_forward", "pna_loss",
           "pna_params_from_jax"]


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 7
    delta: float = 2.5   # mean log-degree of the training graphs
    sys: SystemConfig = DEFAULT_GNN_CONFIG


class PNABlock(nn.Module):
    def __init__(self, pre: MLPStack, post: MLPStack):
        super().__init__()
        self.pre, self.post = pre, post


class PNA(nn.Module):
    """``enc``, ``blocks`` (``pre``: the message MLP of (h_src, h_dst);
    ``post``: the update tower with its layer norm) and ``head``."""

    def __init__(self, enc: MLPStack, blocks, head: MLPStack):
        super().__init__()
        self.enc = enc
        self.blocks = nn.ModuleList(blocks)
        self.head = head


def init_pna(cfg: PNAConfig, generator: torch.Generator,
             device=None) -> PNA:
    device = resolve_device(device)
    h = cfg.d_hidden
    kw = dict(generator=generator, device=device)
    enc = init_mlp_stack((cfg.d_in, h), **kw)
    blocks = [PNABlock(init_mlp_stack((2 * h, h), **kw),
                       init_mlp_stack((12 * h + h, h), layer_norm=True, **kw))
              for _ in range(cfg.n_layers)]
    return PNA(enc, blocks, init_mlp_stack((h, h, cfg.n_classes), **kw))


def pna_params_from_jax(params_np: Mapping, cfg: PNAConfig,
                        device=None) -> PNA:
    """The port's PNA holding ``repro.models.gnn.pna.init_pna``'s
    parameters (numpy arrays, blocks stacked)."""
    device = resolve_device(device)
    blocks = []
    for i in range(cfg.n_layers):
        bp = layer_of(params_np["blocks"], i)
        blocks.append(PNABlock(mlp_stack_from_jax(bp["pre"], device),
                               mlp_stack_from_jax(bp["post"], device)))
    return PNA(mlp_stack_from_jax(params_np["enc"], device), blocks,
               mlp_stack_from_jax(params_np["head"], device))


def pna_forward(cfg: PNAConfig, params: PNA, inputs, *,
                device=None) -> torch.Tensor:
    """inputs: node_feat [N,F], src/dst [E], in_degree [N] -> logits
    [N, n_classes]."""
    inputs = graph_inputs(params, inputs, device)
    n = inputs["node_feat"].shape[0]
    src, dst = inputs["src"].long(), inputs["dst"].long()
    deg = inputs["in_degree"].float().clamp_min(1.0)
    log_deg = torch.log(deg + 1.0)[:, None]
    s_amp = log_deg / cfg.delta
    s_att = cfg.delta / log_deg
    zero = deg.new_zeros(())

    h = mlp_stack(params.enc, inputs["node_feat"])
    for bp in params.blocks:
        msg = mlp_stack(bp.pre, torch.cat([h[src], h[dst]], dim=-1))
        ssum = aggregate(msg, dst, n, "sum", cfg.sys)
        mean = ssum / deg[:, None]
        mx = aggregate(msg, dst, n, "max", cfg.sys)
        mn = aggregate(msg, dst, n, "min", cfg.sys)
        sq = aggregate(msg * msg, dst, n, "sum", cfg.sys) / deg[:, None]
        # torch.maximum: at a tie (a node of in-degree 1 has sq == mean^2
        # exactly) its gradient is jnp.maximum's, half to each side
        std = torch.sqrt(torch.maximum(sq - mean * mean, zero) + 1e-5)
        mx = torch.where(torch.isfinite(mx), mx, zero)
        mn = torch.where(torch.isfinite(mn), mn, zero)
        agg = torch.cat([mean, mx, mn, std], dim=-1)            # [N, 4h]
        agg = torch.cat([agg, agg * s_amp, agg * s_att], dim=-1)
        h = h + mlp_stack(bp.post, torch.cat([h, agg], dim=-1))
    return mlp_stack(params.head, h)


def pna_loss(cfg: PNAConfig, params: PNA, batch, *,
             device=None) -> torch.Tensor:
    logits = pna_forward(cfg, params, batch, device=device)
    return L.cross_entropy(logits, torch.as_tensor(batch["labels"])
                           .to(logits.device))
