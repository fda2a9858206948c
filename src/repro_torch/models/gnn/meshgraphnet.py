"""MeshGraphNet [arXiv:2010.03409]: encode-process-decode over a mesh
(counterpart of ``repro.models.gnn.meshgraphnet``).

15 message-passing blocks: the edge update MLP(e, h_src, h_dst) and the
node update MLP(h, sum of incoming edge features), residuals and layer
norms, 2-layer MLPs of width 128.  The sum goes through
``common.aggregate`` under the model's ``SystemConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from repro_torch.core.config_space import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.models.mesh_compat import as_tensor_on
from repro_torch.models.gnn.common import (DEFAULT_GNN_CONFIG, MLPStack,
                                           aggregate, gather_rows,
                                           graph_inputs,
                                           init_mlp_stack, layer_of,
                                           mlp_stack, mlp_stack_from_jax)

__all__ = ["MGNConfig", "MGN", "init_mgn", "mgn_forward", "mgn_loss",
           "mgn_params_from_jax"]


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 12
    d_edge_in: int = 4
    d_out: int = 3
    sys: SystemConfig = DEFAULT_GNN_CONFIG


def _mlp_dims(cfg: MGNConfig, d_in: int):
    return (d_in,) + (cfg.d_hidden,) * cfg.mlp_layers


class MGNBlock(nn.Module):
    def __init__(self, edge: MLPStack, node: MLPStack):
        super().__init__()
        self.edge, self.node = edge, node


class MGN(nn.Module):
    def __init__(self, node_enc: MLPStack, edge_enc: MLPStack, blocks,
                 decoder: MLPStack):
        super().__init__()
        self.node_enc, self.edge_enc = node_enc, edge_enc
        self.blocks = nn.ModuleList(blocks)
        self.decoder = decoder


def init_mgn(cfg: MGNConfig, generator: torch.Generator,
             device=None) -> MGN:
    device = resolve_device(device)
    h = cfg.d_hidden
    kw = dict(generator=generator, device=device, layer_norm=True)
    node_enc = init_mlp_stack(_mlp_dims(cfg, cfg.d_node_in), **kw)
    edge_enc = init_mlp_stack(_mlp_dims(cfg, cfg.d_edge_in), **kw)
    blocks = [MGNBlock(init_mlp_stack(_mlp_dims(cfg, 3 * h), **kw),
                       init_mlp_stack(_mlp_dims(cfg, 2 * h), **kw))
              for _ in range(cfg.n_layers)]
    decoder = init_mlp_stack((h, h, cfg.d_out), generator=generator,
                             device=device)
    return MGN(node_enc, edge_enc, blocks, decoder)


def mgn_params_from_jax(params_np: Mapping, cfg: MGNConfig,
                        device=None) -> MGN:
    device = resolve_device(device)
    blocks = []
    for i in range(cfg.n_layers):
        bp = layer_of(params_np["blocks"], i)
        blocks.append(MGNBlock(mlp_stack_from_jax(bp["edge"], device),
                               mlp_stack_from_jax(bp["node"], device)))
    return MGN(mlp_stack_from_jax(params_np["node_enc"], device),
               mlp_stack_from_jax(params_np["edge_enc"], device), blocks,
               mlp_stack_from_jax(params_np["decoder"], device))


def mgn_forward(cfg: MGNConfig, params: MGN, inputs, *,
                device=None) -> torch.Tensor:
    """inputs: node_feat [N,Fn], edge_feat [E,Fe], src [E], dst [E] ->
    [N, d_out]."""
    inputs = graph_inputs(params, inputs, device)
    n = inputs["node_feat"].shape[0]
    h = mlp_stack(params.node_enc, inputs["node_feat"])
    e = mlp_stack(params.edge_enc, inputs["edge_feat"])
    src, dst = inputs["src"].long(), inputs["dst"].long()
    for bp in params.blocks:
        he = torch.cat([e, gather_rows(h, src), gather_rows(h, dst)],
                       dim=-1)
        e = e + mlp_stack(bp.edge, he)
        agg = aggregate(e, dst, n, "sum", cfg.sys)
        h = h + mlp_stack(bp.node, torch.cat([h, agg], dim=-1))
    return mlp_stack(params.decoder, h)


def mgn_loss(cfg: MGNConfig, params: MGN, batch, *,
             device=None) -> torch.Tensor:
    pred = mgn_forward(cfg, params, batch, device=device)
    target = as_tensor_on(batch["target"], pred.device)
    return torch.mean((pred - target) ** 2)
