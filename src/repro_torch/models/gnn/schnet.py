"""SchNet [arXiv:1706.08566]: continuous-filter convolutions for
molecules (counterpart of ``repro.models.gnn.schnet``).

3 interaction blocks, hidden 64, 300 Gaussian RBFs, 10 Å cutoff: per
edge, distance -> RBF -> filter MLP -> times the gathered source
features -> scatter-sum into the target (the paper's push path).  The
per-graph energy is a second segment sum.  Both go through
``common.aggregate`` under the model's ``SystemConfig``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
from torch import nn

from repro_torch.core.config_space import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.mesh_compat import as_tensor_on, replicate_as
from repro_torch.models.gnn.common import (DEFAULT_GNN_CONFIG, MLPStack,
                                           _tensor, aggregate, gather_rows,
                                           graph_inputs,
                                           init_mlp_stack, layer_of,
                                           mlp_stack, mlp_stack_from_jax)

__all__ = ["SchNetConfig", "SchNet", "init_schnet", "schnet_forward",
           "schnet_loss", "schnet_params_from_jax", "shifted_softplus"]

_LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log 2`` in f32 (``jax.nn.softplus`` is
    ``logaddexp(x, 0)``)."""
    x = x.float()
    return torch.logaddexp(x, torch.zeros_like(x)) - _LOG2


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    n_graphs: int = 128   # graphs per batch
    sys: SystemConfig = DEFAULT_GNN_CONFIG


class SchNetBlock(nn.Module):
    """``filter`` (the filter MLP over the RBFs), ``in_`` (the
    reference's ``in``, no bias), ``out1``, ``out2``."""

    def __init__(self, filter: MLPStack, in_: L.Dense, out1: L.Dense,
                 out2: L.Dense):
        super().__init__()
        self.filter, self.in_, self.out1, self.out2 = filter, in_, out1, out2


class SchNet(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks, readout: MLPStack):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.readout = readout


def init_schnet(cfg: SchNetConfig, generator: torch.Generator,
                device=None) -> SchNet:
    device = resolve_device(device)
    h = cfg.d_hidden
    kw = dict(generator=generator, device=device)
    embed = torch.randn((cfg.n_species, h), generator=generator,
                        device=device).mul_(0.3)
    blocks = [SchNetBlock(
        init_mlp_stack((cfg.n_rbf, h, h), **kw),
        L.init_dense(h, h, False, torch.float32, **kw),
        L.init_dense(h, h, True, torch.float32, **kw),
        L.init_dense(h, h, True, torch.float32, **kw))
        for _ in range(cfg.n_interactions)]
    return SchNet(embed, blocks, init_mlp_stack((h, h // 2, 1), **kw))


def schnet_params_from_jax(params_np: Mapping, cfg: SchNetConfig,
                           device=None) -> SchNet:
    device = resolve_device(device)

    def dense(p):
        return L.Dense(_tensor(p["w"], device),
                       _tensor(p["b"], device) if "b" in p else None)

    blocks = []
    for i in range(cfg.n_interactions):
        bp = layer_of(params_np["blocks"], i)
        blocks.append(SchNetBlock(mlp_stack_from_jax(bp["filter"], device),
                                  dense(bp["in"]), dense(bp["out1"]),
                                  dense(bp["out2"])))
    return SchNet(_tensor(params_np["embed"], device), blocks,
                  mlp_stack_from_jax(params_np["readout"], device))


def _rbf(cfg: SchNetConfig, dist: torch.Tensor) -> torch.Tensor:
    centers = replicate_as(torch.linspace(0.0, cfg.cutoff, cfg.n_rbf,
                                          device=dist.device), dist)
    gamma = 10.0
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def schnet_forward(cfg: SchNetConfig, params: SchNet, inputs, *,
                   device=None) -> torch.Tensor:
    """inputs: species [N] int32, positions [N,3], src/dst [E],
    graph_ids [N] (``cfg.n_graphs`` graphs) -> energies [n_graphs]."""
    inputs = graph_inputs(params, inputs, device)
    n = inputs["species"].shape[0]
    src, dst = inputs["src"].long(), inputs["dst"].long()
    pos = inputs["positions"]
    x = params.embed[inputs["species"].long()]
    d = torch.linalg.norm(gather_rows(pos, src) - gather_rows(pos, dst)
                          + 1e-12, dim=-1)
    rbf = _rbf(cfg, d)
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.cutoff, 0, 1))
                 + 1.0)
    for bp in params.blocks:
        w = mlp_stack(bp.filter, rbf, act=shifted_softplus,
                      final_act=True) * env[:, None]
        msg = gather_rows(L.dense(bp.in_, x), src) * w
        agg = aggregate(msg, dst, n, "sum", cfg.sys)
        v = shifted_softplus(L.dense(bp.out1, agg))
        x = x + L.dense(bp.out2, v)
    atom_e = mlp_stack(params.readout, x, act=shifted_softplus)   # [N, 1]
    return aggregate(atom_e[:, 0], inputs["graph_ids"], cfg.n_graphs,
                     "sum", cfg.sys)


def schnet_loss(cfg: SchNetConfig, params: SchNet, batch, *,
                device=None) -> torch.Tensor:
    pred = schnet_forward(cfg, params, batch, device=device)
    energy = as_tensor_on(batch["energy"], pred.device)
    return torch.mean((pred - energy) ** 2)
