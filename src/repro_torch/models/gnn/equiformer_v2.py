"""EquiformerV2 [arXiv:2306.12059]: equivariant graph attention with
eSCN-style SO(2) convolutions, l_max=6, m_max=2, 8 heads, 12 layers
(counterpart of ``repro.models.gnn.equiformer_v2``).

Per edge, the node features (real-SH irreps, ``[N, (L+1)^2, C]``) are
rotated into the edge-aligned frame by Wigner blocks built by sample
projection (``sh.wigner_blocks``), keeping only the rows |m| <= m_max.
There the convolution is block-diagonal in m: each m-block mixes its
(cos, sin) pair through an (L-mix x C-mix) factorised SO(2) map
modulated by radial weights.  Messages are weighted by invariant
multi-head attention (``common.segment_softmax`` over incoming edges)
and rotated back before a scatter-sum node update.  Both reductions go
through ``common.aggregate`` under the model's ``SystemConfig``.

As in the reference, the edge tensors (the gathered source features,
the SO(2) conv, the messages and their sum) are bfloat16; the node
state is float32.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Mapping

import torch
from torch import nn

from repro_torch.core.config_space import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.models.gnn import sh
from repro_torch.models.mesh_compat import (as_tensor_on, is_dtensor,
                                            replicate_as)
from repro_torch.models.gnn.common import (DEFAULT_GNN_CONFIG, MLPStack,
                                           _tensor, aggregate, constrain_flat,
                                           gather_rows, rowwise,
                                           graph_inputs,
                                           init_mlp_stack, layer_of,
                                           mlp_stack, mlp_stack_from_jax,
                                           segment_softmax)

__all__ = ["EquiformerV2Config", "EquiformerV2", "init_equiformer",
           "equiformer_forward", "equiformer_loss",
           "equiformer_params_from_jax"]


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 64
    cutoff: float = 10.0
    n_species: int = 100
    n_graphs: int = 128
    sys: SystemConfig = DEFAULT_GNN_CONFIG

    @property
    def n_coeff(self) -> int:
        return (self.l_max + 1) ** 2

    @property
    def m_blocks(self):
        """Per |m| block: (m, number of l) for m = 0..m_max."""
        return [(m, self.l_max + 1 - m) for m in range(self.m_max + 1)]


def _compact_index(l_max: int, m_max: int):
    """(l, m) -> index in the compact (|m| <= m_max) l-major layout of
    the edge messages."""
    idx = {}
    n = 0
    for l in range(l_max + 1):
        mm = min(l, m_max)
        for m in range(-mm, mm + 1):
            idx[(l, m)] = n
            n += 1
    return idx, n


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class SO2(nn.Module):
    """``c_mix [C, C]``, and per m ``l_mix_{m}`` (and for m > 0
    ``l_mix_{m}_im``) ``[n_l, n_l]``: the reference's keys."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for k, v in tensors.items():
            self.register_parameter(k, _param(v))


class EquiformerBlock(nn.Module):
    def __init__(self, so2: SO2, radial: MLPStack, attn: MLPStack,
                 lin_out: torch.Tensor, gate: MLPStack, ffn0: MLPStack):
        super().__init__()
        self.so2, self.radial, self.attn = so2, radial, attn
        self.lin_out = _param(lin_out)
        self.gate, self.ffn0 = gate, ffn0


class EquiformerV2(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks, head: MLPStack):
        super().__init__()
        self.embed = _param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.head = head


def init_equiformer(cfg: EquiformerV2Config, generator: torch.Generator,
                    device=None) -> EquiformerV2:
    device = resolve_device(device)
    c, h = cfg.d_hidden, cfg.n_heads
    kw = dict(generator=generator, device=device)

    def normal(shape, scale):
        return torch.randn(shape, **kw).mul_(scale)

    def block():
        so2 = {"c_mix": normal((c, c), c ** -0.5)}
        for m, nl in cfg.m_blocks:
            so2[f"l_mix_{m}"] = normal((nl, nl), nl ** -0.5)
            if m > 0:
                so2[f"l_mix_{m}_im"] = normal((nl, nl), nl ** -0.5)
        return EquiformerBlock(
            SO2(so2), init_mlp_stack((cfg.n_rbf, c, cfg.m_max + 1), **kw),
            init_mlp_stack((2 * c + cfg.n_rbf, c, h), **kw),
            normal((cfg.l_max + 1, c, c), c ** -0.5),
            init_mlp_stack((c, c * cfg.l_max), **kw),
            init_mlp_stack((c, 2 * c, c), **kw))

    embed = normal((cfg.n_species, c), 0.3)
    blocks = [block() for _ in range(cfg.n_layers)]
    return EquiformerV2(embed, blocks, init_mlp_stack((c, c, 1), **kw))


def equiformer_params_from_jax(params_np: Mapping, cfg: EquiformerV2Config,
                               device=None) -> EquiformerV2:
    device = resolve_device(device)
    blocks = []
    for i in range(cfg.n_layers):
        bp = layer_of(params_np["blocks"], i)
        blocks.append(EquiformerBlock(
            SO2({k: _tensor(v, device) for k, v in bp["so2"].items()}),
            mlp_stack_from_jax(bp["radial"], device),
            mlp_stack_from_jax(bp["attn"], device),
            _tensor(bp["lin_out"], device),
            mlp_stack_from_jax(bp["gate"], device),
            mlp_stack_from_jax(bp["ffn0"], device)))
    return EquiformerV2(_tensor(params_np["embed"], device), blocks,
                        mlp_stack_from_jax(params_np["head"], device))


def _so2_conv(cfg: EquiformerV2Config, p: SO2, z: torch.Tensor,
              radial: torch.Tensor) -> torch.Tensor:
    """The SO(2) conv in the edge frame, compact layout: z [E, n_kept, C];
    radial [E, m_max+1], one modulation per m."""
    cidx, _ = _compact_index(cfg.l_max, cfg.m_max)
    cm = p.c_mix.to(z.dtype)
    out = torch.zeros_like(z)
    for m, nl in cfg.m_blocks:
        ls = range(m, cfg.l_max + 1)
        rows_p = [cidx[(l, m)] for l in ls]
        lr = getattr(p, f"l_mix_{m}").to(z.dtype)
        r = radial[:, m, None, None]
        if m == 0:
            y0 = torch.einsum("enc,nm,cd->emd", z[:, rows_p, :], lr, cm)
            out[:, rows_p, :] = (y0 * r).to(out.dtype)
        else:
            rows_n = [cidx[(l, -m)] for l in ls]
            li = getattr(p, f"l_mix_{m}_im").to(z.dtype)
            xp, xn = z[:, rows_p, :], z[:, rows_n, :]
            yp = torch.einsum("enc,nm,cd->emd", xp, lr, cm) \
                - torch.einsum("enc,nm,cd->emd", xn, li, cm)
            yn = torch.einsum("enc,nm,cd->emd", xn, lr, cm) \
                + torch.einsum("enc,nm,cd->emd", xp, li, cm)
            out[:, rows_p, :] = (yp * r).to(out.dtype)
            out[:, rows_n, :] = (yn * r).to(out.dtype)
    return out


def _rotate_in(blocks, x: torch.Tensor) -> torch.Tensor:
    """Full layout -> compact edge frame, ``z_l = D_kept_l @ x_l``."""
    outs = []
    off = 0
    for l, d in enumerate(blocks):
        xl = x[:, off:off + 2 * l + 1, :]
        outs.append(torch.einsum("emk,ekc->emc", d.to(x.dtype), xl))
        off += 2 * l + 1
    return torch.cat(outs, dim=1)


def _rotate_out(blocks, z: torch.Tensor) -> torch.Tensor:
    """Compact edge frame -> full layout, ``out_l = D_kept_l^T @ z_l``."""
    outs = []
    off = 0
    for d in blocks:
        nk = d.shape[-2]
        zl = z[:, off:off + nk, :]
        outs.append(torch.einsum("emk,emc->ekc", d.to(z.dtype), zl))
        off += nk
    return torch.cat(outs, dim=1)


def _message(cfg: EquiformerV2Config, rots, xs: torch.Tensor, so2: Mapping,
             radial: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The eSCN message of each edge: rotate -> SO(2) conv -> attention
    weights -> rotate back (row-wise over the edges)."""
    c = cfg.d_hidden
    z = _rotate_in(rots, xs)                                   # [E, nk, C]
    z = _so2_conv(cfg, SimpleNamespace(**so2), z, radial)
    aw = torch.repeat_interleave(alpha, c // cfg.n_heads, dim=-1)
    z = z * aw[:, None, :].to(z.dtype)
    return _rotate_out(rots, z)


def _rbf(cfg: EquiformerV2Config, dist: torch.Tensor) -> torch.Tensor:
    centers = replicate_as(torch.linspace(0.0, cfg.cutoff, cfg.n_rbf,
                                          device=dist.device), dist)
    width = cfg.cutoff / cfg.n_rbf
    return torch.exp(-((dist[:, None] - centers[None, :]) / width) ** 2)


def equiformer_forward(cfg: EquiformerV2Config, params: EquiformerV2,
                       inputs, *, device=None) -> torch.Tensor:
    """inputs: species [N], positions [N,3], src/dst [E], graph_ids [N]
    -> energies [n_graphs]."""
    inputs = graph_inputs(params, inputs, device)
    n = inputs["species"].shape[0]
    src, dst = inputs["src"].long(), inputs["dst"].long()
    pos = inputs["positions"]
    vec = gather_rows(pos, src) - gather_rows(pos, dst)
    dist = torch.linalg.norm(vec + 1e-9, dim=-1)
    unit = vec / torch.maximum(dist, replicate_as(dist.new_tensor(1e-9),
                                                  dist))[:, None]
    rbf = _rbf(cfg, dist)
    rots = rowwise(lambda u: sh.wigner_blocks(sh.align_z_rotation(u),
                                              cfg.l_max, m_max=cfg.m_max),
                   unit, n_out=cfg.l_max + 1)

    k, c = cfg.n_coeff, cfg.d_hidden
    emb = params.embed[inputs["species"].long()]
    if is_dtensor(emb):       # DTensors are concatenated, not written
        x0 = emb[:, None, :].float()
        x = torch.cat([x0, torch.zeros_like(x0).expand(n, k - 1, c)], dim=1)
    else:
        x = torch.zeros((n, k, c), dtype=torch.float32, device=pos.device)
        x[:, 0, :] = emb
    for bp in params.blocks:
        x = constrain_flat(x)                  # equiformer_v2.py:200-203
        # invariant multi-head attention over incoming edges (pull)
        inv = x[:, 0, :]
        feat = torch.cat([gather_rows(inv, src), gather_rows(inv, dst), rbf],
                         dim=-1)
        logits = mlp_stack(bp.attn, feat)                      # [E, H]
        alpha = segment_softmax(logits, dst, n, cfg.sys)       # [E, H]
        # eSCN message: rotate -> SO(2) conv -> rotate back (push), the
        # edge tensors in bf16, cast before the source gather
        radial = mlp_stack(bp.radial, rbf).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        msg = rowwise(functools.partial(_message, cfg), rots,
                      gather_rows(xb, src), dict(bp.so2.named_parameters()),
                      radial, alpha)                           # full layout
        agg = aggregate(msg, dst, n, "sum", cfg.sys).float()   # [N, K, C]
        # node update: per-l linear, then the gated nonlinearity
        upd = []
        off = 0
        for l in range(cfg.l_max + 1):
            upd.append(torch.einsum("nmc,cd->nmd",
                                    agg[:, off:off + 2 * l + 1, :],
                                    bp.lin_out[l]))
            off += 2 * l + 1
        x = x + torch.cat(upd, dim=1)
        gates = torch.sigmoid(mlp_stack(bp.gate, x[:, 0, :]))  # [N, C*L]
        gates = gates.reshape(n, cfg.l_max, c)
        scale = torch.cat(
            [torch.ones_like(x[:, :1, :])]
            + [gates[:, l - 1:l, :].expand(n, 2 * l + 1, c)
               for l in range(1, cfg.l_max + 1)], dim=1)
        x = x * scale
        x0 = x[:, 0, :] + mlp_stack(bp.ffn0, x[:, 0, :])
        x = torch.cat([x0[:, None, :], x[:, 1:, :]], dim=1)
    atom_e = mlp_stack(params.head, x[:, 0, :])                # invariant
    return aggregate(atom_e[:, 0], inputs["graph_ids"], cfg.n_graphs,
                     "sum", cfg.sys)


def equiformer_loss(cfg: EquiformerV2Config, params: EquiformerV2, batch, *,
                    device=None) -> torch.Tensor:
    pred = equiformer_forward(cfg, params, batch, device=device)
    energy = as_tensor_on(batch["energy"], pred.device)
    return torch.mean((pred - energy) ** 2)
