"""DLRM (MLPerf config, Criteo-1TB) [arXiv:1906.00091]; counterpart of
``repro.models.dlrm``.

13 dense features -> bottom MLP 512-256-128; 26 categorical features ->
embedding tables (dim 128) pooled by the embedding-bag kernel (K3, one
launch for all 26 features, written straight into the interaction's
input); dot-product interaction over the 27 vectors; top MLP
1024-1024-512-256-1; BCE loss.  ``retrieval_score`` scores one user
against a million candidate embeddings as one batched dot.

The parameters are one :class:`DLRM` module: ``tables`` (a tuple of
``[rows, D]`` float32 tables, registered as ``table_0`` ...), ``bot`` and
``top``
(:class:`~repro_torch.models.gnn.common.MLPStack`, ``layers[i].{w, b}``
with ``w [d_in, d_out]`` as in the reference).
:func:`dlrm_params_from_jax` carries the reference's parameters across.

Training differentiates :func:`dlrm_loss`, which pools through the plain
embedding bag by default, as the reference's loss does (``impl="xla"``):
K3 has no backward and writes the interaction's input behind autograd's
back, so it raises when a table requires grad.  The plain path writes
the same buffer by slice assignment, which autograd follows, and each
table's gradient is dense (``[rows, D]``, nonzero on the rows looked
up), as ``jax.grad``'s is.  The parameters are built with
``requires_grad=False``; a train step turns it on, and serving runs
under ``torch.inference_mode`` (``configs.dlrm_mlperf.serve_step``).
Every entry point takes ``device=None``, meaning the CUDA card, and
raises without one unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bags
from repro_torch.models.gnn.common import (MLPStack, init_mlp_stack,
                                           mlp_stack)
from repro_torch.models.layers import Dense
from repro_torch.models.mesh_compat import (as_tensor_on, is_dtensor,
                                            replicate_as)

__all__ = ["DLRMConfig", "CRITEO_1TB_VOCABS", "DLRM", "init_dlrm",
           "dlrm_params_from_jax", "dlrm_forward", "dlrm_loss",
           "retrieval_score"]

#: MLPerf DLRM (Criteo Terabyte) per-feature vocabulary sizes.
CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocab_sizes: tuple[int, ...] = CRITEO_1TB_VOCABS
    embed_dim: int = 128
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    multi_hot: int = 1     # indices per feature (bag size)

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def padded_vocab_sizes(self) -> tuple[int, ...]:
        """Table allocation sizes: tables of 4,096 rows or more round up
        to a multiple of 512 rows (the reference row-shards them);
        lookups use logical indices, so padding rows are never read."""
        return tuple(-(-v // 512) * 512 if v >= 4096 else v
                     for v in self.vocab_sizes)

    @property
    def n_embed_rows(self) -> int:
        return sum(self.vocab_sizes)

    @property
    def n_params(self) -> int:
        d = self.embed_dim
        n = self.n_embed_rows * d
        dims = (self.n_dense,) + self.bot_mlp
        n += sum(dims[i] * dims[i + 1] + dims[i + 1]
                 for i in range(len(dims) - 1))
        n_int = (self.n_sparse + 1) * self.n_sparse // 2 + d
        tdims = (n_int,) + self.top_mlp
        n += sum(tdims[i] * tdims[i + 1] + tdims[i + 1]
                 for i in range(len(tdims) - 1))
        return n


class DLRM(nn.Module):
    """The parameters of one DLRM: embedding tables and the two towers."""

    def __init__(self, tables: Sequence[torch.Tensor], bot: MLPStack,
                 top: MLPStack):
        super().__init__()
        self._table_names = tuple(f"table_{i}" for i in range(len(tables)))
        for name, t in zip(self._table_names, tables):
            self.register_parameter(name,
                                    nn.Parameter(t, requires_grad=False))
        self.bot = bot
        self.top = top

    @property
    def tables(self) -> tuple:
        """The embedding tables, in feature order (a tuple, cheap to
        build per request, unlike iterating an ``nn.ParameterList``)."""
        return tuple(self._parameters[name] for name in self._table_names)

    @property
    def device(self) -> torch.device:
        return self._parameters[self._table_names[0]].device


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator,
              device=None) -> DLRM:
    """Random DLRM parameters on ``device``, drawn from ``generator``
    (which must live on that device): tables ``N(0, 1) / sqrt(rows)``
    over the padded row counts, towers as ``init_mlp_stack``."""
    device = resolve_device(device)
    d = cfg.embed_dim
    n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2 + d
    bot = init_mlp_stack((cfg.n_dense,) + cfg.bot_mlp, generator=generator,
                         device=device)
    top = init_mlp_stack((n_int,) + cfg.top_mlp, generator=generator,
                         device=device)
    tables = [torch.randn((v, d), generator=generator, device=device,
                          dtype=torch.float32).mul_(1.0 / np.sqrt(v))
              for v in cfg.padded_vocab_sizes]
    return DLRM(tables, bot, top)


def dlrm_params_from_jax(params_np: Mapping, device=None) -> DLRM:
    """The port's :class:`DLRM` holding the parameters of
    ``repro.models.dlrm.init_dlrm`` (a pytree of numpy arrays:
    ``tables`` list, ``bot``/``top`` ``{"layers": [{"w", "b"}, ...]}``)."""
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def stack(p):
        return MLPStack([Dense(t(lp["w"]), t(lp["b"])) for lp in p["layers"]])

    return DLRM([t(x) for x in params_np["tables"]],
                stack(params_np["bot"]), stack(params_np["top"]))


def _on(params: DLRM, batch: Mapping, device) -> dict:
    """``batch``'s arrays as tensors on ``device``, where ``params`` must
    already be."""
    device = resolve_device(device)
    if params.device != device:
        raise ValueError(f"DLRM parameters are on {params.device}, the "
                         f"call asks for {device}")
    return {k: as_tensor_on(v, device) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _pair_index(n: int, device: torch.device) -> torch.Tensor:
    """Flat indices ``i * n + j`` of the pairs i < j of n vectors, in
    ``jnp.triu_indices``'s row-major order; built once per (n, device),
    as a normal tensor even when first asked for under inference mode."""
    with torch.inference_mode(False):
        iu, ju = torch.triu_indices(n, n, offset=1)
        return (iu * n + ju).to(device)


def _interact_z(z: torch.Tensor) -> torch.Tensor:
    """z [B, F+1, D], the bottom output then the F pooled features ->
    the bottom output, then the upper triangle of the Gram matrix of the
    F + 1 vectors (row-major, as ``jnp.triu_indices``)."""
    b, n, _ = z.shape
    gram = torch.bmm(z, z.transpose(1, 2)).float().view(b, n * n)
    pairs = gram.index_select(1, replicate_as(_pair_index(n, z.device), z))
    return torch.cat([z[:, 0], pairs.to(z.dtype)], dim=-1)


def _sharded_interact(z: torch.Tensor) -> torch.Tensor:
    """:func:`_interact_z` of a DTensor z, each rank on its own samples
    in ``local_map`` (the pair gather's backward, an ``index_add``, has
    no DTensor sharding rule in every PyTorch release)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = z.device_mesh
    pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
               else Replicate() for p in z.placements)
    return local_map(_interact_z, out_placements=list(pl),
                     in_placements=(pl,))(z.redistribute(mesh, pl))


def _interact(bottom: torch.Tensor, embs: torch.Tensor) -> torch.Tensor:
    """bottom [B, D]; embs [B, F, D] -> the upper triangle of the Gram
    matrix of the F + 1 vectors (row-major, as ``jnp.triu_indices``),
    after the bottom output passed through."""
    return _interact_z(torch.cat([bottom[:, None, :], embs], dim=1))


def dlrm_forward(cfg: DLRMConfig, params: DLRM, batch: Mapping,
                 impl: str = "kernel", device=None) -> torch.Tensor:
    """Logits [B].  batch: dense [B, 13] f32; sparse [B, 26, multi_hot]
    int32.  ``impl`` picks the embedding bag: the kernel, or ``"plain"``
    for comparison.  Either way the pooled features are written once,
    into the interaction's input ``z [B, 27, D]`` after the bottom
    output, so both feed the interaction the same tensor."""
    batch = _on(params, batch, device)
    bottom = mlp_stack(params.bot, batch["dense"], final_act=True)
    sparse = batch["sparse"]
    if is_dtensor(bottom):      # DTensors are concatenated, not written
        embs = embedding_bags(params.tables, sparse, mode="sum", impl=impl)
        x = _sharded_interact(torch.cat([bottom[:, None, :], embs], dim=1))
        return mlp_stack(params.top, x)[:, 0]
    z = torch.empty((bottom.shape[0], cfg.n_sparse + 1, bottom.shape[1]),
                    dtype=bottom.dtype, device=bottom.device)
    z[:, 0] = bottom
    embedding_bags(params.tables, sparse, mode="sum", impl=impl,
                   out=z[:, 1:])                                # [B, 26, D]
    x = _interact_z(z)
    del z  # 3.6 GB at serve_bulk's batch: not held through the top MLP
    return mlp_stack(params.top, x)[:, 0]


def dlrm_loss(cfg: DLRMConfig, params: DLRM, batch: Mapping,
              impl: str = "plain", device=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``label``
    (the numerically stable form, ``dlrm.py:115-120``), differentiable in
    every parameter with the default ``impl="plain"``."""
    batch = _on(params, batch, device)
    z = dlrm_forward(cfg, params, batch, impl=impl, device=device).float()
    y = batch["label"].float()
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def retrieval_score(cfg: DLRMConfig, params: DLRM, batch: Mapping,
                    device=None) -> torch.Tensor:
    """One query scored against ``cand [N_c, D]``: returns [N_c] scores,
    the dot of each candidate with the bottom tower's output."""
    batch = _on(params, batch, device)
    bottom = mlp_stack(params.bot, batch["dense"], final_act=True)  # [1, D]
    return torch.einsum("nd,bd->n", batch["cand"], bottom)
