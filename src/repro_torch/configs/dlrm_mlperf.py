"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM (Criteo 1TB): 13 dense,
26 sparse, dim 128, bot 512-256-128, top 1024-1024-512-256-1, dot
interaction.  Counterpart of ``repro.configs.dlrm_mlperf`` with the
cells of ``repro.configs.base.make_dlrm_arch`` (``base.py:440-453``):
the serving cells and ``train_batch``, whose step is
``configs.base.dlrm_train_step``.

The full tables (187,770,880 padded rows x 128 x f32, 96.1 GB) exceed
one 80 GB card; :func:`capped` caps every table's rows for a one-card
deployment, and the batches of a capped config draw their indices below
the cap, as MLPerf's ``--max-ind-range`` hashing does at a larger range.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import make_dlrm_arch
from repro_torch.data.synthetic import dlrm_batch
from repro_torch.device import resolve_device
from repro_torch.models.dlrm import (DLRM, DLRMConfig, dlrm_forward,
                                     retrieval_score)
from repro_torch.models.mesh_compat import serving

__all__ = ["CFG", "REDUCED", "SERVE_CELLS", "TRAIN_CELLS",
           "RETRIEVAL_CANDIDATES", "capped", "serving_batch",
           "training_batch", "serve_step", "retrieval_step", "arch"]

CFG = DLRMConfig()

REDUCED = DLRMConfig(vocab_sizes=(1000, 200, 50, 300, 77, 10),
                     embed_dim=16, bot_mlp=(64, 32, 16),
                     top_mlp=(64, 32, 1))

#: Requests per serving cell: serve_p99 and serve_bulk are forward
#: passes, retrieval_cand scores one query against the candidates.
SERVE_CELLS = {"serve_p99": 512, "serve_bulk": 262_144, "retrieval_cand": 1}
#: Samples per train step (``base.py:442``).
TRAIN_CELLS = {"train_batch": 65_536}
#: 1,000,000 candidates padded to a multiple of 512 (``base.py:412``).
RETRIEVAL_CANDIDATES = -(-1_000_000 // 512) * 512


def capped(cfg: DLRMConfig, max_rows: int) -> DLRMConfig:
    """``cfg`` with every table's rows capped at ``max_rows``; all widths
    unchanged."""
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-rows{max_rows}",
        vocab_sizes=tuple(min(v, max_rows) for v in cfg.vocab_sizes))


def serving_batch(cfg: DLRMConfig, cell: str, step: int, *, seed: int = 0,
                  device=None) -> dict:
    """The inputs of one request of ``cell`` on ``device``: the
    ``dlrm_batch`` of (seed, step) and, for retrieval_cand, candidate
    embeddings drawn on the device from a generator seeded by
    (seed, step)."""
    device = resolve_device(device)
    batch = dlrm_batch(step, SERVE_CELLS[cell], cfg.vocab_sizes,
                       cfg.multi_hot, seed=seed)
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if cell == "retrieval_cand":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + step)
        out["cand"] = torch.randn((RETRIEVAL_CANDIDATES, cfg.embed_dim),
                                  generator=gen, device=device)
        del out["label"]
    return out


def training_batch(cfg: DLRMConfig, step: int, *, batch: int,
                   seed: int = 0, device=None) -> dict:
    """The ``dlrm_batch`` of (seed, step) on ``device``, of ``batch``
    samples (``TRAIN_CELLS["train_batch"]`` in the train_batch cell)."""
    device = resolve_device(device)
    arrays = dlrm_batch(step, batch, cfg.vocab_sizes, cfg.multi_hot,
                        seed=seed)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@serving
def serve_step(cfg: DLRMConfig, params: DLRM, batch, *, impl="kernel",
               device=None) -> torch.Tensor:
    """serve_p99 / serve_bulk: the logits of one request."""
    return dlrm_forward(cfg, params, batch, impl=impl, device=device)


@serving
def retrieval_step(cfg: DLRMConfig, params: DLRM, batch,
                   device=None) -> torch.Tensor:
    """retrieval_cand: the candidates' scores for one query."""
    return retrieval_score(cfg, params, batch, device=device)


def arch(axes=None):  # axes unused: no mesh axis names in the config
    return make_dlrm_arch("dlrm-mlperf", CFG, REDUCED)
