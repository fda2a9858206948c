"""The train steps of the model zoo (counterpart of the ``step``\\ s of
``repro.configs.base``'s train cells): the LM step of
``lm_train_cell`` (``base.py:146-189``), with gradient accumulation over
microbatches, for the dense LMs and the MoEs alike; the GNN step of
``make_gnn_arch`` (``base.py:351-392``) and DLRM's ``train_step`` of
``make_dlrm_arch`` (``base.py:429-433``), both a loss and AdamW at lr
1e-3.  :data:`GNN_SHAPES` are the GNNs' four input shapes.  ``Axes``,
the shardings and the dry-run's specs come with the sharding pieces.

A step is ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``, as :func:`repro_torch.train.trainer.train_loop` calls it.
It turns ``requires_grad`` on for every parameter, computes the loss and
the gradients with ``torch.autograd.grad`` (nothing is left in
``.grad``), and hands them to ``adamw_update``, which writes the
parameters and the state in place.  Nothing is written before the
gradients and their norm exist, so a step that raises can be run again.
``metrics`` holds ``loss`` and ``grad_norm`` as f32 scalar tensors.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRMConfig, dlrm_loss
from repro_torch.models.transformer import LMConfig, train_forward
from repro_torch.optim.adamw import AdamWConfig, adamw_update

__all__ = ["lm_train_step", "loss_train_step", "dlrm_train_step",
           "trainable", "value_and_grad", "GNN_SHAPES"]


def _pad512(n: int) -> int:
    """Graph tensors padded up to the 512-device multiple, as the
    reference's dry-run shapes are (``base.py:279-283``)."""
    return -(-n // 512) * 512


#: the GNNs' four input shapes: (n_nodes, n_edges, d_feat, n_graphs)
#: (``base.py:287-298``)
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=_pad512(2708), n_edges=_pad512(10556),
                          d_feat=1433, n_graphs=1, kind="train"),
    "minibatch_lg": dict(n_nodes=_pad512(1024 * (1 + 10 + 150)),
                         n_edges=_pad512(1024 * 10 + 1024 * 150),
                         d_feat=602, n_graphs=1, kind="train"),
    "ogb_products": dict(n_nodes=_pad512(2449029), n_edges=_pad512(61859140),
                         d_feat=100, n_graphs=1, kind="train"),
    "molecule": dict(n_nodes=_pad512(30 * 128), n_edges=_pad512(64 * 128 * 2),
                     d_feat=0, n_graphs=128, kind="train"),
}


def trainable(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter by name, with ``requires_grad`` turned on."""
    leaves = dict(params.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    return leaves


def value_and_grad(loss_fn: Callable[[], torch.Tensor],
                   leaves: Dict[str, torch.Tensor]):
    """``(loss, {name: gradient})`` of ``loss_fn()`` in ``leaves``."""
    loss = loss_fn()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def lm_train_step(cfg: LMConfig, batch: int, seq: int,
                  microbatches: int = 1,
                  opt_cfg: AdamWConfig = AdamWConfig(), device=None,
                  forward: Callable = train_forward):
    """The step of ``lm_train_cell`` for batches of ``[batch, seq]``
    tokens (the train_4k cell, ``base.py:258-259``, is 256 x 4,096 in 8
    microbatches), through ``forward(cfg, params, batch, device=)``:
    ``transformer.train_forward`` or ``moe.moe_train_forward``.  With
    ``microbatches > 1`` the batch is split into that many row blocks
    (``reshape(microbatches, batch // microbatches, seq)``);
    their gradients are summed in f32 accumulators, and loss and
    gradients divided by ``microbatches``, as the reference's scan."""
    device = resolve_device(device)
    if batch % microbatches:
        raise ValueError(f"lm_train_step: batch {batch} is not a multiple "
                         f"of {microbatches} microbatches")

    def step(params, opt_state, batch_in):
        leaves = trainable(params)
        if microbatches == 1:
            loss, grads = value_and_grad(
                lambda: forward(cfg, params, batch_in, device=device),
                leaves)
        else:
            mb = {k: torch.as_tensor(v).reshape(
                microbatches, batch // microbatches, seq)
                for k, v in batch_in.items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in leaves.items()}
            for i in range(microbatches):
                part = {k: v[i] for k, v in mb.items()}
                l, g = value_and_grad(
                    lambda: forward(cfg, params, part, device=device),
                    leaves)
                loss = loss + l
                for n, gg in g.items():
                    grads[n].add_(gg)
                del g
            loss = loss / microbatches
            for a in grads.values():
                a.div_(microbatches)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def loss_train_step(cfg, loss_fn: Callable,
                    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
                    device=None):
    """One ``loss_fn(cfg, params, batch, device=)`` and its gradients,
    then AdamW: the GNN step of ``make_gnn_arch`` and DLRM's, both at
    lr 1e-3."""
    device = resolve_device(device)

    def step(params, opt_state, batch_in):
        leaves = trainable(params)
        loss, grads = value_and_grad(
            lambda: loss_fn(cfg, params, batch_in, device=device), leaves)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def dlrm_train_step(cfg: DLRMConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
                    device=None):
    """DLRM's ``train_step``: BCE through the plain embedding bag (K3
    has no backward), dense AdamW over every table at lr 1e-3."""
    return loss_train_step(cfg, functools.partial(dlrm_loss, impl="plain"),
                           opt_cfg, device)
