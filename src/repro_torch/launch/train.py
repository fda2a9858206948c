"""Training launcher (counterpart of ``repro.launch.train``): ``--arch``
picks an architecture of the registry and trains its REDUCED config on
synthetic data through the whole substrate (checkpoints, preemption,
retry, straggler tracking).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
        --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
        --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch pna \\
        --steps 100 --device cpu

Every family trains: the dense LMs (``train_forward``) and the MoEs
(``moe_train_forward``) through ``lm_train_step``, DLRM (``dlrm_loss``)
and the GNNs (their losses) through ``loss_train_step``.  Parameters
are drawn on the device from ``torch.Generator`` seed 0.  Batches are
the reference's (``train.py:44-85``): ``data.synthetic``'s of the step
for the LMs and DLRM; for the GNNs one graph,
``powerlaw_graph(512, 4000, alpha=1.0, seed=0, block_size=64)``, with
PNA's ``gnn_batch`` of step 0 every step and the other models' node
and edge arrays drawn anew each step from one ``default_rng(0)``.  It
prints the reference's lines: the loss of every tenth step with its
milliseconds, then ``done: loss first -> last``.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import lm_train_step, loss_train_step
from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.data.synthetic import dlrm_batch, gnn_batch, lm_batch
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainLoopConfig, train_loop

__all__ = ["main", "train"]


def _step_fn(arch, cfg, batch: int, seq: int, lr: float, device):
    opt_cfg = AdamWConfig(lr=lr)
    if arch.family in ("lm", "moe"):
        return lm_train_step(cfg, batch, seq, opt_cfg=opt_cfg, device=device,
                             forward=arch.loss)
    return loss_train_step(cfg, arch.loss, opt_cfg=opt_cfg, device=device)


def _gnn_arrays(arch, cfg) -> Callable[[int], dict]:
    """The reference's GNN batches (``train.py:55-85``)."""
    from repro_torch.graph import powerlaw_graph
    g = powerlaw_graph(512, 4000, alpha=1.0, seed=0, block_size=64)
    rng = np.random.default_rng(0)
    n, e = 512, g.n_edges

    def arrays(s):
        if arch.name == "pna":
            return gnn_batch(0, g, cfg.d_in, cfg.n_classes)
        base = {"src": np.asarray(g.src, np.int32),
                "dst": np.asarray(g.dst, np.int32)}
        if arch.name == "meshgraphnet":
            base.update({
                "node_feat": rng.standard_normal(
                    (n, cfg.d_node_in)).astype(np.float32),
                "edge_feat": rng.standard_normal(
                    (e, cfg.d_edge_in)).astype(np.float32),
                "target": np.zeros((n, cfg.d_out), np.float32),
            })
        else:
            gg = cfg.n_graphs
            base.update({
                "species": rng.integers(0, 10, n).astype(np.int32),
                "positions": rng.standard_normal((n, 3)).astype(np.float32),
                "graph_ids": (np.arange(n) % gg).astype(np.int32),
                "energy": np.zeros((gg,), np.float32),
            })
        return base

    return arrays


def _make_batch_fn(arch, cfg, batch: int, seq: int,
                   device) -> Callable[[int], dict]:
    if arch.family in ("lm", "moe"):
        def arrays(s):
            return lm_batch(s, batch, seq, cfg.vocab)
    elif arch.family == "recsys":
        def arrays(s):
            return dlrm_batch(s, batch, cfg.vocab_sizes, cfg.multi_hot)
    else:
        arrays = _gnn_arrays(arch, cfg)
    return lambda s: {k: torch.from_numpy(v).to(device)
                      for k, v in arrays(s).items()}


def _print_row(r: dict) -> None:
    print(f"step {r['step']:>5}  loss {r['loss']:.4f}"
          f"  ({r['seconds'] * 1e3:.0f} ms)", flush=True)


def train(arch_name: str, *, steps: int = 50, batch: int = 4,
          seq: int = 128, lr: float = 1e-3, ckpt: Optional[str] = None,
          device=None, params: Any = None) -> List[dict]:
    """Train ``arch_name``'s REDUCED config for ``steps`` steps, printing
    as :func:`main` does; returns the loop's history.  ``params``
    replaces the seed-0 draw (for example the reference's parameters,
    carried across)."""
    device = resolve_device(device)
    arch = get_arch(arch_name)
    cfg = arch.reduced_cfg
    if params is None:
        params = arch.init_params(cfg, torch.Generator(device).manual_seed(0),
                                  device)
    loop = TrainLoopConfig(total_steps=steps, log_every=10,
                           checkpoint_every=max(steps // 2, 1),
                           checkpoint_dir=ckpt)
    _, _, hist = train_loop(
        _step_fn(arch, cfg, batch, seq, lr, device), params,
        _make_batch_fn(arch, cfg, batch, seq, device), loop,
        log_fn=_print_row)
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    return train(args.arch, steps=args.steps, batch=args.batch,
                 seq=args.seq, lr=args.lr, ckpt=args.ckpt,
                 device=args.device)


if __name__ == "__main__":
    main()
