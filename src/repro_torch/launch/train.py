"""Training launcher (counterpart of ``repro.launch.train``): ``--arch``
picks an architecture of the registry and trains its REDUCED config on
synthetic data through the whole substrate (checkpoints, preemption,
retry, straggler tracking).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
        --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
        --steps 20 --device cpu

The port trains the families it has modules for, the dense LMs
(``train_forward``) and DLRM (``dlrm_loss``); a MoE or a GNN raises the
registry's ``NotImplementedError``.  Parameters are drawn on the device
from ``torch.Generator`` seed 0; batches are ``data.synthetic``'s of the
step, as in the reference.  It prints the reference's lines: the loss
of every tenth step with its milliseconds, then ``done: loss first ->
last``.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, List, Optional

import torch

from repro_torch.configs.base import dlrm_train_step, lm_train_step
from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.data.synthetic import dlrm_batch, lm_batch
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainLoopConfig, train_loop

__all__ = ["main", "train"]


def _step_fn(arch, cfg, batch: int, seq: int, lr: float, device):
    opt_cfg = AdamWConfig(lr=lr)
    if arch.family == "lm":
        return lm_train_step(cfg, batch, seq, opt_cfg=opt_cfg, device=device)
    return dlrm_train_step(cfg, opt_cfg=opt_cfg, device=device)


def _make_batch_fn(arch, cfg, batch: int, seq: int,
                   device) -> Callable[[int], dict]:
    if arch.family == "lm":
        def arrays(s):
            return lm_batch(s, batch, seq, cfg.vocab)
    else:
        def arrays(s):
            return dlrm_batch(s, batch, cfg.vocab_sizes, cfg.multi_hot)
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
    arch = get_arch(arch_name)  # the MoEs and GNNs raise: not ported yet
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
