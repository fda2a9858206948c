"""Train a PNA node classifier end to end on the PyTorch/CUDA port with
the whole substrate: AdamW, checkpoints, the preemption guard, straggler
tracking; a few hundred steps (the counterpart of
``examples/train_gnn.py``).

    PYTHONPATH=src python examples/train_gnn_torch.py --steps 200 \\
        [--device cpu] [--config SDR]
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import loss_train_step  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.config_space import SystemConfig  # noqa: E402
from repro_torch.data.synthetic import gnn_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.graph import powerlaw_graph  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import TrainLoopConfig, train_loop  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh "
                         "temporary one)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--config", default=None,
                    help="aggregate's SystemConfig, e.g. SG0 or SDR "
                         "(default: the model's, SGR)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_gnn_ckpt_")

    arch = get_arch("pna")
    cfg = arch.reduced_cfg
    if args.config:
        cfg = dataclasses.replace(cfg,
                                  sys=SystemConfig.from_name(args.config))
    graph = powerlaw_graph(512, 4000, alpha=1.0, seed=0, block_size=64)
    params = arch.init_params(cfg, torch.Generator(device).manual_seed(0),
                              device)
    step = loss_train_step(cfg, arch.loss, AdamWConfig(lr=3e-3), device)

    # fixed labels: the model must actually fit something
    fixed = {k: torch.from_numpy(v).to(device) for k, v in
             gnn_batch(0, graph, cfg.d_in, cfg.n_classes).items()}

    loop_cfg = TrainLoopConfig(total_steps=args.steps, checkpoint_every=50,
                               log_every=20, checkpoint_dir=ckpt)
    _, _, history = train_loop(
        step, params, lambda s: fixed, loop_cfg,
        log_fn=lambda r: print(f"step {r['step']:>4} "
                               f"loss {r['loss']:.4f} "
                               f"({r['seconds'] * 1e3:.0f} ms)"))
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.4f} -> {last:.4f} over {len(history)} steps "
          f"under {cfg.sys.name} on {device} (checkpoints in {ckpt})")
    assert last < first
    return history


if __name__ == "__main__":
    main()
