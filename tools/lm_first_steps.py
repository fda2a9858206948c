#!/usr/bin/env python3
"""Both packages' first train steps of starcoder2-7b at full width, on
the CPU: the loss of ``lm_train_cell``'s step (AdamW at lr 3e-4, no
warm-up) on one repeated batch, reference against port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_first_steps.py

Full width (d_model 4,608, d_ff 18,432, 36 heads) with the depth cut to
``--layers`` and the vocabulary to ``--vocab`` so that it fits a host
(~6 GB at the defaults).  It shows whether a rise of the loss after the
first step is the optimizer's (both packages) or the port's.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import lm_train_cell
from repro.configs.starcoder2_7b import CFG as J_CFG
from repro.data.synthetic import lm_batch
from repro.models import transformer as JT
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch.configs.base import lm_train_step
from repro_torch.configs.starcoder2_7b import CFG
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    over = dict(n_layers=args.layers, vocab=args.vocab)
    jcfg = dataclasses.replace(J_CFG, **over)
    cfg = dataclasses.replace(CFG, **over)
    jp = JT.init_lm(jax.random.key(0), jcfg)
    port = T.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    jstep = jax.jit(lm_train_cell(jcfg, "t", 2, 128, JT.train_forward,
                                  microbatches=2).step)
    step = lm_train_step(cfg, 2, 128, microbatches=2, device="cpu")
    jo, opt = j_adamw_init(jp), adamw_init(port)
    batch = lm_batch(0, 2, 128, cfg.vocab)
    print(f"starcoder2-7b width, {args.layers} layer(s), vocab "
          f"{args.vocab}: loss per step, reference then port")
    for s in range(args.steps):
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, batch))
        port, opt, m = step(port, opt, batch)
        print(f"step {s}: {float(jm['loss']):.6f} {float(m['loss']):.6f}")


if __name__ == "__main__":
    main()
