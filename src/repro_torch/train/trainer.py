"""The fault-tolerant training loop (counterpart of
``repro.train.trainer``).

It wires together a step function, AdamW's state, the prefetching data
pipeline, asynchronous checkpoints, the preemption guard, bounded step
retry and the straggler tracker.  Where the reference jits the step and
donates its inputs, the port runs the step eagerly and the step updates
the parameters and the optimizer state in place; where the reference
blocks on the step's metrics, the step's clock here ends in
``torch.cuda.synchronize`` when the parameters are on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.data.pipeline import ShardedPipeline
from repro_torch.optim.adamw import adamw_init, named_leaves
from repro_torch.train.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.train.fault_tolerance import (PreemptionGuard,
                                               StragglerPolicy,
                                               run_step_with_retry)

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    resume: bool = True
    max_step_retries: int = 3


def _devices(params: Any) -> set:
    return {t.device for t in named_leaves(params).values()
            if t.device.type == "cuda"}


def train_loop(step_fn: Callable, params: Any,
               make_batch: Callable[[int], Any], cfg: TrainLoopConfig,
               opt_state: Any = None,
               log_fn: Optional[Callable[[dict], None]] = None
               ) -> tuple[Any, Any, list]:
    """Run ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for the steps from the first one not yet checkpointed (with
    ``resume``) up to ``total_steps``.  Returns ``(params, opt_state,
    history)``: one row per step with ``step``, ``seconds``, every
    metric as a float and ``straggler``.  ``log_fn`` sees every
    ``log_every``-th row.  A checkpoint of ``(params, opt_state)`` is
    written after every ``checkpoint_every``-th step and when the guard
    sees SIGTERM, after which the loop stops."""
    opt_state = opt_state if opt_state is not None else adamw_init(params)
    start_step = 0
    ckpt = (AsyncCheckpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir
            else None)
    if ckpt and cfg.resume:
        try:
            (params, opt_state), start_step, _ = restore_checkpoint(
                cfg.checkpoint_dir, (params, opt_state))
            start_step += 1
        except FileNotFoundError:
            pass

    cards = _devices(params)
    guard = PreemptionGuard()
    straggler = StragglerPolicy()
    pipeline = ShardedPipeline(make_batch, start_step=start_step)
    history = []
    try:
        for step, batch in pipeline:
            if step >= cfg.total_steps:
                break
            t0 = time.perf_counter()
            params, opt_state, metrics = run_step_with_retry(
                step_fn, params, opt_state, batch,
                max_retries=cfg.max_step_retries)
            for device in cards:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            verdict = straggler.observe(dt)
            row = {"step": step, "seconds": dt,
                   **{k: float(v) for k, v in metrics.items()},
                   "straggler": verdict["slow"]}
            history.append(row)
            if log_fn and step % cfg.log_every == 0:
                log_fn(row)
            if ckpt and (step + 1) % cfg.checkpoint_every == 0:
                ckpt.save(step, (params, opt_state))
            if guard.preempted:
                if ckpt:
                    ckpt.save(step, (params, opt_state))
                break
    finally:
        pipeline.close()
        if ckpt:
            ckpt.wait()
        guard.restore()
    return params, opt_state, history
