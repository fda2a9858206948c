"""Fault-tolerance machinery of the train loop (counterpart of
``repro.train.fault_tolerance``).

- :class:`PreemptionGuard`: SIGTERM (or SIGINT) -> "checkpoint now, exit
  clean".
- :func:`run_step_with_retry`: bounded retry around a train step for
  transient failures; the last error always raises again.
- :class:`StragglerPolicy`: a step-time tracker that flags outlier steps
  and recommends re-dispatch when steps stay slow.
- :class:`ElasticMesh`: the largest usable ``(data, model)`` mesh over
  the live ranks, and the state resharded onto it.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Any, Callable, Mapping, Optional

__all__ = ["PreemptionGuard", "run_step_with_retry", "StragglerPolicy",
           "ElasticMesh"]


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a flag the train loop polls each step."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._previous = {}
        for s in signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def restore(self):
        for s, h in self._previous.items():
            signal.signal(s, h)


def run_step_with_retry(step_fn: Callable[..., Any], *args,
                        max_retries: int = 3, backoff_s: float = 0.5,
                        on_retry: Optional[Callable[[int, Exception], None]]
                        = None, **kwargs):
    """Call ``step_fn`` again after a ``RuntimeError`` (PyTorch raises its
    CUDA and allocator failures as ``RuntimeError`` subclasses, where the
    reference catches ``JaxRuntimeError``), at most ``max_retries`` times
    with exponential backoff; the last error raises again.  Program
    errors raise ``RuntimeError`` too, hence the bound;
    ``NotImplementedError`` (a path the port does not have) raises at
    once.

    A retry is only sound if ``step_fn`` writes nothing before its last
    point of failure: the port's steps update parameters in place, and
    ``adamw_update`` computes and allocates everything that can fail
    before its first write, and raises an error that is not retried
    (``PartialUpdateError``) if a write fails."""
    attempt = 0
    while True:
        try:
            return step_fn(*args, **kwargs)
        except RuntimeError as exc:
            if isinstance(exc, NotImplementedError):
                raise
            attempt += 1
            if attempt > max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(backoff_s * (2 ** (attempt - 1)))


class ElasticMesh:
    """Rebuilds the largest usable (data, model) mesh from live ranks
    (``fault_tolerance.py:73-105``).

    Keeps the model axis fixed (the TP degree is baked into the weight
    shapes) and shrinks the data axis to the largest multiple that fits:
    lose a pod, halve DP, reshard, continue."""

    def __init__(self, model_parallel: int):
        self.model_parallel = model_parallel

    def build(self, ranks=None):
        """A ``DeviceMesh`` over the first ``dp * model_parallel`` of
        ``ranks`` (default: every rank of the initialised group), on the
        card under an NCCL group and on the CPU under any other."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.launch.mesh import mesh_device_type
        if ranks is None:
            ranks = list(range(dist.get_world_size()))
        mp = self.model_parallel
        dp = max(1, len(ranks) // mp)
        grid = torch.tensor(list(ranks)[:dp * mp]).reshape(dp, mp)
        return DeviceMesh(mesh_device_type(), grid,
                          mesh_dim_names=("data", "model"))

    def reshard(self, state, mesh, spec_tree):
        """``state`` (a module, or a mapping of tensors, nested mappings
        allowed) placed on ``mesh`` by ``spec_tree`` (the matching
        mapping of ``configs.base.P``; ``None`` replicates everything).
        A DTensor already on ``mesh`` is redistributed; one on another
        mesh, or a plain tensor, is placed from its whole value, which
        every rank holds (so no data moves: each rank keeps its own
        shard)."""
        from torch import nn

        from repro_torch.configs.base import (distribute_params,
                                              to_placements)
        if isinstance(state, nn.Module):
            return distribute_params(state, mesh, spec_tree)
        if isinstance(state, Mapping):
            return {k: self.reshard(v, mesh, None if spec_tree is None
                                    else spec_tree[k])
                    for k, v in state.items()}
        return _place(state, mesh, to_placements(spec_tree, mesh))


def _place(t, mesh, placements):
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        if t.device_mesh == mesh:
            return t.redistribute(mesh, placements)
        t = t.full_tensor()
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


class StragglerPolicy:
    """Flags steps slower than ``threshold`` x the rolling median; after
    ``patience`` consecutive flags, recommends re-dispatch."""

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 patience: int = 3):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self._times: list[float] = []
        self._consecutive = 0

    def observe(self, step_seconds: float) -> dict:
        self._times.append(step_seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = statistics.median(self._times)
        slow = len(self._times) >= 8 and step_seconds > self.threshold * med
        self._consecutive = self._consecutive + 1 if slow else 0
        return {
            "median_s": med,
            "slow": slow,
            "redispatch": self._consecutive >= self.patience,
        }
