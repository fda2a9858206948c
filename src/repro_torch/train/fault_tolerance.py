"""Fault-tolerance machinery of the train loop (counterpart of
``repro.train.fault_tolerance``).

- :class:`PreemptionGuard`: SIGTERM (or SIGINT) -> "checkpoint now, exit
  clean".
- :func:`run_step_with_retry`: bounded retry around a train step for
  transient failures; the last error always raises again.
- :class:`StragglerPolicy`: a step-time tracker that flags outlier steps
  and recommends re-dispatch when steps stay slow.

``ElasticMesh`` comes with the sharding pieces.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Any, Callable, Optional

__all__ = ["PreemptionGuard", "run_step_with_retry", "StragglerPolicy"]


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
