"""Host data pipeline: deterministic iteration with prefetch
(counterpart of ``repro.data.pipeline``).

Generation is a pure function of the step, so a restart from
``start_step`` replays exactly, and a background thread keeps ``depth``
batches ready, overlapping the host's data work with the device's
compute.  ``make_batch`` may return tensors already on the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

__all__ = ["ShardedPipeline"]


class _Failed:
    def __init__(self, exc: Exception):
        self.exc = exc


class ShardedPipeline:
    """Yields ``(step, make_batch(step))`` for step = ``start_step``,
    ``start_step + 1``, ... in order; :meth:`close` stops the thread.
    An exception raised by ``make_batch`` is raised again by the
    ``next`` that would have returned its batch (the reference's thread
    dies and the loop waits forever)."""

    def __init__(self, make_batch: Callable[[int], Any], start_step: int = 0,
                 depth: int = 2):
        self.make_batch = make_batch
        self.depth = depth
        self._step = start_step
        self._q: "queue.Queue[tuple[int, Any]]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.make_batch(step)
            except Exception as exc:  # raised again by __next__
                batch = _Failed(exc)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if isinstance(batch, _Failed):
            raise batch.exc
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
