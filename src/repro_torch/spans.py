"""Host spans of the port's phases, on the profiler's clock.

No counterpart in the reference (like :mod:`repro_torch.device`): a
``jax.profiler`` trace names its own compiled programs.  One helper
serves every span of the port:

- :class:`span` opens ``torch.profiler.record_function(name)`` only
  while a torch profiler runs, so the range lands in the profiler's
  Chrome trace on the same clock as the card's kernels, copies and
  fills.  With no profiler running it costs one flag check.
- :class:`phase` opens the same range, named ``repro_torch.<name>``,
  and also adds the block's host seconds (``time.perf_counter``) to
  ``phases[name]``, profiler or not.

There is no switch: tracing is on while a profiler runs.  ``run()``
opens ``repro_torch.run`` and its phases (``RunResult.phases``);
:mod:`repro_torch.models.moe` opens its stages.
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict

import torch
import torch.autograd.profiler as _profiler

__all__ = ["PREFIX", "span", "phase"]

#: The prefix of every :class:`phase`'s profiler range.
PREFIX = "repro_torch."


def _open(name: str) -> torch.profiler.record_function:
    """The profiler range ``name``, entered."""
    rng = torch.profiler.record_function(name)
    rng.__enter__()
    return rng


class span:
    """``with span(name):`` a profiler range named ``name`` over the
    block, opened only while a torch profiler runs."""
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        # the module's flag, read each time: profilers set and clear it
        self._range = (_open(self.name)
                       if _profiler._is_profiler_enabled else None)

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)


class phase:
    """``with phase(phases, name):`` adds the block's host seconds to
    ``phases[name]`` and, while a profiler runs, opens the range
    ``repro_torch.<name>`` over it, as :class:`span` does.  (Not a
    subclass of :class:`span`: the calls up to it would double the
    cost with no profiler running.)"""
    __slots__ = ("phases", "key", "_range", "_t0")

    def __init__(self, phases: Dict[str, float], name: str):
        self.phases = phases
        self.key = name

    def __enter__(self) -> None:
        self._range = (_open(PREFIX + self.key)
                       if _profiler._is_profiler_enabled else None)
        self._t0 = perf_counter()

    def __exit__(self, *exc) -> None:
        dt = perf_counter() - self._t0
        phases = self.phases
        phases[self.key] = phases.get(self.key, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(*exc)
