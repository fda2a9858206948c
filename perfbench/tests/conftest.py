"""Shared fixtures of the benchmark's tests.

The tests import ``perfbench`` from the repository's root and
``repro_torch`` from ``src``; CPU tests run the harness on the CPU at a
small scale, and tests marked ``cuda`` decide inside ``cuda_device``
whether a card is present.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def small_cell(name: str, scale: int = 8):
    """Cell ``name`` of the repository's benchmark at ``scale``."""
    from perfbench import registry
    cell = registry.load().cell(name)
    cell.config = {**cell.config, "scale": scale}
    return cell
