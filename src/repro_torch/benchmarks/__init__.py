"""Benchmarks of the port (counterparts of the reference's ``benchmarks/``).

The tracked records live under ``results/torch/`` (:data:`RESULTS`),
where the perf gate (:mod:`repro_torch.benchmarks.compare`) reads them.
A smoke run of the batch and resilience harnesses writes under
:data:`SMOKE_DIR` instead, which git ignores: the reference's smoke runs
overwrite their pinned artifact, and a smoke record where the gate reads
would fail its fingerprint.
"""
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch"
SMOKE_DIR = RESULTS / "smoke"


def smoke_out(out_path, tracked: Path):
    """Where a smoke run writes the record whose tracked file is
    ``tracked``: the same name under :data:`SMOKE_DIR` when ``out_path``
    is the tracked file, else ``out_path`` (None: nowhere).  Never the
    tracked file itself."""
    if out_path is None:
        return None
    path = Path(out_path)
    if path.resolve() == tracked.resolve():
        path = SMOKE_DIR / tracked.name
    return path
