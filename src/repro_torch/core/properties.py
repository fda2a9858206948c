"""Algorithmic properties (paper Sec. III-B, Table III).

Counterpart of ``repro.core.properties``.  Traversal: STATIC or
DYNAMIC.  Control: where predicate work is elided (SOURCE favours push,
TARGET pull).  Information: where property loads hoist.
"""
from __future__ import annotations

import dataclasses
import enum

__all__ = ["Traversal", "Locus", "AlgorithmicProperties", "TABLE_III"]


class Traversal(enum.Enum):
    STATIC = "static"
    DYNAMIC = "dynamic"


class Locus(enum.Enum):
    SOURCE = "source"
    TARGET = "target"
    SYMMETRIC = "symmetric"
    NA = "-"  # dynamic-traversal apps: not used for specialization


@dataclasses.dataclass(frozen=True)
class AlgorithmicProperties:
    traversal: Traversal
    control: Locus
    information: Locus


#: Table III, verbatim, plus BFS (direction-optimizing, so dynamic).
TABLE_III = {
    "PR": AlgorithmicProperties(Traversal.STATIC, Locus.SYMMETRIC, Locus.SOURCE),
    "SSSP": AlgorithmicProperties(Traversal.STATIC, Locus.SOURCE, Locus.SOURCE),
    "MIS": AlgorithmicProperties(Traversal.STATIC, Locus.SYMMETRIC, Locus.SYMMETRIC),
    "CLR": AlgorithmicProperties(Traversal.STATIC, Locus.SYMMETRIC, Locus.TARGET),
    "BC": AlgorithmicProperties(Traversal.STATIC, Locus.SOURCE, Locus.SYMMETRIC),
    "CC": AlgorithmicProperties(Traversal.DYNAMIC, Locus.NA, Locus.NA),
    "BFS": AlgorithmicProperties(Traversal.DYNAMIC, Locus.NA, Locus.NA),
}
