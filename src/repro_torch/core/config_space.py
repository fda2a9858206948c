"""The paper's 3-axis system design space (Table I), as executable config.

Counterpart of ``repro.core.config_space``.  Names follow the paper's
Fig. 5 labels, ``<dir><coh><cons>``: direction T = pull, S = push,
D = dynamic; coherence G = GPU (LLC-resolved accumulation), D = DeNovo
(owned, block-local accumulation); consistency 0 = DRF0, 1 = DRF1,
R = DRFrlx.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools

__all__ = ["UpdateProp", "Coherence", "Consistency", "SystemConfig",
           "ALL_CONFIGS", "STATIC_CONFIGS", "DYNAMIC_CONFIGS"]


class UpdateProp(enum.Enum):
    PULL = "T"        # target in outer loop; sparse remote reads
    PUSH = "S"        # source in outer loop; sparse remote updates
    PUSH_PULL = "D"   # dynamic traversal; racy reads and updates


class Coherence(enum.Enum):
    #: GPU coherence: atomics at the LLC; one global scatter here.
    GPU = "G"
    #: DeNovo: ownership at L1, local atomics; block-owned accumulation
    #: in shared memory here.
    DENOVO = "D"


class Consistency(enum.Enum):
    #: SC for DRF; every phase fully barriered.
    DRF0 = "0"
    #: unpaired sync may overlap data: ordered chunk pipeline.
    DRF1 = "1"
    #: relaxed atomics reorder w.r.t. each other: independent partials.
    DRFRLX = "R"


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    prop: UpdateProp
    coherence: Coherence
    consistency: Consistency
    #: edge chunks used by the DRF1/DRFrlx schedules (1 => DRF0-equivalent).
    n_chunks: int = 8

    @property
    def name(self) -> str:
        return f"{self.prop.value}{self.coherence.value}{self.consistency.value}"

    @classmethod
    def from_name(cls, name: str, n_chunks: int = 8) -> "SystemConfig":
        prop = {u.value: u for u in UpdateProp}[name[0]]
        coh = {c.value: c for c in Coherence}[name[1]]
        cons = {c.value: c for c in Consistency}[name[2]]
        return cls(prop, coh, cons, n_chunks=n_chunks)

    def __str__(self) -> str:
        return self.name


def _configs(props):
    return tuple(
        SystemConfig(p, c, m)
        for p, c, m in itertools.product(props, Coherence, Consistency)
    )


#: All 18 addressable configurations (3 directions x 2 x 3).
ALL_CONFIGS = _configs(UpdateProp)
#: The 12 static-direction configs.
STATIC_CONFIGS = _configs([UpdateProp.PULL, UpdateProp.PUSH])
#: The 6 dynamic (push/pull switching) configs.
DYNAMIC_CONFIGS = _configs([UpdateProp.PUSH_PULL])
