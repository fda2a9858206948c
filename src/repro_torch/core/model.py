"""Workload-driven specialization model (paper Sec. IV, Fig. 4).

Counterpart of ``repro.core.model``, decision for decision.
``specialize(props, profile)`` is the tree over the full design space;
``specialize_partial`` the restricted tree of Sec. IV-B (no DRFrlx).
Together they reproduce Table V 36/36 from the published classes.

Full model:
  1. dynamic traversal             -> push+pull, DeNovo, DRF1 ("DD1")
  2. AC == source or AI == source  -> push (unconditional, Sec. IV-A1)
  3. else pull is *disqualified* when reuse in {M,L} or imbalance in {M,H}
     or volume == H                -> push; otherwise pull + GPU + DRF0
  4. push coherence: GPU if reuse in {M,L} or volume == H, else DeNovo
  5. push consistency: DRFrlx if imbalance == H or volume in {H,M}, else DRF1

Partial model (no DRFrlx; Sec. IV-B):
  - AC == source -> push.
  - AI == source -> push iff reuse in {M,L} or volume in {M,H}.
  - neither      -> push iff reuse in {M,L} or volume == H.
  Imbalance is dropped; push pairs with the full model's coherence rule
  and DRF1; pull -> TG0.
"""
from __future__ import annotations

from repro_torch.core.config_space import (Coherence, Consistency,
                                           SystemConfig, UpdateProp)
from repro_torch.core.properties import AlgorithmicProperties, Locus, \
    Traversal
from repro_torch.core.taxonomy import GraphProfile

__all__ = ["specialize", "specialize_partial"]


def _push_coherence(profile: GraphProfile) -> Coherence:
    if profile.reuse_class in ("M", "L") or profile.volume_class == "H":
        return Coherence.GPU
    return Coherence.DENOVO


def _push_consistency(profile: GraphProfile) -> Consistency:
    if profile.imbalance_class == "H" or profile.volume_class in ("H", "M"):
        return Consistency.DRFRLX
    return Consistency.DRF1


_PULL = SystemConfig(UpdateProp.PULL, Coherence.GPU, Consistency.DRF0)
_DYNAMIC = SystemConfig(UpdateProp.PUSH_PULL, Coherence.DENOVO,
                        Consistency.DRF1)


def specialize(props: AlgorithmicProperties,
               profile: GraphProfile) -> SystemConfig:
    """Full-design-space decision tree (Fig. 4)."""
    if props.traversal is Traversal.DYNAMIC:
        return _DYNAMIC
    prefers_source = (props.control is Locus.SOURCE
                      or props.information is Locus.SOURCE)
    pull_disqualified = (profile.reuse_class in ("M", "L")
                         or profile.imbalance_class in ("M", "H")
                         or profile.volume_class == "H")
    if not prefers_source and not pull_disqualified:
        return _PULL
    return SystemConfig(UpdateProp.PUSH, _push_coherence(profile),
                        _push_consistency(profile))


def specialize_partial(props: AlgorithmicProperties,
                       profile: GraphProfile) -> SystemConfig:
    """Restricted model when the system lacks DRFrlx (Sec. IV-B)."""
    if props.traversal is Traversal.DYNAMIC:
        return _DYNAMIC
    if props.control is Locus.SOURCE:
        push = True
    elif props.information is Locus.SOURCE:
        push = (profile.reuse_class in ("M", "L")
                or profile.volume_class in ("M", "H"))
    else:
        push = (profile.reuse_class in ("M", "L")
                or profile.volume_class == "H")
    if not push:
        return _PULL
    return SystemConfig(UpdateProp.PUSH, _push_coherence(profile),
                        Consistency.DRF1)
