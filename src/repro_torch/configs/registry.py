"""--arch lookup (counterpart of ``repro.configs.registry``): the same
names, each with its full config, its reduced one and its family.

Only the archs the port has modules for resolve: the three dense LMs and
DLRM-MLPerf.  The MoE LMs and the GNNs raise ``NotImplementedError``
until their slices land.
"""
from __future__ import annotations

import dataclasses
import importlib
from functools import lru_cache
from typing import Any, Callable

__all__ = ["ARCH_NAMES", "Arch", "get_arch"]

#: name -> (family, the port's module, or None before it is ported)
_MODULES = {
    "command-r-plus-104b": ("lm", "repro_torch.configs.command_r_plus_104b"),
    "command-r-35b": ("lm", "repro_torch.configs.command_r_35b"),
    "starcoder2-7b": ("lm", "repro_torch.configs.starcoder2_7b"),
    "qwen3-moe-235b-a22b": ("moe", None),
    "grok-1-314b": ("moe", None),
    "meshgraphnet": ("gnn", None),
    "schnet": ("gnn", None),
    "pna": ("gnn", None),
    "equiformer-v2": ("gnn", None),
    "dlrm-mlperf": ("recsys", "repro_torch.configs.dlrm_mlperf"),
}

ARCH_NAMES = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str       # lm | moe | gnn | recsys, as the reference's
    cfg: Any
    reduced_cfg: Any
    #: (cfg, generator, device=None) -> parameters: ``init_lm`` or
    #: ``init_dlrm``
    init_params: Callable[..., Any]


@lru_cache(maxsize=None)
def get_arch(name: str) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    family, module = _MODULES[name]
    if module is None:
        raise NotImplementedError(
            f"{name}: the {family} family is not ported to repro_torch yet "
            f"(ROADMAP.md, queue 1)")
    mod = importlib.import_module(module)
    if family == "recsys":
        from repro_torch.models.dlrm import init_dlrm as init
    else:
        from repro_torch.models.transformer import init_lm as init
    return Arch(name, family, mod.CFG, mod.REDUCED, init)
