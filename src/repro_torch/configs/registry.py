"""--arch lookup (counterpart of ``repro.configs.registry``): the same
ten names, each with its full config, its reduced one, its family, its
initialiser and its training loss.  A GNN's full config depends on the
input shape: ``Arch.cfg`` is the reference's ``cfg0`` (the molecule
shape for SchNet and EquiformerV2, ``full_graph_sm`` for the others),
and ``Arch.cfg_for(shape)`` gives any of ``GNN_SHAPES``' configs, as
``make_gnn_arch``'s cells do.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from functools import lru_cache
from typing import Any, Callable, Optional

__all__ = ["ARCH_NAMES", "Arch", "get_arch"]

#: name -> (family, the port's config module)
_MODULES = {
    "command-r-plus-104b": ("lm", "repro_torch.configs.command_r_plus_104b"),
    "command-r-35b": ("lm", "repro_torch.configs.command_r_35b"),
    "starcoder2-7b": ("lm", "repro_torch.configs.starcoder2_7b"),
    "qwen3-moe-235b-a22b": ("moe",
                            "repro_torch.configs.qwen3_moe_235b_a22b"),
    "grok-1-314b": ("moe", "repro_torch.configs.grok_1_314b"),
    "meshgraphnet": ("gnn", "repro_torch.configs.meshgraphnet"),
    "schnet": ("gnn", "repro_torch.configs.schnet"),
    "pna": ("gnn", "repro_torch.configs.pna"),
    "equiformer-v2": ("gnn", "repro_torch.configs.equiformer_v2"),
    "dlrm-mlperf": ("recsys", "repro_torch.configs.dlrm_mlperf"),
}

ARCH_NAMES = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str       # lm | moe | gnn | recsys, as the reference's
    cfg: Any
    reduced_cfg: Any
    #: (cfg, generator, device=None) -> parameters
    init_params: Callable[..., Any]
    #: (cfg, params, batch, device=None) -> the training loss (f32
    #: scalar): ``train_forward``, ``moe_train_forward``, a GNN's loss,
    #: or ``dlrm_loss`` through the plain embedding bag
    loss: Callable[..., Any]
    #: GNNs: shape name of ``GNN_SHAPES`` -> that shape's config
    cfg_for: Optional[Callable[[str], Any]] = None


@lru_cache(maxsize=None)
def get_arch(name: str) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    family, module = _MODULES[name]
    mod = importlib.import_module(module)
    if family == "recsys":
        from repro_torch.models.dlrm import dlrm_loss, init_dlrm
        return Arch(name, family, mod.CFG, mod.REDUCED, init_dlrm,
                    functools.partial(dlrm_loss, impl="plain"))
    if family == "lm":
        from repro_torch.models.transformer import init_lm, train_forward
        return Arch(name, family, mod.CFG, mod.REDUCED, init_lm,
                    train_forward)
    if family == "moe":
        from repro_torch.models.moe import init_moe_lm, moe_train_forward
        return Arch(name, family, mod.CFG, mod.REDUCED, init_moe_lm,
                    moe_train_forward)
    from repro_torch.configs.base import GNN_SHAPES
    first = "molecule" if mod.KIND in ("schnet", "equiformer") \
        else "full_graph_sm"
    return Arch(name, family, mod.builder(GNN_SHAPES[first]), mod.REDUCED,
                mod.INIT, mod.LOSS,
                cfg_for=lambda shape: mod.builder(GNN_SHAPES[shape]))
