"""--arch lookup (counterpart of ``repro.configs.registry``): the same
ten names, each with its full config, its reduced one, its family, its
initialiser and its training loss.  A GNN's full config depends on the
input shape: ``Arch.cfg`` is the reference's ``cfg0`` (the molecule
shape for SchNet and EquiformerV2, ``full_graph_sm`` for the others),
and ``Arch.cfg_for(shape)`` gives any of ``GNN_SHAPES``' configs, as
``make_gnn_arch``'s cells do.  Each arch also carries the dry run's
``abstract_params``, ``param_sharding`` and ``cells``
(``configs.base.make_{lm,gnn,dlrm}_arch``).  ``get_arch(name, axes)``
binds a mesh's axes into an LM's config as the reference's does
(``dp_axes``, ``tp_axis``, ``sp_axis``; an MoE's ``moe_mode`` and
``dispatch_groups = axes.dp_size``); without axes the configs are the
unsharded ones.
"""
from __future__ import annotations

import dataclasses
import importlib
from functools import lru_cache

from repro_torch.configs.base import (Arch, Axes, make_dlrm_arch,
                                      make_gnn_arch, make_lm_arch)

__all__ = ["ARCH_NAMES", "Arch", "get_arch", "with_layers"]

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


def with_layers(name: str, n_layers: int, axes: Axes = None) -> Arch:
    """An LM's arch with its depth cut to ``n_layers`` (every width
    kept), as ``get_arch`` would build it."""
    family, module = _MODULES[name]
    if family not in ("lm", "moe"):
        raise ValueError(f"{name}: only an LM's depth can be cut")
    mod = importlib.import_module(module)
    return make_lm_arch(name, dataclasses.replace(mod.CFG, n_layers=n_layers),
                        mod.REDUCED, moe_mode=getattr(mod, "MOE_MODE", None),
                        axes=axes)


@lru_cache(maxsize=None)
def get_arch(name: str, axes: Axes = None) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    family, module = _MODULES[name]
    mod = importlib.import_module(module)
    if family == "recsys":
        return make_dlrm_arch(name, mod.CFG, mod.REDUCED)
    if family in ("lm", "moe"):
        return make_lm_arch(name, mod.CFG, mod.REDUCED,
                            moe_mode=getattr(mod, "MOE_MODE", None),
                            axes=axes)
    return make_gnn_arch(name, mod.KIND, mod.builder, mod.INIT, mod.LOSS,
                         mod.REDUCED)
