"""Model configurations, one module per architecture of the reference:
DLRM-MLPerf, the dense LMs (starcoder2-7b, command-r-35b,
command-r-plus-104b), the MoE LMs (qwen3-moe-235b-a22b, grok-1-314b)
and the GNNs (PNA, MeshGraphNet, SchNet, EquiformerV2).  Each module
builds its arch with ``arch(axes=None)``; ``registry.get_arch`` looks
one up by name."""
from repro_torch.configs.registry import ARCH_NAMES, get_arch

__all__ = ["ARCH_NAMES", "get_arch"]
