"""GNN substrate; only the shared MLP stack is ported so far."""
from repro_torch.models.gnn.common import (MLPStack, init_mlp_stack,
                                           mlp_stack)

__all__ = ["MLPStack", "init_mlp_stack", "mlp_stack"]
