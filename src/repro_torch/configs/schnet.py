"""schnet [arXiv:1706.08566]: 3 interactions, hidden 64, 300 RBFs,
cutoff 10 Å.  Counterpart of ``repro.configs.schnet``:
``builder(dims)`` is its per-shape ``_builder``."""
from repro_torch.configs.base import make_gnn_arch
from repro_torch.models.gnn.schnet import (SchNetConfig, init_schnet,
                                           schnet_loss)

KIND = "schnet"
INIT, LOSS = init_schnet, schnet_loss


def builder(dims) -> SchNetConfig:
    return SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300,
                        cutoff=10.0, n_graphs=dims["n_graphs"])


REDUCED = SchNetConfig(n_interactions=2, d_hidden=32, n_rbf=50, n_graphs=4)


def arch(axes=None):  # axes unused: the parameters are replicated
    return make_gnn_arch("schnet", KIND, builder, INIT, LOSS, REDUCED)
