"""equiformer-v2 [arXiv:2306.12059]: 12 layers, hidden 128, l_max=6,
m_max=2, 8 heads, SO(2)/eSCN convolutions.  Counterpart of
``repro.configs.equiformer_v2``: ``builder(dims)`` is its per-shape
``_builder``."""
from repro_torch.configs.base import make_gnn_arch
from repro_torch.models.gnn.equiformer_v2 import (EquiformerV2Config,
                                                  equiformer_loss,
                                                  init_equiformer)

KIND = "equiformer"
INIT, LOSS = init_equiformer, equiformer_loss


def builder(dims) -> EquiformerV2Config:
    return EquiformerV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                              n_heads=8, n_graphs=dims["n_graphs"])


REDUCED = EquiformerV2Config(n_layers=2, d_hidden=16, l_max=3, m_max=2,
                             n_heads=4, n_rbf=16, n_graphs=4)


def arch(axes=None):  # axes unused: the parameters are replicated
    return make_gnn_arch("equiformer-v2", KIND, builder, INIT, LOSS, REDUCED)
