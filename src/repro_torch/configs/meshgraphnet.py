"""meshgraphnet [arXiv:2010.03409]: 15 message-passing layers, hidden
128, sum aggregation, 2-layer MLPs.  Counterpart of
``repro.configs.meshgraphnet``: ``builder(dims)`` is its per-shape
``_builder``."""
from repro_torch.configs.base import make_gnn_arch
from repro_torch.models.gnn.meshgraphnet import MGNConfig, init_mgn, mgn_loss

KIND = "mgn"
INIT, LOSS = init_mgn, mgn_loss


def builder(dims) -> MGNConfig:
    return MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2,
                     d_node_in=max(dims["d_feat"], 12), d_edge_in=4, d_out=3)


REDUCED = MGNConfig(n_layers=2, d_hidden=32, mlp_layers=2, d_node_in=12,
                    d_edge_in=4, d_out=3)


def arch(axes=None):  # axes unused: the parameters are replicated
    return make_gnn_arch("meshgraphnet", KIND, builder, INIT, LOSS, REDUCED)
