"""pna [arXiv:2004.05718]: 4 layers, hidden 75, aggregators
mean/max/min/std, scalers id/amplification/attenuation.  Counterpart of
``repro.configs.pna``: ``builder(dims)`` is its per-shape ``_builder``."""
from repro_torch.configs.base import make_gnn_arch
from repro_torch.models.gnn.pna import PNAConfig, init_pna, pna_loss

KIND = "pna"
INIT, LOSS = init_pna, pna_loss


def builder(dims) -> PNAConfig:
    n_cls = 47 if dims["n_nodes"] > 1_000_000 else \
        (7 if dims["d_feat"] == 1433 else 16)
    return PNAConfig(n_layers=4, d_hidden=75, d_in=max(dims["d_feat"], 16),
                     n_classes=n_cls)


REDUCED = PNAConfig(n_layers=2, d_hidden=25, d_in=16, n_classes=5)


def arch(axes=None):  # axes unused: the parameters are replicated
    return make_gnn_arch("pna", KIND, builder, INIT, LOSS, REDUCED)
