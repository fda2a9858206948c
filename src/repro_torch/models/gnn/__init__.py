"""The GNN family (counterpart of ``repro.models.gnn``): ``aggregate``
and ``segment_softmax`` over the paper's coherence x consistency
configs, and PNA, MeshGraphNet, SchNet and EquiformerV2 on them."""
from repro_torch.models.gnn.common import (DEFAULT_GNN_CONFIG, MLPStack,
                                           aggregate, init_mlp_stack,
                                           mlp_stack, segment_softmax)
from repro_torch.models.gnn.equiformer_v2 import (EquiformerV2Config,
                                                  equiformer_forward,
                                                  equiformer_loss,
                                                  init_equiformer)
from repro_torch.models.gnn.meshgraphnet import (MGNConfig, init_mgn,
                                                 mgn_forward, mgn_loss)
from repro_torch.models.gnn.pna import (PNAConfig, init_pna, pna_forward,
                                        pna_loss)
from repro_torch.models.gnn.schnet import (SchNetConfig, init_schnet,
                                           schnet_forward, schnet_loss)

__all__ = ["aggregate", "segment_softmax", "DEFAULT_GNN_CONFIG",
           "MLPStack", "init_mlp_stack", "mlp_stack",
           "EquiformerV2Config", "equiformer_forward", "equiformer_loss",
           "init_equiformer", "MGNConfig", "init_mgn", "mgn_forward",
           "mgn_loss", "PNAConfig", "init_pna", "pna_forward", "pna_loss",
           "SchNetConfig", "init_schnet", "schnet_forward", "schnet_loss"]
