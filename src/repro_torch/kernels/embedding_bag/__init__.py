from repro_torch.kernels.embedding_bag.kernel import (MAX_TABLES, SOURCE,
                                                     embag, embag_tables)
from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                  embedding_bags)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                  embedding_bags_ref)

__all__ = ["MAX_TABLES", "SOURCE", "embag", "embag_tables", "embedding_bag",
           "embedding_bags", "embedding_bag_ref", "embedding_bags_ref"]
