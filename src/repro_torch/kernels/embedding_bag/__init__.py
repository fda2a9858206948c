from repro_torch.kernels.embedding_bag.kernel import SOURCE, embag
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["SOURCE", "embag", "embedding_bag", "embedding_bag_ref"]
