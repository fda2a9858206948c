"""Synthetic data sources, made from numpy seeds."""
from repro_torch.data.synthetic import dlrm_batch, lm_batch

__all__ = ["lm_batch", "dlrm_batch"]
