"""Synthetic data sources, made from numpy seeds."""
from repro_torch.data.synthetic import dlrm_batch

__all__ = ["dlrm_batch"]
