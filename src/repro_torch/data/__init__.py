"""Synthetic data sources, made from numpy seeds, and the prefetching
pipeline that feeds a train loop."""
from repro_torch.data.pipeline import ShardedPipeline
from repro_torch.data.synthetic import dlrm_batch, lm_batch

__all__ = ["lm_batch", "dlrm_batch", "ShardedPipeline"]
