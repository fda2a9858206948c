"""K2 (``seg_minmax``, ``seg_reduce_kernel<MinMax<..>>``) against its
bytes bound, as ``k1_roofline``, in %.  Every K2 launch of these cells
reduces a whole edge order: the pull order or the owned push order."""
from perfbench.roofline import seg_reduce_roofline


def read(rec):
    return seg_reduce_roofline(rec, "seg_reduce_kernel", "MinMax")
