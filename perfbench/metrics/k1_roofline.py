"""K1 (``seg_sum``, ``seg_reduce_kernel<SumF32>``) against its bytes
bound: every profiled launch reads a value and a segment id for each of
E edges and writes V rows, at the HBM bandwidth, over K1's profiled
device time, in %.  Every K1 launch of these cells reduces a whole edge
order."""
from perfbench.roofline import seg_reduce_roofline


def read(rec):
    return seg_reduce_roofline(rec, "seg_reduce_kernel", "Sum")
