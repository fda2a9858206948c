"""The bytes the profiled runs' edge phases need
(``roofline.edge_phase_bytes``, from V, E, the iterations and their
occupancies) at the HBM bandwidth, over the device's busy time, in %."""
from perfbench.roofline import HBM_BYTES_PER_S, edge_phase_bytes


def read(rec):
    p = rec.profile
    if p is None or p.busy_s <= 0 or not rec.profiled_runs:
        return None
    need = edge_phase_bytes(rec.profiled_runs, rec.n_nodes, rec.n_edges,
                            rec.sparse_capacity)
    return 100.0 * need / HBM_BYTES_PER_S / p.busy_s
