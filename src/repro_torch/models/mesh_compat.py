"""The active device mesh (counterpart of ``repro.models.mesh_compat``).

Model code asks one question, "is a mesh active, and which?", and takes
its sharded branches only when one is.  :func:`use_mesh` is the
counterpart of ``jax.sharding.set_mesh``: it makes a ``DeviceMesh``
active for the block it opens.  Without one, :func:`active_device_mesh`
is ``None`` and every model path is the unsharded one.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

__all__ = ["active_device_mesh", "use_mesh"]

_state = threading.local()


def active_device_mesh():
    """The innermost mesh of :func:`use_mesh` on this thread, or None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Optional[object]]:
    """Make ``mesh`` the active mesh inside the ``with`` block."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def replicate_as(t, ref):
    """``t`` as a DTensor replicated over ``ref``'s mesh when ``ref`` is
    a DTensor (so that the two combine in one op), else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x, spec):
    """The counterpart of ``with_sharding_constraint``: a DTensor ``x``
    redistributed to ``spec`` (``configs.base.P``) on its mesh; any other
    ``x``, or ``x`` outside :func:`use_mesh`, is returned as it is."""
    if active_device_mesh() is None or not is_dtensor(x):
        return x
    from repro_torch.configs.base import to_placements
    placements = to_placements(spec, x.device_mesh)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def as_tensor_on(v, device):
    """``torch.as_tensor(v).to(device)``; a DTensor is returned as it
    is (it already lives on its mesh)."""
    if is_dtensor(v):
        return v
    return torch.as_tensor(v).to(device)


def _holds_dtensor(args) -> bool:
    for a in args:
        if isinstance(a, nn.Module):
            a = next(a.parameters(), None)
        if is_dtensor(a):
            return True
    return False


def serving(fn):
    """Run ``fn`` under ``torch.inference_mode``, or under
    ``torch.no_grad`` when an argument (a module's parameters, or a
    tensor) is a DTensor: DTensor's views of inference tensors fail."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        ctx = torch.no_grad() if _holds_dtensor(args) \
            else torch.inference_mode()
        with ctx:
            return fn(*args, **kwargs)
    return wrapper


def sharded_rows(table, idx):
    """``table[idx]`` for a DTensor ``table`` whose rows may be sharded
    (a vocab-parallel embedding), in ``local_map``: each rank reads the
    rows it holds for its own indices and zeroes the others, and the
    result is ``Partial`` over the mesh dimensions that split the rows
    (so the table is never gathered, nor is its gradient table-sized on
    a rank: each rank's gradient is its own rows', ``Partial`` over the
    dimensions that split ``idx``)."""
    mesh = table.device_mesh
    idx = replicate_as(idx, table)
    split = [isinstance(pl, Shard) and pl.dim == 0
             for pl in table.placements]
    idx_pl = tuple(Replicate() if sp else pl
                   for sp, pl in zip(split, idx.placements))
    out_pl = [Partial() if sp else pl for sp, pl in zip(split, idx_pl)]
    grad_pl = tuple(pl if sp else (Partial() if isinstance(ipl, Shard)
                                   else Replicate())
                    for sp, pl, ipl in zip(split, table.placements, idx_pl))
    _, (off, *_) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)

    def local(tl, il):
        mine = (il >= off) & (il < off + tl.shape[0])
        rows = tl[torch.where(mine, il - off, 0)]
        return rows * mine[..., None].to(tl.dtype)

    return local_map(local, out_placements=out_pl,
                     in_placements=(tuple(table.placements), idx_pl),
                     in_grad_placements=(grad_pl, idx_pl))(
        table, idx.redistribute(mesh, idx_pl))
