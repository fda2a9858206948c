"""GNN substrate (counterpart of ``repro.models.gnn.common``): message
aggregation routed through the paper's design space, and the shared MLP
stack.

:func:`aggregate` is the one scatter primitive every GNN model uses;
the :class:`SystemConfig` it is given picks
- coherence: GPU, one direct scatter into ``[n_nodes + 1, ...]``; or
  DeNovo, the edges first sorted (stably) by ``dst // block_size``, the
  "ownership registration" of target blocks;
- consistency: DRF0, one reduction; DRF1, ``n_chunks`` chunks combined
  in order; DRFrlx, independent partials, then one combine.
Both run on the port's own ``core.coherence.segment_reduce`` and
``core.consistency.scheduled_reduce``, as the reference's run on its
``core``: a plain ``scatter_reduce``, not the blocked kernels K1/K2
(the reference's ``aggregate`` does not reach its Pallas kernels
either).  Padding edges of the last chunk target row ``n_nodes`` and
carry the monoid's identity; an empty segment holds the identity (0,
``+inf`` for min, ``-inf`` for max).

:func:`constrain_flat` is the reference's sharding constraint on node
and edge tensors: ``Shard(0)`` over every mesh dimension under an
active mesh, the identity otherwise.  :func:`aggregate` of DTensor
messages has no DTensor sharding rule to run on (``scatter_reduce``
has none): each rank reduces its own shard of the edges, under the
config's coherence and consistency and with the chunk count of the
whole edge list, into a ``Partial`` ``[n_nodes, ...]``, and one
reduce-scatter (sum, min or max) leaves the nodes flat-sharded.

:func:`mlp_stack` is the reference's (``common.py:97-116``): dense
layers with an activation between them (and after the last with
``final_act``), in float32 and cast back, then an optional layer norm.
DLRM's towers are its ReLU form without a norm.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.coherence import segment_reduce
from repro_torch.core.config_space import (Coherence, Consistency,
                                           SystemConfig, UpdateProp)
from repro_torch.core.consistency import scheduled_reduce
from repro_torch.core.vertex_program import MAX, MIN, SUM
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.mesh_compat import (active_device_mesh,
                                            as_tensor_on, is_dtensor,
                                            replicate_as)

__all__ = ["DEFAULT_GNN_CONFIG", "GNN_CONFIGS", "aggregate", "constrain_flat",
           "gather_rows", "rowwise",
           "segment_softmax", "MLPStack", "init_mlp_stack", "mlp_stack",
           "mlp_stack_from_jax", "layer_of", "graph_inputs"]

#: push + GPU coherence + DRFrlx, the paper's majority-optimal config;
#: models take any SystemConfig
DEFAULT_GNN_CONFIG = SystemConfig(UpdateProp.PUSH, Coherence.GPU,
                                  Consistency.DRFRLX)
#: the six configs ``aggregate`` distinguishes (its direction is push)
GNN_CONFIGS = tuple(SystemConfig(UpdateProp.PUSH, c, m)
                    for c in Coherence for m in Consistency)

_MONOIDS = {"sum": SUM, "min": MIN, "max": MAX}


def constrain_flat(x: torch.Tensor) -> torch.Tensor:
    """dim 0 (nodes or edges) sharded over every mesh dimension when a
    mesh is active and ``x`` is a DTensor (``common.py:35-46``); the
    identity otherwise."""
    if active_device_mesh() is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    flat = [Shard(0)] * mesh.ndim
    if list(x.placements) == flat:
        return x
    return x.redistribute(mesh, flat)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``: the rows of a node tensor for each edge.  A DTensor
    ``x`` is gathered whole on every rank (all-gather) and indexed
    inside ``local_map`` by each rank's edge shard; its gradient is the
    ranks' ``Partial`` scatter-adds, reduce-scattered back onto the
    nodes (DTensor's own rule for an index by a sharded index
    replicates the edge-sized gradient instead)."""
    if not is_dtensor(x):
        return x[idx]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    idx = replicate_as(idx, x)
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if isinstance(pl, Shard) else Replicate()
            for pl in idx.placements]
    fn = local_map(lambda xl, il: xl[il], out_placements=list(idx.placements),
                   in_placements=(rep, tuple(idx.placements)),
                   in_grad_placements=(grad, tuple(idx.placements)))
    return fn(x.redistribute(mesh, rep), idx)


def rowwise(fn: Callable, *args, n_out: int = 1):
    """``fn(*args)``, where the tensors of ``args`` (nested lists and
    mappings allowed) are row-wise: edge or node tensors split over dim
    0, and parameters.  With DTensors it runs inside ``local_map`` on
    each rank's rows (row-wise math needs no collective); the ``n_out``
    outputs come back at the first split tensor's placements, and a
    replicated parameter's gradient ``Partial`` over the dimensions
    that split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten, tree_unflatten
    flat, spec = tree_flatten(args)
    dts = [a for a in flat if is_dtensor(a)]
    if not dts:
        return fn(*args)
    rows = next((a.placements for a in dts
                 if any(isinstance(p, Shard) for p in a.placements)),
                dts[0].placements)
    part = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in rows)
    in_pl = [tuple(a.placements) if is_dtensor(a) else None for a in flat]
    grad_pl = [None if not is_dtensor(a) else
               (part if all(isinstance(p, Replicate) for p in a.placements)
                else tuple(a.placements)) for a in flat]

    def local(*leaves):
        return fn(*tree_unflatten(list(leaves), spec))

    out_pl = list(rows) if n_out == 1 else (tuple(rows),) * n_out
    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl)(*flat)


def _n_chunks(config: SystemConfig, e: int) -> int:
    return 1 if config.consistency is Consistency.DRF0 \
        else min(config.n_chunks, max(1, e // 1024))


def aggregate(values: torch.Tensor, dst: torch.Tensor, n_nodes: int,
              kind: str = "sum",
              config: SystemConfig = DEFAULT_GNN_CONFIG,
              block_size: int = 1024) -> torch.Tensor:
    """values [E, ...], dst [E] -> [n_nodes, ...] reduced by ``kind``
    (``common.py:49-82``)."""
    if is_dtensor(values):
        return constrain_flat(_sharded_aggregate(values, dst, n_nodes, kind,
                                                 config, block_size))
    return _aggregate(values, dst, n_nodes, kind, config, block_size)


def _sharded_aggregate(values, dst, n_nodes, kind, config, block_size):
    """Each rank's edge shard reduced into a ``Partial`` node tensor
    (see the module's notes)."""
    import functools

    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = values.device_mesh
    flat = (Shard(0),) * mesh.ndim
    dst = replicate_as(dst, values)
    values, dst = (t.redistribute(mesh, flat) for t in (values, dst))
    fn = functools.partial(_aggregate, n_nodes=n_nodes, kind=kind,
                           config=config, block_size=block_size,
                           n_chunks=_n_chunks(config, dst.shape[0]))
    return local_map(fn, out_placements=[Partial(kind)] * mesh.ndim,
                     in_placements=(flat, flat))(values, dst)


def _aggregate(values, dst, n_nodes, kind, config, block_size,
               n_chunks=None):
    monoid = _MONOIDS[kind]
    dst = dst.long()
    if config.coherence is Coherence.DENOVO:
        order = torch.argsort(torch.div(dst, block_size,
                                        rounding_mode="floor"), stable=True)
        values, dst = values[order], dst[order]
    e = dst.shape[0]
    if n_chunks is None:
        n_chunks = _n_chunks(config, e)
    ec = -(-e // n_chunks)
    pad = n_chunks * ec - e
    if pad:
        values = torch.cat([values, values.new_zeros((pad,)
                                                     + values.shape[1:])])
        dst = torch.cat([dst, dst.new_full((pad,), n_nodes)])
    values = values.reshape((n_chunks, ec) + values.shape[1:])
    dst = dst.reshape(n_chunks, ec)
    ident = monoid.identity(values.dtype)

    def chunk_reduce(i):
        v, d = values[i], dst[i]
        if kind != "sum":  # padding must contribute the identity
            v = torch.where((d < n_nodes).view((-1,) + (1,) * (v.dim() - 1)),
                            v, ident)
        return segment_reduce(v, d, n_nodes + 1, monoid)

    out = scheduled_reduce(chunk_reduce, n_chunks, config.consistency,
                           monoid)
    return out[:n_nodes]


def segment_softmax(logits: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                    config: SystemConfig = DEFAULT_GNN_CONFIG
                    ) -> torch.Tensor:
    """Edge softmax normalised over each target's incoming edges
    (``common.py:85-94``)."""
    dst = dst.long()
    mx = aggregate(logits, dst, n_nodes, "max", config)
    ex = torch.exp(logits - gather_rows(mx, dst))
    den = aggregate(ex, dst, n_nodes, "sum", config)
    # torch.maximum, not clamp_min: its gradient at a tie is the
    # reference's jnp.maximum's (half to each side)
    return ex / torch.maximum(gather_rows(den, dst),
                              replicate_as(den.new_tensor(1e-30), den))


# ---------------------------------------------------------------------------
# MLP stacks
# ---------------------------------------------------------------------------
class MLPStack(nn.Module):
    """``layers[i]`` are :class:`~repro_torch.models.layers.Dense`;
    ``ln`` an optional final :class:`~repro_torch.models.layers.Norm`."""

    def __init__(self, layers: Sequence[L.Dense],
                 ln: Optional[L.Norm] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.ln = ln


def init_mlp_stack(dims: Sequence[int], *, generator: torch.Generator,
                   device, layer_norm: bool = False) -> MLPStack:
    """float32 dense layers with zero biases, ``N(0,1)/sqrt(d_in)``, and
    with ``layer_norm`` a unit-scale final norm without bias."""
    layers = [L.init_dense(dims[i], dims[i + 1], use_bias=True,
                           dtype=torch.float32, generator=generator,
                           device=device) for i in range(len(dims) - 1)]
    ln = (L.init_norm(dims[-1], torch.float32, device=device)
          if layer_norm else None)
    return MLPStack(layers, ln)


def mlp_stack(p: MLPStack, x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len(p.layers)
    for i, lp in enumerate(p.layers):
        x = L.dense(lp, x)
        if i < n - 1 or final_act:
            x = act(x.float()).to(x.dtype)
    if p.ln is not None:
        x = L.layer_norm(p.ln, x)
    return x


# ---------------------------------------------------------------------------
# carrying the reference's parameters across, and the inputs
# ---------------------------------------------------------------------------
def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def layer_of(tree: Mapping, i: int) -> dict:
    """Layer ``i`` of a pytree whose leaves are stacked along a leading
    layer axis (the reference's ``jax.vmap``-ed blocks)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = layer_of(v, i)
        elif isinstance(v, (list, tuple)):
            out[k] = [layer_of(x, i) for x in v]
        else:
            out[k] = np.asarray(v)[i]
    return out


def mlp_stack_from_jax(p: Mapping, device) -> MLPStack:
    """An :class:`MLPStack` holding a reference stack's numpy arrays."""
    layers = [L.Dense(_tensor(lp["w"], device), _tensor(lp["b"], device))
              for lp in p["layers"]]
    ln = None
    if "ln" in p:
        ln = L.Norm(_tensor(p["ln"]["scale"], device),
                    _tensor(p["ln"]["bias"], device)
                    if "bias" in p["ln"] else None)
    return MLPStack(layers, ln)


def graph_inputs(params: nn.Module, inputs: Mapping, device=None) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``
    (``None``: the CUDA card), where ``params`` must already be; integer
    arrays keep their type."""
    device = resolve_device(device)
    have = next(params.parameters()).device
    if have != device:
        raise ValueError(f"GNN parameters are on {have}, the call asks "
                         f"for {device}")
    return {k: as_tensor_on(v, device) for k, v in inputs.items()}
