"""The train steps of the model zoo (counterpart of the ``step``\\ s of
``repro.configs.base``'s train cells): the LM step of
``lm_train_cell`` (``base.py:146-189``), with gradient accumulation over
microbatches, for the dense LMs and the MoEs alike; the GNN step of
``make_gnn_arch`` (``base.py:351-392``) and DLRM's ``train_step`` of
``make_dlrm_arch`` (``base.py:429-433``), both a loss and AdamW at lr
1e-3.  :data:`GNN_SHAPES` are the GNNs' four input shapes.

A step is ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``, as :func:`repro_torch.train.trainer.train_loop` calls it.
It turns ``requires_grad`` on for every parameter, computes the loss and
the gradients with ``torch.autograd.grad`` (nothing is left in
``.grad``), and hands them to ``adamw_update``, which writes the
parameters and the state in place.  Nothing is written before the
gradients and their norm exist, so a step that raises can be run again.
``metrics`` holds ``loss`` and ``grad_norm`` as f32 scalar tensors.
Parameters may be DTensors (``torch.distributed.tensor``): gradients are
then DTensors too, accumulated in DTensors of the parameters' placements.

The second half is the dry run's (``base.py:30-473``): :class:`P`, the
counterpart of ``PartitionSpec`` (one entry per tensor dimension:
``None``, an axis name, or a tuple of axis names), :func:`to_placements`
and :func:`distribute_params`, which carry a spec onto a
``DeviceMesh`` as DTensor placements; :class:`Axes`,
:func:`axes_for_mesh` and :class:`Cell`; the parameter shardings
(:func:`lm_param_sharding` over the port's per-layer parameter names,
so without the reference's leading layer ``None``); every cell's inputs
as meta tensors (the counterpart of ``ShapeDtypeStruct``) and their
shardings; and :func:`make_lm_arch`, :func:`make_gnn_arch` and
:func:`make_dlrm_arch`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRMConfig, dlrm_loss
from repro_torch.models.transformer import LMConfig, train_forward
from repro_torch.optim.adamw import AdamWConfig, adamw_update

__all__ = ["lm_train_step", "loss_train_step", "dlrm_train_step",
           "trainable", "value_and_grad", "GNN_SHAPES", "P", "to_placements",
           "distribute_params", "Axes", "axes_for_mesh", "Cell", "Arch",
           "replicate_like", "opt_sharding_like", "lm_param_sharding",
           "lm_train_cell", "lm_prefill_cell", "lm_decode_cell",
           "gnn_input_specs", "gnn_input_sharding", "make_lm_arch",
           "make_gnn_arch", "make_dlrm_arch"]


def _pad512(n: int) -> int:
    """Graph tensors padded up to the 512-device multiple, as the
    reference's dry-run shapes are (``base.py:279-283``)."""
    return -(-n // 512) * 512


#: the GNNs' four input shapes: (n_nodes, n_edges, d_feat, n_graphs)
#: (``base.py:287-298``)
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=_pad512(2708), n_edges=_pad512(10556),
                          d_feat=1433, n_graphs=1, kind="train"),
    "minibatch_lg": dict(n_nodes=_pad512(1024 * (1 + 10 + 150)),
                         n_edges=_pad512(1024 * 10 + 1024 * 150),
                         d_feat=602, n_graphs=1, kind="train"),
    "ogb_products": dict(n_nodes=_pad512(2449029), n_edges=_pad512(61859140),
                         d_feat=100, n_graphs=1, kind="train"),
    "molecule": dict(n_nodes=_pad512(30 * 128), n_edges=_pad512(64 * 128 * 2),
                     d_feat=0, n_graphs=128, kind="train"),
}


def trainable(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter by name, with ``requires_grad`` turned on."""
    leaves = dict(params.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    return leaves


def value_and_grad(loss_fn: Callable[[], torch.Tensor],
                   leaves: Dict[str, torch.Tensor]):
    """``(loss, {name: gradient})`` of ``loss_fn()`` in ``leaves``."""
    loss = loss_fn()
    if _is_dtensor(loss):
        loss = loss.full_tensor()       # a Partial loss is summed first
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    """An f32 accumulator of ``p``'s shape (a DTensor of its placements
    where ``p`` is one)."""
    if _is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _microbatch(v, i: int, microbatches: int):
    """Rows ``[i * b/m, (i + 1) * b/m)`` of ``v`` [b, ...], the i-th of
    ``reshape(m, b/m, ...)``.  A DTensor's block is taken from its
    gathered rows and sharded again as ``v`` is, so that every microbatch
    stays spread over the data-parallel ranks."""
    if not _is_dtensor(v):
        v = torch.as_tensor(v)
        return v.reshape((microbatches, v.shape[0] // microbatches)
                         + tuple(v.shape[1:]))[i]
    rows = v.shape[0] // microbatches
    whole = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)
    return whole[i * rows:(i + 1) * rows].redistribute(v.device_mesh,
                                                       v.placements)


def lm_train_step(cfg: LMConfig, batch: int, seq: int,
                  microbatches: int = 1,
                  opt_cfg: AdamWConfig = AdamWConfig(), device=None,
                  forward: Callable = train_forward):
    """The step of ``lm_train_cell`` for batches of ``[batch, seq]``
    tokens (the train_4k cell, ``base.py:258-259``, is 256 x 4,096 in 8
    microbatches), through ``forward(cfg, params, batch, device=)``:
    ``transformer.train_forward`` or ``moe.moe_train_forward``.  With
    ``microbatches > 1`` the batch is split into that many row blocks
    (``reshape(microbatches, batch // microbatches, seq)``);
    their gradients are summed in f32 accumulators, and loss and
    gradients divided by ``microbatches``, as the reference's scan."""
    device = resolve_device(device)
    if batch % microbatches:
        raise ValueError(f"lm_train_step: batch {batch} is not a multiple "
                         f"of {microbatches} microbatches")

    def step(params, opt_state, batch_in):
        leaves = trainable(params)
        if microbatches == 1:
            loss, grads = value_and_grad(
                lambda: forward(cfg, params, batch_in, device=device),
                leaves)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = {n: _f32_zeros(p) for n, p in leaves.items()}
            for i in range(microbatches):
                part = {k: _microbatch(v, i, microbatches)
                        for k, v in batch_in.items()}
                l, g = value_and_grad(
                    lambda: forward(cfg, params, part, device=device),
                    leaves)
                loss = loss + l
                for n, gg in g.items():
                    grads[n].add_(gg)
                del g
            loss = loss / microbatches
            for a in grads.values():
                a.div_(microbatches)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def loss_train_step(cfg, loss_fn: Callable,
                    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
                    device=None):
    """One ``loss_fn(cfg, params, batch, device=)`` and its gradients,
    then AdamW: the GNN step of ``make_gnn_arch`` and DLRM's, both at
    lr 1e-3."""
    device = resolve_device(device)

    def step(params, opt_state, batch_in):
        leaves = trainable(params)
        loss, grads = value_and_grad(
            lambda: loss_fn(cfg, params, batch_in, device=device), leaves)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def dlrm_train_step(cfg: DLRMConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
                    device=None):
    """DLRM's ``train_step``: BCE through the plain embedding bag (K3
    has no backward), dense AdamW over every table at lr 1e-3."""
    return loss_train_step(cfg, functools.partial(dlrm_loss, impl="plain"),
                           opt_cfg, device)


# ---------------------------------------------------------------------------
# specs and their placements
# ---------------------------------------------------------------------------
class P(tuple):
    """The counterpart of ``jax.sharding.PartitionSpec``: one entry per
    leading tensor dimension, each ``None`` (replicated), a mesh axis
    name, or a tuple of axis names (the dimension split over them, the
    first outermost).  Dimensions past the last entry are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Optional[P], mesh) -> list:
    """``spec`` as DTensor placements, one per dimension of ``mesh`` (a
    ``DeviceMesh``): ``Shard(d)`` on each mesh dimension that tensor
    dimension ``d`` is split over, ``Replicate()`` on the others.  A
    dimension split over several axes gives several ``Shard(d)``, which
    DTensor nests in mesh order; so the axes of one entry must come in
    mesh order, and ``ValueError`` is raised otherwise, or for an axis
    the mesh lacks or one used twice.  ``None`` replicates."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec or ()):
        axes = _axes_of(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"to_placements: axes {missing} of {spec!r} "
                             f"are not the mesh's {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"to_placements: {spec!r} splits dimension {d} "
                             f"over {axes} out of the mesh's order {names}; "
                             "DTensor nests shards in mesh order only")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"to_placements: axis {names[i]!r} is used "
                                 f"twice in {spec!r}")
            out[i] = Shard(d)
    return out


def _spec_of(spec_tree, name: str):
    if spec_tree is None:
        return None
    if name not in spec_tree:
        raise KeyError(f"no sharding spec for parameter {name!r}")
    return spec_tree[name]


def distribute_params(module: nn.Module, mesh, spec_tree) -> nn.Module:
    """Replace every parameter of ``module`` by a DTensor on ``mesh``
    placed by its spec: ``spec_tree`` maps parameter names
    (``named_parameters()``) to :class:`P`, or is ``None`` to replicate
    all.  A parameter that is already a DTensor is redistributed.  The
    parameters keep their ``requires_grad``; returns ``module``."""
    for name, p in list(module.named_parameters()):
        placements = to_placements(_spec_of(spec_tree, name), mesh)
        data = p.detach()
        if _is_dtensor(data):
            dt = data.redistribute(mesh, placements)
        else:
            dt = distribute_tensor(data, mesh, placements)
        owner, _, attr = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, attr, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def distribute_tree(tree, mesh, spec_tree):
    """A mapping of tensors (nested mappings allowed) as DTensors placed
    by the matching mapping of specs (``None``: replicated)."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, mesh, None if spec_tree is None
                                   else spec_tree[k])
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh, to_placements(spec_tree, mesh))


# ---------------------------------------------------------------------------
# axes, cells, archs
# ---------------------------------------------------------------------------
F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


@dataclasses.dataclass(frozen=True)
class Axes:
    dp: tuple          # batch/FSDP axes
    tp: str            # tensor/expert axis
    all_axes: tuple    # every mesh axis (flat sharding for graph data)
    dp_size: int = 1   # product of dp axis sizes (MoE dispatch groups)


def _mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of any object with
    ``axis_names`` and a ``shape`` mapping (the reference's mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def axes_for_mesh(mesh) -> Axes:
    """``base.py:39-46``: FSDP/batch over data (and pod), TP over model."""
    sizes = _mesh_sizes(mesh)
    dp_size = sizes.get("pod", 1) * sizes.get("data", 1)
    if "pod" in sizes:
        return Axes(dp=("pod", "data"), tp="model",
                    all_axes=("pod", "data", "model"), dp_size=dp_size)
    return Axes(dp=("data",), tp="model", all_axes=("data", "model"),
                dp_size=dp_size)


@dataclasses.dataclass
class Cell:
    """One (arch x input-shape) dry-run unit (``base.py:49-62``)."""
    shape_name: str
    kind: str                         # train | prefill | decode | serve
    #: () -> mapping of meta tensors, the step's data inputs
    input_specs: Callable[[], Any]
    #: (axes) -> mapping of :class:`P` matching input_specs
    input_sharding: Callable[[Axes], Any]
    #: (device) -> the step, ``(params, [opt_state,] batch) -> outputs``
    #: (the reference's ``step``, bound to a device as the port's
    #: entry points are)
    make_step: Callable[..., Callable[..., Any]]
    needs_opt: bool = False


@dataclasses.dataclass(frozen=True)
class Arch:
    """An architecture: its configs, initialiser and training loss, and
    for the dry run its abstract parameters, their sharding and cells."""
    name: str
    family: str       # lm | moe | gnn | recsys, as the reference's
    cfg: Any
    reduced_cfg: Any
    #: (cfg, generator, device=None) -> parameters
    init_params: Callable[..., Any]
    #: (cfg, params, batch, device=None) -> the training loss (f32
    #: scalar): ``train_forward``, ``moe_train_forward``, a GNN's loss,
    #: or ``dlrm_loss`` through the plain embedding bag
    loss: Callable[..., Any]
    #: GNNs: shape name of ``GNN_SHAPES`` -> that shape's config
    cfg_for: Optional[Callable[[str], Any]] = None
    #: () -> the parameters on the meta device (nothing allocated)
    abstract_params: Optional[Callable[[], nn.Module]] = None
    #: (axes) -> {parameter name: P}, or None (replicated)
    param_sharding: Optional[Callable[[Axes], Any]] = None
    cells: Optional[Dict[str, Cell]] = None
    #: GNNs: (shape name) -> that shape's meta parameters
    abstract_params_for: Optional[Callable[[str], nn.Module]] = None

    def cell(self, shape_name: str) -> Cell:
        return self.cells[shape_name]


def replicate_like(tree):
    """A spec of ``P()`` for every leaf of a mapping (or parameter
    names of a module)."""
    if isinstance(tree, nn.Module):
        return {n: P() for n, _ in tree.named_parameters()}
    return {k: replicate_like(v) if isinstance(v, Mapping) else P()
            for k, v in tree.items()}


def opt_sharding_like(param_spec):
    """AdamW's state mirrors the parameters: ``mu`` and ``nu`` keyed by
    parameter name as ``adamw_init`` keys them, ``step`` replicated."""
    return {"mu": dict(param_spec), "nu": dict(param_spec), "step": P()}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------
def lm_param_sharding(cfg, ax: Axes, moe_mode: Optional[str] = None
                      ) -> Dict[str, P]:
    """``base.py:99-143`` over the port's per-layer parameter names
    (``blocks.<i>.attn.wq.w``, ...): each layer's spec is the
    reference's stacked spec without its leading layer ``None``."""
    dp, tp = ax.dp, ax.tp
    layer = {"ln1.scale": P(None),
             "attn.wq.w": P(dp, tp), "attn.wk.w": P(dp, tp),
             "attn.wv.w": P(dp, tp), "attn.wo.w": P(tp, dp)}
    if cfg.use_bias:
        for k in ("wq", "wk", "wv"):
            layer[f"attn.{k}.b"] = P(tp)
        layer["attn.wo.b"] = P(None)
    if moe_mode is None:
        layer["mlp.up.w"] = P(dp, tp)
        layer["mlp.down.w"] = P(tp, dp)
        if cfg.act in ("swiglu", "geglu"):
            layer["mlp.gate.w"] = P(dp, tp)
        if cfg.use_bias:
            layer["mlp.up.b"] = P(tp)
            layer["mlp.down.b"] = P(None)
            if cfg.act in ("swiglu", "geglu"):
                layer["mlp.gate.b"] = P(tp)
        if not cfg.parallel_block:
            layer["ln2.scale"] = P(None)
    else:
        # 'ep' shards the expert axis over tp; 'tp' keeps the experts
        # replicated and shards d_ff over tp (few-expert models)
        espec, dspec = ((P(tp, dp, None), P(tp, None, dp))
                        if moe_mode == "ep" else
                        (P(None, dp, tp), P(None, tp, dp)))
        layer.update({"moe.router": P(dp, None), "moe.up": espec,
                      "moe.down": dspec})
        if cfg.act in ("swiglu", "geglu"):
            layer["moe.gate"] = espec
        layer["ln2.scale"] = P(None)
    out = {"embed": P(tp, dp)}
    for i in range(cfg.n_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in layer.items()})
    out["final_norm.scale"] = P(None)
    return out


def lm_train_cell(cfg, shape_name, batch, seq, train_fwd,
                  microbatches: int = 1) -> Cell:
    def specs():
        return {"tokens": _meta((batch, seq), I32),
                "labels": _meta((batch, seq), I32)}

    def sharding(ax: Axes):
        return {"tokens": P(ax.dp, None), "labels": P(ax.dp, None)}

    def make_step(device=None):
        return lm_train_step(cfg, batch, seq, microbatches, device=device,
                             forward=train_fwd)

    return Cell(shape_name, "train", specs, sharding, make_step,
                needs_opt=True)


def lm_prefill_cell(cfg, shape_name, batch, seq, prefill_fn) -> Cell:
    def specs():
        return {"tokens": _meta((batch, seq), I32)}

    def sharding(ax: Axes):
        return {"tokens": P(ax.dp, None)}

    def make_step(device=None):
        def step(params, batch_in):
            return prefill_fn(cfg, params, batch_in["tokens"], impl="plain",
                              device=device)
        return step

    return Cell(shape_name, "prefill", specs, sharding, make_step)


def lm_decode_cell(cfg, shape_name, batch, kv_seq, decode_fn) -> Cell:
    cache_shape = (cfg.n_layers, batch, cfg.n_kv_heads, kv_seq, cfg.d_head)

    def specs():
        return {"token": _meta((batch, 1), I32),
                "k_cache": _meta(cache_shape, BF16),
                "v_cache": _meta(cache_shape, BF16),
                "kv_len": _meta((), I32)}

    def sharding(ax: Axes):
        if batch > 1:
            cspec = P(None, ax.dp, None, ax.tp, None)   # B over dp, S over tp
            tspec = P(ax.dp, None)
        else:  # batch=1 long-context: the sequence over every axis
            cspec = P(None, None, None, ax.all_axes, None)
            tspec = P(None, None)
        return {"token": tspec, "k_cache": cspec, "v_cache": cspec,
                "kv_len": P()}

    def make_step(device=None):
        def step(params, batch_in):
            kv_len = batch_in["kv_len"]
            # a meta kv_len (the dry run) has no value: the cache is
            # taken as full but for the new token; shapes do not depend
            # on it
            kv_len = (kv_seq - 1 if kv_len.device.type == "meta"
                      else int(kv_len))
            return decode_fn(cfg, params, batch_in["token"],
                             (batch_in["k_cache"], batch_in["v_cache"]),
                             kv_len, device=device)
        return step

    return Cell(shape_name, "decode", specs, sharding, make_step)


def make_lm_arch(name, cfg, reduced_cfg, *, moe_mode=None,
                 axes: Optional[Axes] = None) -> Arch:
    """``base.py:224-276``: with ``axes``, the mesh axes are bound into
    the config (``dp_axes``, ``tp_axis``, ``sp_axis``; for MoEs also
    ``moe_mode`` and ``dispatch_groups = dp_size``)."""
    if axes is not None:
        cfg = dataclasses.replace(cfg, dp_axes=tuple(axes.dp),
                                  tp_axis=axes.tp, sp_axis=axes.tp)
        if moe_mode is not None:
            cfg = dataclasses.replace(cfg, moe_mode=moe_mode,
                                      dispatch_groups=axes.dp_size)
    if moe_mode is None:
        from repro_torch.models.transformer import (abstract_lm_params,
                                                    decode_step, init_lm,
                                                    prefill, train_forward)
        init, abstract = init_lm, abstract_lm_params
        train_fwd, decode_fn, prefill_fn = train_forward, decode_step, prefill
    else:
        from repro_torch.models.moe import (abstract_moe_params, init_moe_lm,
                                            moe_decode_step, moe_prefill,
                                            moe_train_forward)
        init, abstract = init_moe_lm, abstract_moe_params
        train_fwd, decode_fn = moe_train_forward, moe_decode_step
        prefill_fn = moe_prefill
    cells = {
        "train_4k": lm_train_cell(cfg, "train_4k", 256, 4096, train_fwd,
                                  microbatches=8),
        "decode_32k": lm_decode_cell(cfg, "decode_32k", 128, 32768,
                                     decode_fn),
        "long_500k": lm_decode_cell(cfg, "long_500k", 1, 524288, decode_fn),
        "prefill_32k": lm_prefill_cell(cfg, "prefill_32k", 32, 32768,
                                       prefill_fn),
    }
    return Arch(name=name, family="moe" if moe_mode else "lm", cfg=cfg,
                reduced_cfg=reduced_cfg, init_params=init, loss=train_fwd,
                abstract_params=lambda: abstract(cfg),
                param_sharding=lambda ax: lm_param_sharding(cfg, ax,
                                                            moe_mode),
                cells=cells)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------
def gnn_input_specs(model_kind: str, dims) -> Callable[[], Any]:
    """``base.py:301-328``: a GNN cell's inputs as meta tensors."""
    n, e, f, g = (dims["n_nodes"], dims["n_edges"], dims["d_feat"],
                  dims["n_graphs"])

    def specs():
        base = {"src": _meta((e,), I32), "dst": _meta((e,), I32)}
        if model_kind in ("schnet", "equiformer"):
            base.update({"species": _meta((n,), I32),
                         "positions": _meta((n, 3), F32),
                         "graph_ids": _meta((n,), I32),
                         "energy": _meta((g,), F32)})
        elif model_kind == "mgn":
            base.update({"node_feat": _meta((n, max(f, 12)), F32),
                         "edge_feat": _meta((e, 4), F32),
                         "target": _meta((n, 3), F32)})
        else:  # pna
            base.update({"node_feat": _meta((n, max(f, 16)), F32),
                         "in_degree": _meta((n,), I32),
                         "labels": _meta((n,), I32)})
        return base

    return specs


def gnn_input_sharding(model_kind: str):
    """``base.py:331-346``: node and edge tensors flat over every axis."""
    def sharding(ax: Axes):
        flat = ax.all_axes
        base = {"src": P(flat), "dst": P(flat)}
        if model_kind in ("schnet", "equiformer"):
            base.update({"species": P(flat), "positions": P(flat, None),
                         "graph_ids": P(flat), "energy": P(None)})
        elif model_kind == "mgn":
            base.update({"node_feat": P(flat, None),
                         "edge_feat": P(flat, None),
                         "target": P(flat, None)})
        else:
            base.update({"node_feat": P(flat, None), "in_degree": P(flat),
                         "labels": P(flat)})
        return base

    return sharding


def make_gnn_arch(name, model_kind, cfg_builder, init_fn, loss_fn,
                  reduced_cfg) -> Arch:
    """``base.py:349-392``: a train cell per shape of ``GNN_SHAPES``,
    each with its own config; the parameters are replicated."""
    from repro_torch.optim.adamw import AdamWConfig
    cells = {}
    for shape_name, dims in GNN_SHAPES.items():
        cfg = cfg_builder(dims)

        def make_step(device=None, cfg=cfg):
            return loss_train_step(cfg, loss_fn, AdamWConfig(lr=1e-3),
                                   device)

        cells[shape_name] = Cell(shape_name, "train",
                                 gnn_input_specs(model_kind, dims),
                                 gnn_input_sharding(model_kind), make_step,
                                 needs_opt=True)

    def abstract_for(shape_name):
        return init_fn(cfg_builder(GNN_SHAPES[shape_name]), None,
                       device="meta")

    first = "molecule" if model_kind in ("schnet", "equiformer") \
        else "full_graph_sm"
    return Arch(name=name, family="gnn", cfg=cfg_builder(GNN_SHAPES[first]),
                reduced_cfg=reduced_cfg, init_params=init_fn, loss=loss_fn,
                cfg_for=lambda shape: cfg_builder(GNN_SHAPES[shape]),
                abstract_params=lambda: abstract_for("full_graph_sm"),
                param_sharding=lambda ax: None, cells=cells,
                abstract_params_for=abstract_for)


# ---------------------------------------------------------------------------
# RecSys family (DLRM)
# ---------------------------------------------------------------------------
def make_dlrm_arch(name, cfg, reduced_cfg) -> Arch:
    """``base.py:398-473``: train_batch, serve_p99, serve_bulk and
    retrieval_cand; tables of 4,096 rows or more row-sharded over tp."""
    from repro_torch.configs.dlrm_mlperf import (RETRIEVAL_CANDIDATES,
                                                 retrieval_step, serve_step)
    from repro_torch.models.dlrm import dlrm_loss, init_dlrm

    def specs_for(batch, retrieval=False):
        def specs():
            base = {"dense": _meta((batch, cfg.n_dense), F32),
                    "sparse": _meta((batch, cfg.n_sparse, cfg.multi_hot),
                                    I32)}
            if retrieval:
                base["cand"] = _meta((RETRIEVAL_CANDIDATES, cfg.embed_dim),
                                     F32)
            else:
                base["label"] = _meta((batch,), I32)
            return base
        return specs

    def sharding_for(batch, retrieval=False):
        def sharding(ax: Axes):
            dp = ax.dp if batch > 1 else None
            base = {"dense": P(dp, None), "sparse": P(dp, None, None)}
            if retrieval:
                base["cand"] = P(ax.all_axes, None)
            else:
                base["label"] = P(dp)
            return base
        return sharding

    def train(device=None):
        return dlrm_train_step(cfg, device=device)

    def serve(device=None):
        return lambda params, b: serve_step(cfg, params, b, impl="plain",
                                            device=device)

    def retrieval(device=None):
        return lambda params, b: retrieval_step(cfg, params, b,
                                                device=device)

    cells = {
        "train_batch": Cell("train_batch", "train", specs_for(65536),
                            sharding_for(65536), train, needs_opt=True),
        "serve_p99": Cell("serve_p99", "serve", specs_for(512),
                          sharding_for(512), serve),
        "serve_bulk": Cell("serve_bulk", "serve", specs_for(262144),
                           sharding_for(262144), serve),
        "retrieval_cand": Cell("retrieval_cand", "serve",
                               specs_for(1, retrieval=True),
                               sharding_for(1, retrieval=True), retrieval),
    }

    def abstract():
        return init_dlrm(cfg, None, device="meta")

    def param_sharding(ax: Axes):
        out = {f"table_{i}": P(ax.tp, None) if v >= 4096 else P(None, None)
               for i, v in enumerate(cfg.vocab_sizes)}
        out.update({n: P() for n, _ in abstract().named_parameters()
                    if not n.startswith("table_")})
        return out

    return Arch(name=name, family="recsys", cfg=cfg, reduced_cfg=reduced_cfg,
                init_params=init_dlrm,
                loss=functools.partial(dlrm_loss, impl="plain"),
                abstract_params=abstract, param_sharding=param_sharding,
                cells=cells)
