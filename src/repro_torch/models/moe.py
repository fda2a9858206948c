"""Token-choice top-k MoE LMs (qwen3-moe-235b-a22b, grok-1-314b);
counterpart of ``repro.models.moe``.

Sort-based dispatch, as the reference's: each group's (token, expert)
assignments are sorted by expert with a *stable* sort (``jnp.argsort``
is stable, ``torch.argsort`` only with ``stable=True``, and the rank
within an expert decides which tokens overflow), ranked by a
``searchsorted`` on the sorted experts, and scattered into per-expert
capacity buffers ``[G, E, cap, d]`` with one overflow row that is cut
off.  The grouped GEMM over experts is a batched product (the reference
computes it with ``einsum`` outside any Pallas kernel); combine gathers
each assignment's output, weights it by its gate and scatter-adds it
into its token in the activations' type.

The MoE LM is the dense skeleton of ``models.transformer`` with the FFN
swapped: each :class:`MoEBlock` holds ``ln1``, ``attn``, ``moe`` and
``ln2`` (the reference's pytree keys).  :func:`moe_prefill` runs K4 once
per layer on the card (``impl="plain"`` gives ``blocked_attention``);
:func:`moe_decode_step` is the plain decode; :func:`moe_train_forward`
adds the router's load-balance loss, averaged over layers, to the
chunked cross-entropy, each block recomputed in the backward under
``cfg.remat``.

Sharded, the layer follows the reference's ``shard_map`` branches with
``local_map`` (:func:`moe_apply`).  Every entry point takes
``device=None``, meaning the CUDA card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import P
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mesh_compat import (active_device_mesh, constrain,
                                            is_dtensor, serving)
from repro_torch.models.transformer import LMConfig
from repro_torch.spans import span

__all__ = ["MoEConfig", "MoELayer", "MoEBlock", "init_moe_layer",
           "moe_apply", "capacity", "init_moe_lm", "abstract_moe_params",
           "moe_params_from_jax",
           "moe_prefill", "moe_decode_step", "moe_train_forward"]


@dataclasses.dataclass(frozen=True)
class MoEConfig(LMConfig):
    """The reference's fields (``moe.py:28-37``).  ``moe_mode`` names the
    sharding of the experts (``"ep"``: the expert axis over tp; ``"tp"``:
    d_ff over tp) and acts only under a mesh."""
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_mode: str = "ep"
    dispatch_groups: int = 1

    def _attn_params(self) -> int:
        d, h = self.d_model, self.d_head
        return d * h * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * h * d

    @property
    def n_params(self) -> int:
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        moe = self.n_experts * glu * self.d_model * self.d_ff \
            + self.d_model * self.n_experts
        return self.n_layers * (self._attn_params() + moe) \
            + self.vocab * self.d_model

    @property
    def n_active_params(self) -> int:
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        act = self.top_k * glu * self.d_model * self.d_ff \
            + self.d_model * self.n_experts
        return self.n_layers * (self._attn_params() + act) \
            + self.vocab * self.d_model


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MoELayer(nn.Module):
    """``router [d, E]`` (f32), ``up``/``gate [E, d, f]``, ``down [E, f,
    d]`` (the model's type); ``gate`` only for the gated activations."""

    def __init__(self, router: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor, gate: Optional[torch.Tensor] = None):
        super().__init__()
        self.router = _param(router)
        self.up = _param(up)
        self.down = _param(down)
        self.gate = None if gate is None else _param(gate)


class MoEBlock(nn.Module):
    def __init__(self, ln1: L.Norm, attn: T.Attention, moe: MoELayer,
                 ln2: L.Norm):
        super().__init__()
        self.ln1, self.attn, self.moe, self.ln2 = ln1, attn, moe, ln2


def _experts(e: int, d_in: int, d_out: int, scale: float, dtype, gen,
             device) -> torch.Tensor:
    """``[e, d_in, d_out]`` normal weights drawn in f32 times ``scale``,
    one expert at a time, so that the f32 draw never holds more than one
    expert (grok-1's up projection is 6.4 GB in f32)."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    if out.device.type == "meta":      # shapes only: nothing to draw
        return out
    for i in range(e):
        out[i] = torch.randn((d_in, d_out), generator=gen, device=device,
                             dtype=torch.float32).mul_(scale)
    return out


def init_moe_layer(cfg: MoEConfig, generator: torch.Generator,
                   device=None) -> MoELayer:
    """``moe.py:40-56``: the router ``N(0,1)/sqrt(d)`` in f32, the
    experts ``N(0,1)/sqrt(d_in)`` in the model's type."""
    device = resolve_device(device)
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    router = torch.randn((d, e), generator=generator, device=device,
                         dtype=torch.float32).mul_(d ** -0.5)
    up = _experts(e, d, f, d ** -0.5, dt, generator, device)
    down = _experts(e, f, d, f ** -0.5, dt, generator, device)
    gate = (_experts(e, d, f, d ** -0.5, dt, generator, device)
            if cfg.act in ("swiglu", "geglu") else None)
    return MoELayer(router, up, down, gate)


def _init_moe_block(cfg: MoEConfig, generator, device) -> MoEBlock:
    dt = cfg.dtype
    return MoEBlock(L.init_norm(cfg.d_model, dt, device=device),
                    T._init_attention(cfg, generator, device),
                    init_moe_layer(cfg, generator, device),
                    L.init_norm(cfg.d_model, dt, device=device))


def init_moe_lm(cfg: MoEConfig, generator: torch.Generator,
                device=None) -> T.LM:
    """Random parameters on ``device`` from ``generator``: the
    reference's shapes, types and scales (``moe.py:204-226``)."""
    device = resolve_device(device)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=device, dtype=torch.float32
                        ).mul_(0.02).to(cfg.dtype)
    blocks = [_init_moe_block(cfg, generator, device)
              for _ in range(cfg.n_layers)]
    return T.LM(embed, blocks, L.init_norm(cfg.d_model, cfg.dtype,
                                           device=device))


def abstract_moe_params(cfg: MoEConfig) -> T.LM:
    """The parameters on the meta device, nothing drawn
    (``moe.py:226-227``)."""
    return init_moe_lm(cfg, None, device="meta")


def moe_params_from_jax(params_np: Mapping, cfg: MoEConfig,
                        device=None) -> T.LM:
    """The port's LM holding the parameters of
    ``repro.models.moe.init_moe_lm`` (numpy arrays, blocks stacked along
    a leading layer axis)."""
    device = resolve_device(device)
    blocks = []
    for i in range(cfg.n_layers):
        p = T._layer_tensors(params_np["blocks"], i, device)
        m = p["moe"]
        blocks.append(MoEBlock(
            T._norm_of(p["ln1"]), T._attention_of(p["attn"]),
            MoELayer(m["router"], m["up"], m["down"], m.get("gate")),
            T._norm_of(p["ln2"])))
    return T._lm_of(params_np, blocks, device)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
#: the profiler ranges of ``moe_apply``'s stages, in order
STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
          "moe.aux")


def _ranges():
    """A generator that opens a :class:`~repro_torch.spans.span` for each
    stage of :data:`STAGES` in turn, closing the one before, so a
    profiled run can split the layer's device time by stage (with no
    profiler running a range is one flag check)."""
    for name in STAGES:
        with span(name):
            yield


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    """Slots per expert and group (``moe.py:118-119``), a Python int:
    ``max(8, ceil(tk / E) * capacity_factor)``, or ``max(8, tk)`` when a
    group has fewer assignments ``tk`` than experts (decode)."""
    tk, e = tokens_per_group * cfg.top_k, cfg.n_experts
    if tk < e:
        return max(8, tk)
    return int(max(8, -(-tk // e) * cfg.capacity_factor))


def _route(gate_vals, expert_idx, cap: int, e: int):
    """Sort each group's (token, expert) assignments by expert, stably,
    rank them within their expert, and give each kept one its slot in
    ``[E*cap + 1]`` (the last row is the overflow row).  Returns
    ``(e_flat, order, t_sorted, g_sorted, keep, slot, kept)`` [G, Tl*k],
    ``kept`` being ``keep`` in token order."""
    g, tl, k = expert_idx.shape
    tk = tl * k
    dev = expert_idx.device
    e_flat = expert_idx.reshape(g, tk)
    t_flat = torch.arange(tl, device=dev).repeat_interleave(k) \
        .expand(g, tk)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, -1, order)
    t_sorted = torch.gather(t_flat, -1, order)
    g_sorted = torch.gather(gate_vals.reshape(g, tk), -1, order)
    first = torch.searchsorted(e_sorted, e_sorted, right=False)
    rank = torch.arange(tk, device=dev) - first
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank, e * cap)  # overflow row
    kept = torch.empty_like(keep).scatter_(-1, order, keep)
    return e_flat, t_sorted, g_sorted, keep, slot, kept


def _expert_counts(e_flat, e: int) -> torch.Tensor:
    """Assignments per expert, f32 (exact below 2**24 assignments), by
    a scatter-add rather than ``bincount``, whose output size depends
    on the data (the dry run's meta tensors have none)."""
    flat = e_flat.reshape(-1)
    return torch.zeros((e,), dtype=torch.float32, device=flat.device) \
        .index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                        device=flat.device))


def _dispatch(xg, t_sorted, keep, slot, e: int, cap: int):
    """A scatter-set of each kept assignment's token into its slot of
    ``[G, E*cap + 1, d]``, the overflow row cut: ``[G, E, cap, d]``."""
    g, _, d = xg.shape
    tk = t_sorted.shape[1]
    gi = torch.arange(g, device=xg.device)[:, None].expand(g, tk)
    gathered = torch.gather(xg, 1, t_sorted[..., None].expand(g, tk, d)) \
        * keep[..., None].to(xg.dtype)
    buf = torch.zeros((g, e * cap + 1, d), dtype=xg.dtype,
                      device=xg.device).index_put((gi, slot), gathered)
    return buf[:, :e * cap].reshape(g, e, cap, d)


def _combine(out_buf, slot, t_sorted, w, tl: int):
    """Each assignment's output, weighted by its gate, scatter-added into
    its token: ``[G, Tl, d]`` in the outputs' type."""
    g, e, cap, d = out_buf.shape
    tk = slot.shape[1]
    dev = out_buf.device
    gi = torch.arange(g, device=dev)[:, None].expand(g, tk)
    out_ext = torch.cat([out_buf.reshape(g, e * cap, d),
                         torch.zeros((g, 1, d), dtype=out_buf.dtype,
                                     device=dev)], dim=1)
    picked = torch.gather(out_ext, 1, slot[..., None].expand(g, tk, d)) \
        * w[..., None].to(out_buf.dtype)
    return torch.zeros((g, tl, d), dtype=out_buf.dtype, device=dev) \
        .index_put((gi, t_sorted), picked, accumulate=True)


def _group_placements(cfg: MoEConfig, mesh, g: int):
    """The group dimension's placements: sharded over the data-parallel
    axes when ``tp_axis`` is set and there are several groups (the
    reference's ``shard_map`` over dp), else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    grouped = cfg.tp_axis is not None and g > 1
    return tuple(Shard(0) if grouped and n in cfg.dp_axes
                 else Replicate() for n in mesh.mesh_dim_names)


def _sharded_route(cfg, xg, router, k: int, cap: int, e: int):
    """The router, ``topk``, :func:`_route` and :func:`_expert_counts`
    in ``local_map`` over the groups (``searchsorted`` has no DTensor
    sharding rule, and DTensor's backward of the router product leaves
    a strided sharding the group reshape cannot undo): each rank routes
    its own groups against the whole router.  Returns ``_route``'s
    outputs, ``expert_idx`` and the gates' sum over groups and tokens
    and the expert counts, both ``Partial`` over the group-sharded
    axes (the router's gradient likewise)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xg.device_mesh
    gp = _group_placements(cfg, mesh, xg.shape[0])
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                 for pl in gp)

    def local(xl, rl):
        gates = torch.softmax(torch.einsum("gtd,de->gte", xl.float(), rl),
                              dim=-1)
        gate_vals, expert_idx = torch.topk(gates, k, dim=-1)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
        out = _route(gate_vals, expert_idx, cap, e)
        return out + (expert_idx, gates.sum(dim=(0, 1)),
                      _expert_counts(out[0], e))

    xg = xg.redistribute(mesh, gp)
    router = router.redistribute(mesh, rep)
    return local_map(local, out_placements=(gp,) * 7 + (part, part),
                     in_placements=(gp, rep),
                     in_grad_placements=(gp, part))(xg, router)


def _local(fn, placements, *tensors):
    """``fn`` in ``local_map`` with every input and the output at the
    group placements ``placements``."""
    from torch.distributed.tensor.experimental import local_map
    mesh = tensors[0].device_mesh
    tensors = [t.redistribute(mesh, placements) for t in tensors]
    return local_map(fn, out_placements=list(placements),
                     in_placements=(placements,) * len(tensors))(*tensors)


def moe_apply(p: MoELayer, x: torch.Tensor, cfg: MoEConfig,
              routing: Optional[List[dict]] = None):
    """x [T, d] -> (y [T, d] in x's type, aux loss f32 scalar)
    (``moe.py:59-197``).  ``routing``, when given, receives one dict per
    call: ``expert_idx [G, Tl, k]`` and ``keep [G, Tl, k]`` (whether each
    assignment found a slot), in token order.

    Sharded (a DTensor ``x`` under ``mesh_compat.use_mesh``): the groups
    are constrained to ``P(dp, None, None)`` (``moe.py:94-98``), the
    routing, dispatch and combine run in ``local_map`` over the groups,
    sharded over dp when ``tp_axis`` is set and ``G > 1`` (the
    reference's ``shard_map``, ``moe.py:144-186``), and the capacity
    buffer is constrained to ``P(dp, tp, None, None)`` under ``ep`` or
    ``P(dp, None, None, None)`` under ``tp``; the expert GEMMs run
    through DTensor."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = cfg.dispatch_groups if t % max(cfg.dispatch_groups, 1) == 0 else 1
    tl = t // g
    cap = capacity(tl, cfg)
    sharded = active_device_mesh() is not None and is_dtensor(x)
    dp = tuple(cfg.dp_axes) or None
    xg = x.reshape(g, tl, d)
    if cfg.tp_axis is not None and g > 1:
        xg = constrain(xg, P(dp, None, None))
    ranges = _ranges()

    next(ranges)                                               # moe.route
    if sharded:
        gp = _group_placements(cfg, x.device_mesh, g)
        (e_flat, t_sorted, g_sorted, keep, slot, kept, expert_idx, gsum,
         counts) = _sharded_route(cfg, xg, L.fsdp_gather(p.router, dp), k,
                                  cap, e)
    else:
        gates = torch.softmax(torch.einsum("gtd,de->gte", xg.float(),
                                           p.router), dim=-1)  # [G, Tl, E]
        gate_vals, expert_idx = torch.topk(gates, k, dim=-1)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
        e_flat, t_sorted, g_sorted, keep, slot, kept = _route(
            gate_vals, expert_idx, cap, e)

    next(ranges)                                            # moe.dispatch
    if sharded:
        buf = _local(lambda a, b, c, s_: _dispatch(a, b, c, s_, e, cap),
                     gp, xg, t_sorted, keep, slot)
    else:
        buf = _dispatch(xg, t_sorted, keep, slot, e, cap)
    if cfg.tp_axis is not None:
        # one group (a decode of B=1) is not split over dp: DTensor's
        # products over a group dimension of 1 sharded 16 ways fail
        gdp = dp if g > 1 else None
        buf = constrain(buf, P(gdp, cfg.tp_axis, None, None)
                        if cfg.moe_mode == "ep" else P(gdp, None, None, None))

    # the grouped GEMM over experts
    next(ranges)                                             # moe.experts
    up = torch.einsum("gecd,edf->gecf", buf, L.fsdp_gather(p.up, dp))
    if p.gate is not None:
        # SiLU for swiglu and geglu alike, as the reference (moe.py:170)
        h = F.silu(torch.einsum("gecd,edf->gecf", buf,
                                L.fsdp_gather(p.gate, dp))) * up
    else:
        h = F.gelu(up, approximate="tanh")       # jax.nn.gelu's default
    out_buf = torch.einsum("gecf,efd->gecd", h, L.fsdp_gather(p.down, dp))

    next(ranges)                                             # moe.combine
    w = g_sorted * keep
    if sharded:   # the reverse all-to-all: the buffer back to the groups
        y = _local(lambda o, s_, ts, w_: _combine(o, s_, ts, w_, tl), gp,
                   out_buf, slot, t_sorted, w)
    else:
        y = _combine(out_buf, slot, t_sorted, w, tl)

    # Switch-style load-balance loss
    next(ranges)                                                 # moe.aux
    if sharded:
        me = gsum / (g * tl)
    else:
        me = gates.mean(dim=(0, 1))
        counts = _expert_counts(e_flat, e)
    ce = counts / (t * k)
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)
    if routing is not None:
        routing.append(dict(expert_idx=expert_idx.detach(),
                            keep=kept.reshape(g, tl, k)))
    ranges.close()
    return y.reshape(t, d), aux


# ---------------------------------------------------------------------------
# the MoE stack
# ---------------------------------------------------------------------------
def _moe_block(cfg: MoEConfig, p: MoEBlock, x: torch.Tensor, positions,
               kv=None, kv_len: int = 0, impl: str = "kernel",
               routing: Optional[List[dict]] = None, sharded: bool = False):
    """``moe.py:230-238``: attention, then the MoE FFN (no parallel
    block); returns (x, aux, (k, v)).  ``sharded`` as in the dense
    block (``transformer._block``)."""
    lay, _ = T._layout(cfg, sharded)  # the batch layout, as the dense block
    x = lay(x)
    h = lay(T._norm(cfg, p.ln1, x))
    with span("moe.attention"):
        a, kv_out = T._attention(cfg, p.attn, h, positions, kv, kv_len,
                                 impl, sharded)
    mid = x + lay(a)
    # a DTensor's tokens are flattened from the batch rows of each rank
    h2 = lay(T._norm(cfg, p.ln2, mid))
    b, s, d = h2.shape
    y, aux = moe_apply(p.moe, h2.reshape(b * s, d), cfg, routing)
    return mid + y.reshape(b, s, d), aux, kv_out


def _train_block(cfg: MoEConfig, p: MoEBlock, x: torch.Tensor,
                 positions: torch.Tensor, sharded: bool):
    """One layer of training: ``blocked_attention`` (K4 has no
    backward); returns (x, aux)."""
    y, aux, _ = _moe_block(cfg, p, x, positions, impl="plain",
                           sharded=sharded)
    return y, aux


def moe_train_forward(cfg: MoEConfig, params: T.LM, batch, *,
                      device=None) -> torch.Tensor:
    """batch ``{"tokens", "labels"}`` [B,S] -> the chunked CE plus the
    router losses' mean over layers, f32 (``moe.py:241-264``).  With
    ``cfg.remat`` each block keeps only its input and recomputes the
    routing in the backward (``topk`` on equal inputs routes the same
    tokens)."""
    tokens = T._on(params, batch["tokens"], device)
    labels = T._labels(batch["labels"], tokens)
    positions = T._positions(tokens)
    x = T._lookup(cfg, params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    sharded = is_dtensor(x)
    for p in params.blocks:
        if sharded:
            x = T._constrain_act(cfg, x)
        if cfg.remat:
            x, aux = checkpoint(_train_block, cfg, p, x, positions, sharded,
                                use_reentrant=False)
        else:
            x, aux = _train_block(cfg, p, x, positions, sharded)
        aux_total = aux_total + aux
    loss = T.chunked_ce(cfg, params, x, labels)
    return loss + aux_total / cfg.n_layers


@serving
def moe_prefill(cfg: MoEConfig, params: T.LM, tokens, *,
                impl: str = "kernel", device=None,
                routing: Optional[List[dict]] = None):
    """tokens [B,S] -> (last-token logits [B,V] f32, cache (k, v)
    [L,B,Hkv,S,dh]) (``moe.py:267-279``); K4 once per layer on the card.
    ``routing`` receives each layer's routing (:func:`moe_apply`)."""
    def layer(cfg, p, x, positions, impl, sharded):
        y, _, kv = _moe_block(cfg, p, x, positions, impl=impl,
                              routing=routing, sharded=sharded)
        return y, kv
    return T._prefill(cfg, params, tokens, impl, device, layer)


@serving
def moe_decode_step(cfg: MoEConfig, params: T.LM, token, cache,
                    kv_len: int, *, device=None):
    """token [B,1] against the cache (k, v) [L,B,Hkv,Smax,dh] ->
    (logits [B,1,V] f32, cache), written in place at ``kv_len``
    (``moe.py:282-294``)."""
    def layer(cfg, p, x, positions, kv, kv_len, sharded):
        y, _, kv = _moe_block(cfg, p, x, positions, kv=kv, kv_len=kv_len,
                              sharded=sharded)
        return y, kv
    return T._decode(cfg, params, token, cache, kv_len, device, layer)
