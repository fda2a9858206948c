"""Dense GQA transformer LM (command-r-plus-104b / command-r-35b /
starcoder2-7b); counterpart of ``repro.models.transformer``'s serving
path: :func:`prefill` (the causal forward returning the KV cache) and
:func:`decode_step` (one token against the cache).

The parameters are one :class:`LM` module whose attribute names are the
reference pytree's keys: ``embed [V, d]``, ``blocks`` (one
:class:`Block` per layer: ``ln1``, ``attn.{wq,wk,wv,wo}``, ``mlp``,
``ln2`` unless ``parallel_block``) and ``final_norm``.  The reference
stacks its blocks along a leading layer axis for ``lax.scan``; the port
keeps a list and loops, and :func:`lm_params_from_jax` splits the stack.

Prefill's attention is K4 with the model's sliding window, launched once
per layer on the card (``layers.gqa_attention``); on the CPU it runs
``layers.blocked_attention``, the reference's own math.  Decode's
attention is plain (``decode_ref``), as the reference's is.  Unlike the
reference's pure functions, :func:`decode_step` writes the new token's K
and V into the cache it is given, in place, and returns that cache.

Training is :func:`train_forward`: the causal stack with
``blocked_attention`` (K4 has no backward; neither has the reference's
Pallas kernel, whose model trains through ``blocked_attention_xla``),
each block recomputed in the backward when ``cfg.remat``
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``), and
:func:`chunked_ce`, the loss over sequence chunks of the tied logits.
The parameters are built with ``requires_grad=False``; a train step
turns it on, and :func:`prefill` and :func:`decode_step` run under
``torch.inference_mode`` (``no_grad`` for DTensor parameters), so
serving never records a graph.

Every entry point takes ``device=None``, meaning the CUDA card, and
raises without one unless ``device="cpu"`` is passed.

Sharded execution: the parameters may be DTensors (``configs.base.
distribute_params``), the tokens too.  Every op then runs through
DTensor, whose sharding propagation picks the collectives, and
attention runs inside ``local_map`` (``layers.gqa_attention``).  Under
``mesh_compat.use_mesh`` the sharding fields of :class:`LMConfig` place
the activations as the reference's constraints do: the training carry
at ``P(dp, sp, None)`` before each layer, the loss chunk's logits at
``P(dp, None, tp)``; without a mesh they change nothing.
:func:`abstract_lm_params` builds the parameters on the meta device.
A sharded decode gathers each layer's cache over the sequence (see
:func:`_decode_attention`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ref import decode_ref
from repro_torch.models import layers as L
from repro_torch.models.mesh_compat import (constrain, is_dtensor,
                                            replicate_as, serving,
                                            sharded_rows)

__all__ = ["LMConfig", "LM", "Block", "Attention", "init_lm",
           "abstract_lm_params", "lm_params_from_jax", "prefill",
           "decode_step", "train_forward", "chunked_ce"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's fields (``transformer.py:24-47``), so that configs
    compare field by field.  ``remat`` recomputes each block and each
    loss chunk in the backward of :func:`train_forward` (it is inert
    when serving).  ``dp_axes``, ``tp_axis`` and ``sp_axis`` name mesh
    axes (``registry.get_arch(name, axes)`` binds them); they act only
    on DTensor activations under an active mesh."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    norm: str = "rmsnorm"
    parallel_block: bool = False   # command-r family: attn + mlp in parallel
    use_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None   # starcoder2: sliding-window attention
    tie_embeddings: bool = True
    remat: bool = True
    param_dtype: str = "bfloat16"
    ce_chunk: int = 256
    dp_axes: tuple = ()
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None

    def __post_init__(self):
        if self.param_dtype not in _DTYPES:
            raise ValueError(f"{self.name}: param_dtype {self.param_dtype!r} "
                             f"is not one of {tuple(_DTYPES)}")

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def n_params(self) -> int:
        d, f, v, h = self.d_model, self.d_ff, self.vocab, self.d_head
        attn = d * h * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * h * d
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        return self.n_layers * (attn + glu * d * f) + v * d


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, wq: L.Dense, wk: L.Dense, wv: L.Dense, wo: L.Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


class Block(nn.Module):
    """``ln1``, ``attn``, ``mlp`` and, unless the block is parallel,
    ``ln2``."""

    def __init__(self, ln1: L.Norm, attn: Attention, mlp: L.MLP,
                 ln2: Optional[L.Norm] = None):
        super().__init__()
        self.ln1, self.attn, self.mlp, self.ln2 = ln1, attn, mlp, ln2


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks: Sequence[Block],
                 final_norm: L.Norm):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _init_attention(cfg: LMConfig, generator: torch.Generator,
                    device) -> Attention:
    dt, h = cfg.dtype, cfg.d_head
    kw = dict(generator=generator, device=device)
    return Attention(
        L.init_dense(cfg.d_model, cfg.n_heads * h, cfg.use_bias, dt, **kw),
        L.init_dense(cfg.d_model, cfg.n_kv_heads * h, cfg.use_bias, dt, **kw),
        L.init_dense(cfg.d_model, cfg.n_kv_heads * h, cfg.use_bias, dt, **kw),
        L.init_dense(cfg.n_heads * h, cfg.d_model, cfg.use_bias, dt, **kw))


def _init_block(cfg: LMConfig, generator: torch.Generator,
                device) -> Block:
    dt = cfg.dtype
    attn = _init_attention(cfg, generator, device)
    return Block(L.init_norm(cfg.d_model, dt, device=device), attn,
                 L.init_mlp(cfg.d_model, cfg.d_ff, cfg.act, cfg.use_bias, dt,
                            generator=generator, device=device),
                 None if cfg.parallel_block
                 else L.init_norm(cfg.d_model, dt, device=device))


def init_lm(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Random parameters on ``device``, drawn there from ``generator``
    (which must live on that device): the reference's shapes, types and
    scales (``transformer.py:58-96``): dense ``N(0, 1) / sqrt(d_in)``,
    zero biases, unit norms, the embedding ``N(0, 0.02^2)``."""
    device = resolve_device(device)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=device, dtype=torch.float32
                        ).mul_(0.02).to(cfg.dtype)
    blocks = [_init_block(cfg, generator, device)
              for _ in range(cfg.n_layers)]
    return LM(embed, blocks, L.init_norm(cfg.d_model, cfg.dtype,
                                         device=device))


def abstract_lm_params(cfg: LMConfig) -> LM:
    """The parameters' shapes and types on the meta device: nothing is
    allocated and nothing drawn (``transformer.py:102-104``)."""
    return init_lm(cfg, None, device="meta")


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 ones as ``ml_dtypes.bfloat16``) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _layer_tensors(tree: Mapping, i: int, device) -> dict:
    """Layer ``i`` of a reference pytree stacked along a leading layer
    axis, as tensors on ``device``."""
    return {k: _layer_tensors(v, i, device) if isinstance(v, Mapping) else
            _tensor(np.asarray(v)[i], device) for k, v in tree.items()}


def _dense_of(p: Mapping) -> L.Dense:
    return L.Dense(p["w"], p.get("b"))


def _norm_of(p: Mapping) -> L.Norm:
    return L.Norm(p["scale"], p.get("bias"))


def _attention_of(a: Mapping) -> Attention:
    return Attention(*(_dense_of(a[k]) for k in ("wq", "wk", "wv", "wo")))


def _lm_of(params_np: Mapping, blocks, device) -> LM:
    """An :class:`LM` of ``blocks`` with the reference's embedding and
    final norm."""
    final = {k: _tensor(v, device)
             for k, v in params_np["final_norm"].items()}
    return LM(_tensor(params_np["embed"], device), blocks, _norm_of(final))


def lm_params_from_jax(params_np: Mapping, cfg: LMConfig,
                       device=None) -> LM:
    """The port's :class:`LM` holding the parameters of
    ``repro.models.transformer.init_lm`` (a pytree of numpy arrays whose
    ``blocks`` are stacked along a leading layer axis of ``n_layers``)."""
    device = resolve_device(device)
    blocks = []
    for i in range(cfg.n_layers):
        p = _layer_tensors(params_np["blocks"], i, device)
        m = p["mlp"]
        blocks.append(Block(
            _norm_of(p["ln1"]), _attention_of(p["attn"]),
            L.MLP(_dense_of(m["up"]), _dense_of(m["down"]),
                  _dense_of(m["gate"]) if "gate" in m else None),
            _norm_of(p["ln2"]) if "ln2" in p else None))
    return _lm_of(params_np, blocks, device)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _norm(cfg: LMConfig, p: L.Norm, x: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(p, x) if cfg.norm == "rmsnorm" else L.layer_norm(p, x)


def _attention(cfg: LMConfig, p: Attention, x: torch.Tensor,
               positions: torch.Tensor, kv=None, kv_len: int = 0,
               impl: str = "kernel", sharded: bool = False):
    """x [B,S,d] (``transformer.py:111-138``).  kv: optional (k_cache,
    v_cache) [B,Hkv,Smax,dh] for decode, into which this call writes its
    K and V at ``kv_len``; returns (out [B,S,d], (k, v)): the K and V of
    these tokens in prefill, the updated caches in decode.  ``sharded``:
    x, the parameters and the caches are DTensors (see :func:`_block`)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lay, dp = _layout(cfg, sharded)
    q = lay(L.dense(p.wq, x, dp)).reshape(b, s, h, dh).transpose(1, 2)
    k = lay(L.dense(p.wk, x, dp)).reshape(b, s, hkv, dh).transpose(1, 2)
    v = lay(L.dense(p.wv, x, dp)).reshape(b, s, hkv, dh).transpose(1, 2)
    q = L.rope(q, positions[:, None, :], cfg.rope_theta)
    k = L.rope(k, positions[:, None, :], cfg.rope_theta)
    if kv is None:
        o = L.gqa_attention(q, k, v, causal=True, window=cfg.window,
                            impl=impl, batch_axes=cfg.dp_axes)
    elif sharded:
        o = _decode_attention(cfg, q, k, v, kv, kv_len)
        k, v = kv
    else:
        kc, vc = kv
        kc[:, :, kv_len:kv_len + s] = k
        vc[:, :, kv_len:kv_len + s] = v
        o = decode_ref(q, kc, vc, kv_len + s, window=cfg.window)
        k, v = kc, vc
    o = o.to(x.dtype)  # the cache's type may differ (an f32 cache)
    o = _merge_heads(o, sharded)
    return L.dense(p.wo, o, dp), (k, v)


def _batch_only(cfg: LMConfig, t: torch.Tensor) -> torch.Tensor:
    """A DTensor [B, ...] with the batch sharded over ``dp_axes`` and
    nothing else; any other tensor as it is.  Used on a projection
    [B,S,H*dh] (every head whole on each rank, as the attention needs
    it: 36 or 48 heads do not split over 16 ranks) and on a block's
    normed input (the sequence-sharded carry gathered before the
    products: DTensor's choice of a product's strategy for an input
    sharded twice takes a minute on a 2x16x16 mesh), and on a
    row-parallel product's output (its gradient then reaches the product
    batch-sharded: some PyTorch releases refuse to flatten a
    sequence-sharded gradient into the product's rows)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    dp = [n in cfg.dp_axes for n in mesh.mesh_dim_names]
    ranks = 1
    for i, d in enumerate(dp):
        ranks *= mesh.size(i) if d else 1
    # a batch the dp ranks do not divide (B=1) stays whole, as the
    # reference's B=1 cells place it
    split = t.shape[0] % ranks == 0
    pl = [Shard(0) if d and split else Replicate() for d in dp]
    return t if list(t.placements) == pl else t.redistribute(mesh, pl)


def _as_is(t: torch.Tensor) -> torch.Tensor:
    return t


def _layout(cfg: LMConfig, sharded: bool):
    """(the layout a block's tensors are brought to, the axes its weights
    are gathered over): :func:`_batch_only` and ``cfg.dp_axes`` when the
    block runs on DTensors, else nothing to do."""
    if sharded:
        return (lambda t: _batch_only(cfg, t)), cfg.dp_axes
    return _as_is, ()


def _merge_heads(o: torch.Tensor, sharded: bool) -> torch.Tensor:
    """[B,H,S,dh] -> [B,S,H*dh].  A DTensor (batch-sharded, heads whole)
    is merged inside ``local_map``, whose backward brings the gradient
    back to these placements before the split into heads: DTensor
    cannot split a dimension sharded 16 ways into 36 heads."""
    b, h, s, dh = o.shape
    if not sharded:
        return o.transpose(1, 2).reshape(b, s, h * dh)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(o.placements)
    return local_map(lambda t: t.transpose(1, 2).reshape(t.shape[0], s,
                                                         h * dh),
                     out_placements=list(pl), in_placements=(pl,))(o)


def _decode_attention(cfg: LMConfig, q, k, v, kv, kv_len: int):
    """Decode against a DTensor cache (one layer's ``[B,Hkv,Smax,dh]``,
    the sequence sharded over tp, or over every axis at B = 1): the
    layer's cache is gathered over the sequence (kept sharded over the
    batch as the cache is), the token's K and V written at ``kv_len``,
    ``decode_ref`` run inside ``local_map`` with the heads whole, and
    the updated shard copied back into the caller's cache.  The gather
    is this layout's cost: the reference leaves the same choice to
    GSPMD."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    kc, vc = kv
    mesh = kc.device_mesh
    keep_b = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
              for pl in kc.placements]
    s = q.shape[2]
    kv_pl = tuple(keep_b)

    def attend(ql, kl, vl, kcl, vcl):
        kcl = kcl.clone()
        vcl = vcl.clone()
        kcl[:, :, kv_len:kv_len + s] = kl
        vcl[:, :, kv_len:kv_len + s] = vl
        return (decode_ref(ql, kcl, vcl, kv_len + s, window=cfg.window),
                kcl, vcl)

    ins = [t.redistribute(mesh, keep_b) for t in (q, k, v, kc, vc)]
    o, kn, vn = local_map(attend, out_placements=(kv_pl, kv_pl, kv_pl),
                          in_placements=(kv_pl,) * 5)(*ins)
    for cache, new in ((kc, kn), (vc, vn)):
        cache.to_local().copy_(
            new.redistribute(mesh, cache.placements).to_local())
    return o


def _block(cfg: LMConfig, p: Block, x: torch.Tensor, positions, kv=None,
           kv_len: int = 0, impl: str = "kernel", sharded: bool = False):
    """One layer of prefill or decode (the bodies of ``transformer.py``'s
    scans): returns (x, (k, v)).  ``sharded`` says that the layer runs
    on DTensors: each entry point asks once (``is_dtensor`` of its
    embedded tokens) and passes the answer down."""
    # under a mesh the block runs in the batch layout: the carry is
    # gathered over the sequence, and each row-parallel product's partial
    # sums are reduced into that layout, so that every residual add and
    # its gradient are batch-sharded too
    lay, dp = _layout(cfg, sharded)
    x = lay(x)
    h = lay(_norm(cfg, p.ln1, x))
    a, kv_out = _attention(cfg, p.attn, h, positions, kv, kv_len, impl,
                           sharded)
    a = lay(a)
    if cfg.parallel_block:
        return x + a + lay(L.mlp(p.mlp, h, cfg.act, dp)), kv_out
    mid = x + a
    return mid + lay(L.mlp(p.mlp, lay(_norm(cfg, p.ln2, mid)), cfg.act,
                           dp)), kv_out


def _train_block(cfg: LMConfig, p: Block, x: torch.Tensor,
                 positions: torch.Tensor, sharded: bool) -> torch.Tensor:
    """One layer of the training forward: ``blocked_attention``, never
    K4, whose kernel has no backward."""
    return _block(cfg, p, x, positions, impl="plain", sharded=sharded)[0]


def _constrain_act(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """The carry at ``P(dp, sp, None)`` (``transformer.py:152-158``):
    each layer's remat residual is then S-sharded; the identity without
    a mesh or ``sp_axis``."""
    if cfg.sp_axis is None:
        return x
    from repro_torch.configs.base import P
    return constrain(x, P(cfg.dp_axes or None, cfg.sp_axis, None))


def _stack(cfg: LMConfig, params: LM, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Every layer in turn (``transformer.py:161-175``); with
    ``cfg.remat`` each block keeps only its input for the backward and
    is recomputed there (the reference's ``nothing_saveable`` policy).
    Under a mesh the carry enters each layer sequence-sharded."""
    sharded = is_dtensor(x)
    for p in params.blocks:
        if sharded:
            x = _constrain_act(cfg, x)
        if cfg.remat:
            x = checkpoint(_train_block, cfg, p, x, positions, sharded,
                           use_reentrant=False)
        else:
            x = _train_block(cfg, p, x, positions, sharded)
    return x


def _embed(cfg: LMConfig, params: LM) -> torch.Tensor:
    """The embedding, gathered over the data-parallel axes when it is a
    DTensor (``layers.fsdp_gather``)."""
    return L.fsdp_gather(params.embed, cfg.dp_axes)


def _lookup(cfg: LMConfig, params: LM, tokens) -> torch.Tensor:
    """The embedding rows of ``tokens``: an index, or for a DTensor
    embedding ``mesh_compat.sharded_rows`` (vocab-parallel, the rows
    kept sharded over tp), all-reduced over tp into the batch-sharded
    layout (else every later product would see a ``Partial`` input, and
    DTensor would gather its weight whole)."""
    table = _embed(cfg, params)
    if is_dtensor(table):   # the rows' partial sums reduced at once
        return _batch_only(cfg, sharded_rows(table, tokens))
    return table[tokens]


def _logits(cfg: LMConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    """The final norm, then logits against the tied embedding in f32:
    both operands upcast, as ``preferred_element_type=float32`` sums the
    exact products of bf16 values in f32."""
    x = _norm(cfg, params.final_norm, x)
    return torch.einsum("bsd,vd->bsv", x.float(),
                        _embed(cfg, params).float())


def _ce_chunk(cfg: LMConfig, params: LM, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """The summed negative log-likelihood of one chunk: the logits in the
    parameters' type (an f32 product here would make the cotangent of x
    f32 through the whole backward, ``transformer.py:195-198``), the
    softmax and the CE in f32."""
    h = _norm(cfg, params.final_norm, x)
    logits = torch.einsum("bsd,vd->bsv", h, _embed(cfg, params))
    if cfg.tp_axis is not None:           # transformer.py:201-204
        from repro_torch.configs.base import P
        logits = constrain(logits, P(cfg.dp_axes or None, None,
                                     cfg.tp_axis))
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    # a vocab-sharded DTensor is gathered for the pick: DTensor's rule
    # for a gather along a sharded dimension fails on 3-D indices
    picked = torch.gather(_batch_only(cfg, logits32), -1,
                          labels.clamp_min(0)[..., None])[..., 0]
    return torch.sum((lse - picked) * (labels != -1))


def chunked_ce(cfg: LMConfig, params: LM, x: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Sequence-chunked cross-entropy (``transformer.py:184-216``): x
    [B,S,d], labels [B,S] (``-1`` ignored) -> the mean NLL in f32 over
    chunks of ``min(cfg.ce_chunk, S)`` positions, so only one chunk's
    logits [B,c,V] exist at a time.  As in the reference, the last ``S
    mod c`` positions are left out when c does not divide S."""
    x = _batch_only(cfg, x)    # a sequence-sharded carry is gathered
    b, s, _ = x.shape
    c = min(cfg.ce_chunk, s)
    n = s // c
    labels = labels.long()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        xi, li = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if cfg.remat:
            nll = nll + checkpoint(_ce_chunk, cfg, params, xi, li,
                                   use_reentrant=False)
        else:
            nll = nll + _ce_chunk(cfg, params, xi, li)
    cnt = (labels[:, :n * c] != -1).sum()
    return nll / cnt.clamp_min(1)


def _on(params: LM, tokens, device) -> torch.Tensor:
    """``tokens`` as an int64 tensor on ``device``, where ``params`` must
    already be."""
    device = resolve_device(device)
    if params.device != device:
        raise ValueError(f"LM parameters are on {params.device}, the call "
                         f"asks for {device}")
    if is_dtensor(tokens):
        return tokens.to(torch.int64)
    return torch.as_tensor(tokens).to(device, torch.int64)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    """``arange(S)`` per row of tokens [B, S] (replicated over the mesh
    of DTensor tokens)."""
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    return replicate_as(pos, tokens)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def train_forward(cfg: LMConfig, params: LM, batch, *,
                  device=None) -> torch.Tensor:
    """batch ``{"tokens", "labels"}`` [B,S] -> the mean next-token loss
    in f32, differentiable in the parameters (``transformer.py:
    219-225``).  Attention is ``blocked_attention`` on every device."""
    tokens = _on(params, batch["tokens"], device)
    labels = _labels(batch["labels"], tokens)
    positions = _positions(tokens)
    x = _lookup(cfg, params, tokens)
    x = _stack(cfg, params, x, positions)
    return chunked_ce(cfg, params, x, labels)


def _labels(labels, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(labels):
        return labels
    return torch.as_tensor(labels).to(tokens.device)


@serving
def prefill(cfg: LMConfig, params: LM, tokens, *, impl: str = "kernel",
            device=None) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """tokens [B,S] -> (last-token logits [B,V] f32, cache (k, v)
    [L,B,Hkv,S,dh]) (``transformer.py:228-248``).  ``impl="plain"`` runs
    K4's plain version (``layers.blocked_attention``) on the card too,
    for comparison."""
    return _prefill(cfg, params, tokens, impl, device, _block)


def _prefill(cfg: LMConfig, params: LM, tokens, impl: str, device,
             layer: Callable):
    """The causal stack of :func:`prefill`, each layer run by ``layer(cfg,
    p, x, positions, impl=impl, sharded=) -> (x, (k, v))``: ``_block``
    here, the MoE block in ``models.moe``."""
    tokens = _on(params, tokens, device)
    b, s = tokens.shape
    positions = _positions(tokens)
    x = _lookup(cfg, params, tokens)
    if is_dtensor(x):       # DTensors are stacked, not written into
        kvs = []
        for p in params.blocks:
            x, kv = layer(cfg, p, x, positions, impl=impl, sharded=True)
            kvs.append(kv)
        return (_logits(cfg, params, x[:, -1:, :])[:, 0],
                (torch.stack([k for k, _ in kvs]),
                 torch.stack([v for _, v in kvs])))
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.d_head)
    ks = torch.empty(shape, dtype=x.dtype, device=x.device)
    vs = torch.empty_like(ks)
    for i, p in enumerate(params.blocks):
        x, (ks[i], vs[i]) = layer(cfg, p, x, positions, impl=impl,
                                  sharded=False)
    return _logits(cfg, params, x[:, -1:, :])[:, 0], (ks, vs)


@serving
def decode_step(cfg: LMConfig, params: LM, token, cache, kv_len: int, *,
                device=None):
    """token [B,1]; cache (k, v) [L,B,Hkv,Smax,dh]; kv_len the tokens
    already in it -> (logits [B,1,V] f32, cache) (``transformer.py:
    251-270``).  The token's K and V are written into ``cache`` in place
    at ``kv_len``, and the same tensors are returned."""
    return _decode(cfg, params, token, cache, kv_len, device, _block)


def _decode(cfg: LMConfig, params: LM, token, cache, kv_len: int, device,
            layer: Callable):
    """One token through the stack against the cache, each layer run by
    ``layer(cfg, p, x, positions, kv=, kv_len=, sharded=) -> (x,
    cache)``."""
    token = _on(params, token, device)
    kc, vc = cache
    kv_len = int(kv_len)
    if kv_len + token.shape[1] > kc.shape[3]:
        raise ValueError(f"decode_step: the cache holds {kc.shape[3]} "
                         f"positions, {kv_len} are taken")
    b = token.shape[0]
    positions = replicate_as(torch.full((b, 1), kv_len, dtype=torch.int64,
                                        device=token.device), token)
    x = _lookup(cfg, params, token)
    sharded = is_dtensor(x)
    for i, p in enumerate(params.blocks):
        x, _ = layer(cfg, p, x, positions, kv=(kc[i], vc[i]), kv_len=kv_len,
                     sharded=sharded)
    return _logits(cfg, params, x), (kc, vc)
