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
``torch.inference_mode``, so serving never records a graph.

Every entry point takes ``device=None``, meaning the CUDA card, and
raises without one unless ``device="cpu"`` is passed.  The sharding
fields of :class:`LMConfig` come with the sharding pieces.
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

__all__ = ["LMConfig", "LM", "Block", "Attention", "init_lm",
           "lm_params_from_jax", "prefill", "decode_step", "train_forward",
           "chunked_ce"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's fields (``transformer.py:24-47``), so that configs
    compare field by field.  ``remat`` recomputes each block and each
    loss chunk in the backward of :func:`train_forward` (it is inert
    when serving); the sharding fields must keep their defaults."""
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
        if self.dp_axes or self.tp_axis is not None \
                or self.sp_axis is not None:
            raise ValueError(f"{self.name}: the sharding fields (dp_axes, "
                             "tp_axis, sp_axis) are not ported; they must "
                             "keep their defaults")
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
               impl: str = "kernel"):
    """x [B,S,d] (``transformer.py:111-138``).  kv: optional (k_cache,
    v_cache) [B,Hkv,Smax,dh] for decode, into which this call writes its
    K and V at ``kv_len``; returns (out [B,S,d], (k, v)): the K and V of
    these tokens in prefill, the updated caches in decode."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = L.dense(p.wq, x).reshape(b, s, h, dh).transpose(1, 2)
    k = L.dense(p.wk, x).reshape(b, s, hkv, dh).transpose(1, 2)
    v = L.dense(p.wv, x).reshape(b, s, hkv, dh).transpose(1, 2)
    q = L.rope(q, positions[:, None, :], cfg.rope_theta)
    k = L.rope(k, positions[:, None, :], cfg.rope_theta)
    if kv is None:
        o = L.gqa_attention(q, k, v, causal=True, window=cfg.window,
                            impl=impl)
    else:
        kc, vc = kv
        kc[:, :, kv_len:kv_len + s] = k
        vc[:, :, kv_len:kv_len + s] = v
        o = decode_ref(q, kc, vc, kv_len + s, window=cfg.window)
        k, v = kc, vc
    o = o.to(x.dtype)  # the cache's type may differ (an f32 cache)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return L.dense(p.wo, o), (k, v)


def _block(cfg: LMConfig, p: Block, x: torch.Tensor, positions, kv=None,
           kv_len: int = 0, impl: str = "kernel"):
    """One layer of prefill or decode (the bodies of ``transformer.py``'s
    scans): returns (x, (k, v))."""
    h = _norm(cfg, p.ln1, x)
    a, kv_out = _attention(cfg, p.attn, h, positions, kv, kv_len, impl)
    if cfg.parallel_block:
        return x + a + L.mlp(p.mlp, h, cfg.act), kv_out
    mid = x + a
    return mid + L.mlp(p.mlp, _norm(cfg, p.ln2, mid), cfg.act), kv_out


def _train_block(cfg: LMConfig, p: Block, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """One layer of the training forward: ``blocked_attention``, never
    K4, whose kernel has no backward."""
    return _block(cfg, p, x, positions, impl="plain")[0]


def _stack(cfg: LMConfig, params: LM, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Every layer in turn (``transformer.py:161-175``); with
    ``cfg.remat`` each block keeps only its input for the backward and
    is recomputed there (the reference's ``nothing_saveable`` policy)."""
    for p in params.blocks:
        if cfg.remat:
            x = checkpoint(_train_block, cfg, p, x, positions,
                           use_reentrant=False)
        else:
            x = _train_block(cfg, p, x, positions)
    return x


def _logits(cfg: LMConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    """The final norm, then logits against the tied embedding in f32:
    both operands upcast, as ``preferred_element_type=float32`` sums the
    exact products of bf16 values in f32."""
    x = _norm(cfg, params.final_norm, x)
    return torch.einsum("bsd,vd->bsv", x.float(), params.embed.float())


def _ce_chunk(cfg: LMConfig, params: LM, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """The summed negative log-likelihood of one chunk: the logits in the
    parameters' type (an f32 product here would make the cotangent of x
    f32 through the whole backward, ``transformer.py:195-198``), the
    softmax and the CE in f32."""
    h = _norm(cfg, params.final_norm, x)
    logits32 = torch.einsum("bsd,vd->bsv", h, params.embed).float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = torch.gather(logits32, -1,
                          labels.clamp_min(0)[..., None])[..., 0]
    return torch.sum((lse - picked) * (labels != -1))


def chunked_ce(cfg: LMConfig, params: LM, x: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Sequence-chunked cross-entropy (``transformer.py:184-216``): x
    [B,S,d], labels [B,S] (``-1`` ignored) -> the mean NLL in f32 over
    chunks of ``min(cfg.ce_chunk, S)`` positions, so only one chunk's
    logits [B,c,V] exist at a time.  As in the reference, the last ``S
    mod c`` positions are left out when c does not divide S."""
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
    return torch.as_tensor(tokens).to(device, torch.int64)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def train_forward(cfg: LMConfig, params: LM, batch, *,
                  device=None) -> torch.Tensor:
    """batch ``{"tokens", "labels"}`` [B,S] -> the mean next-token loss
    in f32, differentiable in the parameters (``transformer.py:
    219-225``).  Attention is ``blocked_attention`` on every device."""
    tokens = _on(params, batch["tokens"], device)
    labels = torch.as_tensor(batch["labels"]).to(tokens.device)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params.embed[tokens]
    x = _stack(cfg, params, x, positions)
    return chunked_ce(cfg, params, x, labels)


@torch.inference_mode()
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
    p, x, positions, impl=impl) -> (x, (k, v))``: ``_block`` here, the
    MoE block in ``models.moe``."""
    tokens = _on(params, tokens, device)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params.embed[tokens]
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.d_head)
    ks = torch.empty(shape, dtype=x.dtype, device=x.device)
    vs = torch.empty_like(ks)
    for i, p in enumerate(params.blocks):
        x, (ks[i], vs[i]) = layer(cfg, p, x, positions, impl=impl)
    return _logits(cfg, params, x[:, -1:, :])[:, 0], (ks, vs)


@torch.inference_mode()
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
    ``layer(cfg, p, x, positions, kv=, kv_len=) -> (x, cache)``."""
    token = _on(params, token, device)
    kc, vc = cache
    kv_len = int(kv_len)
    if kv_len + token.shape[1] > kc.shape[3]:
        raise ValueError(f"decode_step: the cache holds {kc.shape[3]} "
                         f"positions, {kv_len} are taken")
    b = token.shape[0]
    positions = torch.full((b, 1), kv_len, dtype=torch.int64,
                           device=token.device)
    x = params.embed[token]
    for i, p in enumerate(params.blocks):
        x, _ = layer(cfg, p, x, positions, kv=(kc[i], vc[i]), kv_len=kv_len)
    return _logits(cfg, params, x), (kc, vc)
