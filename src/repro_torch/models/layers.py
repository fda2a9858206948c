"""Shared neural building blocks (counterpart of ``repro.models.layers``).

Parameters live in small ``nn.Module``s whose attribute names are the
reference pytree's keys (``Dense``: ``w``, ``b``; ``Norm``: ``scale``,
``bias``; ``MLP``: ``up``, ``down``, ``gate``), and each function takes
the module as the reference takes the dict.  ``w`` keeps the
reference's ``[d_in, d_out]`` layout: ``dense`` computes ``x @ w + b``.

Types follow the reference's mixed-precision contract: parameters and
activations in bf16 by default, norms, rope and softmax in f32 and cast
back, a dense layer's output in its input's type.  A bf16 product on the
card accumulates in f32 (cuBLAS), as the TPU's does.

:func:`gqa_attention` is the attention of the LMs: on a CUDA tensor it
launches K4 (``kernels/flash_attention``, with the sliding window), and
on the CPU it runs :func:`blocked_attention`, the port of
``blocked_attention_xla`` and K4's plain version on this path.
:func:`cross_entropy` is the LM loss, in f32 with an ignore label.

On DTensors (sharded execution) every function runs through DTensor's
ops, but :func:`gqa_attention`, which runs inside ``local_map`` with
the batch sharded over the data-parallel axes and every head whole on
each rank: K4 on the card, :func:`blocked_attention` on the CPU and in
the dry run.  The heads are gathered because the models' head counts
(36, 48, 64, 96 query heads; 4 or 8 KV heads) do not all divide a
16-wide model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.kernel import (NEG_INF,
                                                       flash_attention)
from repro_torch.models.mesh_compat import is_dtensor, replicate_as

__all__ = ["Dtypes", "DEFAULT_DTYPES", "Dense", "Norm", "MLP", "init_dense",
           "dense", "init_norm", "rms_norm", "layer_norm", "rope", "blocked_attention",
           "gqa_attention", "init_mlp", "mlp", "cross_entropy", "ACTS",
           "fsdp_gather",
           "ATTN_IMPLS"]

@dataclasses.dataclass(frozen=True)
class Dtypes:
    """The mixed-precision contract (``layers.py:20-27``): parameters and
    compute in bf16, accumulation in f32."""
    param: torch.dtype = torch.bfloat16
    compute: torch.dtype = torch.bfloat16
    accum: torch.dtype = torch.float32


DEFAULT_DTYPES = Dtypes()

#: The MLP activations of ``layers.py:mlp``.
ACTS = ("swiglu", "geglu", "gelu", "relu", "silu")
#: ``gqa_attention``'s implementations: K4, or its plain version.
ATTN_IMPLS = ("kernel", "plain")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# linear / norm
# ---------------------------------------------------------------------------
class Dense(nn.Module):
    """``w [d_in, d_out]`` and an optional bias ``b [d_out]``."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


def fsdp_gather(w: torch.Tensor, axes) -> torch.Tensor:
    """A DTensor weight replicated over the mesh axes ``axes`` (FSDP's
    all-gather before use; DTensor's own choice for a product with a
    weight sharded on its contraction dimension is to gather the
    activations over the batch instead, and sum the partial products);
    any other tensor as it is."""
    if not axes or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if n in axes else p
          for n, p in zip(names, w.placements)]
    return w if pl == list(w.placements) else \
        w.redistribute(w.device_mesh, pl)


def init_dense(d_in: int, d_out: int, use_bias: bool = False,
               dtype: torch.dtype = torch.bfloat16, *,
               generator: torch.Generator, device) -> Dense:
    """Normal weights (drawn in f32) times ``d_in ** -0.5``, cast to
    ``dtype``; a zero bias with ``use_bias`` (``layers.py:33-40``).
    DLRM's towers take f32 with a bias."""
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32).mul_(d_in ** -0.5).to(dtype)
    b = (torch.zeros((d_out,), dtype=dtype, device=device)
         if use_bias else None)
    return Dense(w, b)


def dense(p: Dense, x: torch.Tensor, gather_axes=()) -> torch.Tensor:
    """``x @ w (+ b)``, in the type of ``x`` and the parameters.  A
    DTensor ``w`` is first gathered over the mesh axes ``gather_axes``
    (the data-parallel axes of an FSDP-sharded weight)."""
    y = x @ fsdp_gather(p.w, gather_axes)
    if p.b is not None:
        y = y + p.b
    return y


class Norm(nn.Module):
    """``scale [d]`` and, for a layer norm with one, ``bias [d]``."""

    def __init__(self, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.scale = _param(scale)
        self.bias = None if bias is None else _param(bias)


def init_norm(d: int, dtype: torch.dtype = torch.bfloat16, *,
              device) -> Norm:
    """A unit scale and no bias, as every LM's norms."""
    return Norm(torch.ones((d,), dtype=dtype, device=device))


def rms_norm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale.float()
    return y.to(x.dtype)


def layer_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """A scale, and a bias only where the module has one, in f32 (not
    ``nn.LayerNorm``, which always carries a bias)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p.scale.float()
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, D] (D even), positions [..., S] -> rotated x.  The pairs
    are interleaved, ``(x[..., 0::2], x[..., 1::2])``, re-stacked after
    the rotation (``layers.py:82-92``), not the half-split of most
    PyTorch code."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    freqs = replicate_as(freqs, positions)
    angles = positions[..., None].float() * freqs          # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 1024,
                      k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over chunks (``blocked_attention_xla``,
    ``layers.py:98-165``): q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] with Hq a
    multiple of Hkv, each q head reading kv head ``h // (Hq / Hkv)``
    through a grouped einsum (K/V never repeated).  Its largest
    intermediate is [B,Hq,q_chunk,k_chunk].

    The reference's rules: scores in f32, masked with ``-1e30`` (the kv
    padding of a ragged last chunk, the causal mask aligned to the end,
    the sliding ``window``); p cast to V's type before P.V, which sums in
    f32; the output ``acc / max(l, 1e-30)`` in q's type.  Every chunk is
    visited, as in the reference.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    n_q, n_k = -(-sq // q_chunk), -(-sk // k_chunk)
    if n_k * k_chunk != sk:
        pad = n_k * k_chunk - sk
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    scale = d ** -0.5
    seq_off = sk - sq              # causal offset (q is the suffix)
    qg = q.reshape(b, hkv, g, sq, d)
    out = torch.empty_like(q).reshape(b, hkv, g, sq, d)
    for qi in range(n_q):
        lo = qi * q_chunk
        qc = qg[:, :, :, lo:lo + q_chunk].float()  # the last may be short
        rows = lo + seq_off + torch.arange(qc.shape[3], device=q.device)
        m = torch.full(qc.shape[:4] + (1,), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, dtype=torch.float32, device=q.device)
        for ki in range(n_k):
            ks = k[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            vs = v[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, ks.float()) * scale
            cols = ki * k_chunk + torch.arange(k_chunk, device=q.device)
            mask = (cols <= sk - 1)[None, :]            # drop kv padding
            if causal:
                mask = mask & (cols[None, :] <= rows[:, None])
            if window is not None:
                mask = mask & (cols[None, :] > rows[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vs.dtype).float(), vs.float())
            m = m_new
        out[:, :, :, lo:lo + q_chunk] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(b, hq, sq, d)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  impl: str = "kernel", batch_axes=()) -> torch.Tensor:
    """GQA attention, q [B,Hq,S,D], k/v [B,Hkv,S,D] (``layers.py:168-184``).
    On a CUDA tensor ``impl="kernel"`` launches K4 with the window;
    ``impl="plain"``, and every call on the CPU, runs
    :func:`blocked_attention`.  K/V are never repeated across a group.

    DTensor inputs are redistributed to B sharded over the mesh axes in
    ``batch_axes`` and replicated over the others (every head whole on
    each rank), and the attention runs inside ``local_map`` on each
    rank's batch rows."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"gqa_attention: impl must be one of {ATTN_IMPLS}, "
                         f"got {impl!r}")
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal, window, impl, batch_axes)
    return _attention_local(q, k, v, causal=causal, window=window,
                            impl=impl)


def _attention_local(q, k, v, *, causal, window, impl):
    if impl == "kernel" and q.device.type != "cpu":
        return flash_attention(q, k, v, causal=causal, window=window)
    return blocked_attention(q, k, v, causal=causal, window=window)


def _sharded_attention(q, k, v, causal, window, impl, batch_axes):
    import functools

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pl = tuple(Shard(0) if n in (batch_axes or ()) else Replicate()
               for n in mesh.mesh_dim_names)
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    fn = local_map(functools.partial(_attention_local, causal=causal,
                                     window=window, impl=impl),
                   out_placements=list(pl), in_placements=(pl, pl, pl))
    return fn(q, k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """``up``, ``down`` and, for the gated activations, ``gate``."""

    def __init__(self, up: Dense, down: Dense, gate: Optional[Dense] = None):
        super().__init__()
        self.up = up
        self.down = down
        self.gate = gate


def init_mlp(d_model: int, d_ff: int, act: str, use_bias: bool = False,
             dtype: torch.dtype = torch.bfloat16, *,
             generator: torch.Generator, device) -> MLP:
    if act not in ACTS:
        raise ValueError(act)
    kw = dict(generator=generator, device=device)
    up = init_dense(d_model, d_ff, use_bias, dtype, **kw)
    down = init_dense(d_ff, d_model, use_bias, dtype, **kw)
    gate = (init_dense(d_model, d_ff, use_bias, dtype, **kw)
            if act in ("swiglu", "geglu") else None)
    return MLP(up, down, gate)


def mlp(p: MLP, x: torch.Tensor, act: str, gather_axes=()) -> torch.Tensor:
    """``layers.py:203-216``; ``jax.nn.gelu`` is the tanh approximation.
    ``gather_axes``: as :func:`dense`'s."""
    up = dense(p.up, x, gather_axes)
    if act == "swiglu":
        up = F.silu(dense(p.gate, x, gather_axes)) * up
    elif act == "geglu":
        up = F.gelu(dense(p.gate, x, gather_axes), approximate="tanh") * up
    elif act == "gelu":
        up = F.gelu(up, approximate="tanh")
    elif act == "relu":
        up = F.relu(up)
    elif act == "silu":
        up = F.silu(up)
    else:
        raise ValueError(act)
    return dense(p.down, up, gather_axes)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """logits [..., V], labels [...] -> the mean negative log-likelihood
    over the labels that are not ``ignore_id``, in f32
    (``layers.py:222-231``); 0 when every label is ignored."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    picked = torch.gather(logits, -1,
                          labels.clamp_min(0)[..., None])[..., 0]
    valid = labels != ignore_id
    return torch.sum((lse - picked) * valid) / valid.sum().clamp_min(1)
