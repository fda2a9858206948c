"""Plain PyTorch oracles for attention (counterpart of
``repro.kernels.flash_attention.ref``): GQA, causal or full, and
one-token decode against a cache."""
from __future__ import annotations

import math

import torch

__all__ = ["mha_ref", "gqa_ref", "decode_ref"]


def mha_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """q [B,H,Sq,D], k/v [B,H,Sk,D] -> [B,H,Sq,D] (fp32 softmax).  A
    causal row with no visible key is NaN, as in the reference."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, -torch.inf)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)


def gqa_ref(q, k, v, causal: bool = True):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] with Hq % Hkv == 0."""
    group = q.shape[1] // k.shape[1]
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    return mha_ref(q, kx, vx, causal=causal)


def decode_ref(q, k, v, kv_len, window=None):
    """Single-token decode: q [B,Hq,1,D] against cache k/v [B,Hkv,S,D];
    positions >= kv_len are masked (the cache may be over-allocated);
    ``window`` also masks positions < kv_len - window.  GQA via a
    grouped einsum, no k/v repeat."""
    b, hkv, s, d = k.shape
    hq = q.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, q.shape[2], d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    logits = logits / math.sqrt(d)
    pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    kv_len = torch.as_tensor(kv_len, device=q.device)
    mask = pos < kv_len
    if window is not None:
        mask &= pos >= kv_len - window
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(q.dtype), v)
    return out.reshape(b, hq, q.shape[2], d)
