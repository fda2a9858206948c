"""Public attention ops (counterpart of
``repro.kernels.flash_attention.ops``).

``attention(..., impl="kernel")``, the default, goes through the wrapper
of the CUDA kernel (:func:`~repro_torch.kernels.flash_attention.kernel.
flash_attention`); ``impl="plain"`` is the oracle ``gqa_ref``.
``decode_attention`` is plain, as in the reference.  Both take
``device=None``, meaning the CUDA card, and raise without one unless
``device="cpu"`` is passed; the inputs are moved there.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import decode_ref, gqa_ref

__all__ = ["attention", "decode_attention", "IMPLS"]

IMPLS = ("kernel", "plain")


def attention(q, k, v, *, causal: bool = True, window=None,
              impl: str = "kernel", device=None) -> torch.Tensor:
    """GQA attention; q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D]; ``window``: the
    causal mask's sliding window (``impl="plain"`` has none, as
    ``gqa_ref``)."""
    if impl not in IMPLS:
        raise ValueError(f"attention: impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    device = resolve_device(device)
    q, k, v = (torch.as_tensor(t).to(device) for t in (q, k, v))
    if impl == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window)
    if window is not None:
        raise ValueError("attention: impl='plain' (gqa_ref) takes no window")
    return gqa_ref(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, kv_len,
                     device=None) -> torch.Tensor:
    """One-token decode against a (possibly over-allocated) KV cache."""
    device = resolve_device(device)
    q, k_cache, v_cache = (torch.as_tensor(t).to(device)
                           for t in (q, k_cache, v_cache))
    return decode_ref(q, k_cache, v_cache, kv_len)
