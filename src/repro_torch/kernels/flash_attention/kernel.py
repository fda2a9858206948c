"""Flash attention forward (GQA, causal or full) on the GPU
(counterpart of ``repro.kernels.flash_attention.kernel``).

:func:`flash_attention` launches a hand-written CUDA kernel of
``csrc/flash_attention.cu``, which replaces the Pallas kernel
``flash_attention`` (``kernel.py:68-101``): blocked attention with an
online softmax, f32 running max, normaliser and accumulator, and the
kv head of q head h at ``h // (Hq / Hkv)``.  The inputs' type picks the
kernel: bfloat16 runs on the tensor cores (``wgmma`` for Q.K^T and P.V,
Q, K and V tiles brought by TMA, ``csrc/flash_attention_sm90.cuh``),
float32 on the CUDA cores (TF32 would change the numbers).  Both keep
the TPU kernel's rules:

- a masked score is ``-1e30``, not ``-inf``, so a causal row with no
  visible key (Sq > Sk) is the uniform average of V, where ``gqa_ref``
  gives NaN;
- p is cast to V's type before the P.V product, which accumulates in
  f32; the output is ``acc / max(l, 1e-30)`` in q's type;
- the causal mask is aligned to the end: query row i sees keys
  ``<= i + Sk - Sq``.

Unlike the TPU kernel, which returns NaN when Sq or Sk is not a
multiple of its tile, the CUDA kernel masks the ragged edge.

Beside it is its plain PyTorch version, :func:`flash_attention_plain`,
which computes the same function in one pass.  The wrapper runs the
plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.  It counts its launches in
``flash_attention.launches``.  :func:`kernel_info` names the kernel that
a type and head size launch, with its registers and shared memory.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load

__all__ = ["flash_attention", "flash_attention_plain", "kernel_info",
           "SOURCE", "HEAD_DIMS", "NEG_INF"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: Head sizes the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128)
#: The score of a masked (query, key) pair (``kernel.py:24``).
NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_kernel_info.argtypes = [i, i, p, p]
    lib.flash_attention_kernel_info.restype = ctypes.c_int
    return lib


def kernel_info(dtype: torch.dtype, d: int) -> dict:
    """The kernel that :func:`flash_attention` launches for ``dtype`` and
    head size ``d`` on the card: its name, registers per thread at launch
    and shared memory per CTA in bytes."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    bf16 = dtype == torch.bfloat16
    err = _library().flash_attention_kernel_info(
        d, int(bf16), ctypes.byref(regs), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"flash_attention: no kernel for {dtype}, head "
                           f"size {d} (CUDA error {err})")
    name = ("flash_fwd_sm90 (bf16, wgmma + TMA)" if bf16
            else "flash_fwd_kernel (f32, CUDA cores)")
    return dict(kernel=name, registers=regs.value, shared_bytes=smem.value)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, H, S, D], "
                             f"got {tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_attention: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention: q, k and v must share one "
                             "dtype and one device")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"flash_attention: {hq} q heads are not a multiple "
                         f"of {k.shape[1]} kv heads")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D], Hq % Hkv == 0 -> [B,Hq,Sq,D] in
    q's type (float32 or bfloat16)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, hq, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {d} is not one of "
                         f"{HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} starts at an "
                                 "address that is not 16-byte aligned, "
                                 "which TMA cannot load")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], sq, k.shape[2], d, int(bool(causal)),
            int(q.dtype == torch.bfloat16), 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the whole score matrix
    at once, with the kernel's ``-1e30`` mask, its cast of p to V's type
    and its f32 accumulation.  GQA by a grouped einsum, no repeat."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (1.0 / d ** 0.5)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype).reshape(b, hq, sq, d)
