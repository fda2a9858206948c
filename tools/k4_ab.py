#!/usr/bin/env python3
"""Time versions of K4 (the port's flash attention) against each other
on one card, in turns, on the same inputs.

    python3 tools/k4_ab.py [DIR ...]

Each DIR holds a ``flash_attention.cu`` (with the headers it includes),
for example an unpacked ``git archive`` of another commit's
``src/repro_torch/kernels/flash_attention/csrc``.  The checkout's own
source is timed as ``cur``.  Every version is built into its own
library and called through its C entry point, in the order cur, DIR...,
DIR... reversed, cur, at starcoder2-7b widths (Hq=36, Hkv=4, D=128,
B=1, bf16): causal 4,096², causal 512 × 4,096, full 1,024², causal
8,192².  Each time is ``chip_smoke.time_ms``'s: the CUDA-event median
of 15 launches, each after a 256 MB L2 flush; SDPA is timed beside them, and each version's largest
difference from the plain version is printed (not at 8,192², where the
plain version would not fit).  Needs CUDA and ``nvcc``.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention.bias import causal_lower_right  # noqa: E402

# chip_smoke puts src/ on sys.path
from chip_smoke import SC2_D, SC2_HKV, SC2_HQ, time_ms  # noqa: E402
from repro_torch.kernels._build import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    SOURCE, flash_attention_plain)

CASES = [(4096, 4096, True), (512, 4096, True), (1024, 1024, False),
         (8192, 8192, True)]


def _library(source: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(source)[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
    return lib


def _run(lib, q, k, v, causal):
    out = torch.empty_like(q)
    b, hq, sq, d = q.shape
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        k.shape[1], sq, k.shape[2], d, int(causal), 1, 1.0 / d ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    libs = {"cur": _library(SOURCE)}
    for d in args.dirs:
        libs[str(d)] = _library(d / "flash_attention.cu")
    order = list(libs) + list(libs)[::-1]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for sq, sk, causal in CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((1, SC2_HQ, sq, SC2_D),
                                 (1, SC2_HKV, sk, SC2_D),
                                 (1, SC2_HKV, sk, SC2_D)))
        want = (flash_attention_plain(q, k, v, causal=causal).float()
                if sq * sk <= 4096 * 4096 else None)
        times, errs = {}, {}
        for name in order:
            got = _run(libs[name], q, k, v, causal).float()
            if want is not None:
                errs[name] = float((got - want).abs().max())
            times.setdefault(name, []).append(time_ms(
                lambda: _run(libs[name], q, k, v, causal), flush))
        mask = causal_lower_right(sq, sk) if causal else None
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), flush)
        print(f"Sq={sq} Sk={sk} causal={causal}: " + " ".join(
            f"{n}={t} max_abs_err={errs.get(n)}" for n, t in times.items())
            + f" sdpa={sdpa:.4f}", flush=True)
        del q, k, v, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
