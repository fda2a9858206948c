"""LM serving demo: prefill + batched KV-cache decode for a dense or a
MoE LM (counterpart of ``repro.launch.lm_demo``).

    PYTHONPATH=src python -m repro_torch.launch.lm_demo --arch starcoder2-7b \\
        --batch 4 --prompt-len 8192 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.lm_demo --device cpu \\
        --width reduced --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.lm_demo --device cpu \\
        --arch qwen3-moe-235b-a22b --batch 2 --prompt-len 32 --gen 8

The reference always serves the reduced config, because it runs on a
CPU.  The port serves the published widths on the card (``--width
full``, the default there) and the reduced config on the CPU (the
default with ``--device cpu``).  Weights are random, drawn on the device
from ``torch.Generator`` seed 0; the prompt is
``data.synthetic.lm_batch`` (step 0), as in the reference.

The run prints prefill ms, decode ms per token (the host clock around
work that ends in ``torch.cuda.synchronize``, after one untimed prefill
and decode step at the same shapes), K4's launches in the timed prefill
(one per layer on the card), for a MoE the share of (token, expert)
assignments its timed prefill dropped at capacity, and the peak device
memory (``max_memory_allocated``), and :func:`main` returns them.  A
MoE (family ``moe``, a ``MoEConfig``) is served by ``moe_prefill`` and
``moe_decode_step``, as the reference's ``lm_demo.py:37-40`` does.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                       kernel_info)
from repro_torch.models.moe import MoEConfig, moe_decode_step, moe_prefill
from repro_torch.models.transformer import (LM, LMConfig, decode_step,
                                            prefill)

__all__ = ["main", "serve", "LM_ARCHS"]

#: The archs the reference's demo takes (``lm_demo.py:26-28``).
LM_ARCHS = tuple(a for a in ARCH_NAMES if "moe" in a or "command" in a
                 or "starcoder" in a or "grok" in a)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: LMConfig, params: LM, *, batch: int, prompt_len: int,
          gen: int, device=None) -> dict:
    """Prefill a ``[batch, prompt_len]`` prompt, then decode ``gen``
    tokens greedily against a bf16 cache of ``prompt_len + gen``
    positions (``lm_demo.py:46-68``).  One untimed prefill and decode
    step at the same shapes go first, so that the clock reads neither
    the process's first call at these shapes nor the allocator's growth.
    Returns the timings, K4's launches in the timed prefill, its logits,
    the peak memory and the generated ids; for a MoE also the timed
    prefill's routing (``moe_apply``'s, one entry per layer) and the
    share of its assignments dropped at capacity."""
    device = resolve_device(device)
    moe = isinstance(cfg, MoEConfig)
    run_prefill = moe_prefill if moe else prefill
    run_decode = moe_decode_step if moe else decode_step
    on_card = device.type == "cuda"
    if on_card:
        kernel_info(cfg.dtype, cfg.d_head)  # K4 built before the clock
        torch.cuda.reset_peak_memory_stats(device)
    b, s = batch, prompt_len
    prompt = lm_batch(0, b, s, cfg.vocab)["tokens"]
    smax = s + gen
    kc = torch.zeros((cfg.n_layers, b, cfg.n_kv_heads, smax, cfg.d_head),
                     dtype=torch.bfloat16, device=device)
    vc = torch.zeros_like(kc)
    logits, cache = run_prefill(cfg, params, prompt,
                                device=device)  # warm-up
    del cache
    if gen:
        run_decode(cfg, params, logits.argmax(-1)[:, None], (kc, vc), s,
                    device=device)
    launches = flash_attention.launches
    _sync(device)
    routing = [] if moe else None
    kw = dict(routing=routing) if moe else {}
    t0 = time.perf_counter()
    logits, cache = run_prefill(cfg, params, prompt, device=device, **kw)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    k4 = flash_attention.launches - launches
    print(f"prefill[{b}x{s}]: {prefill_ms:.1f} ms, K4 launches {k4}")
    dropped = None
    if moe:
        kept = sum(int(r["keep"].sum()) for r in routing)
        total = sum(r["keep"].numel() for r in routing)
        dropped = 1.0 - kept / total
        print(f"moe: {dropped:.6f} of the prefill's {total} (token, expert) "
              "assignments dropped at capacity")

    kc[:, :, :, :s] = cache[0]
    vc[:, :, :, :s] = cache[1]
    del cache
    tok = logits.argmax(-1)[:, None]
    outs = [tok[:, 0]]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(gen):
        lg, (kc, vc) = run_decode(cfg, params, tok, (kc, vc), s + i,
                                  device=device)
        tok = lg[:, 0].argmax(-1)[:, None]
        outs.append(tok[:, 0])
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(gen, 1)
    ids = torch.stack(outs, 1).cpu().numpy()
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    print(f"decode: {decode_ms:.2f} ms/token/batch ({gen} steps, batch {b})")
    print("peak memory: " + (f"{peak / 1e9:.2f} GB" if peak is not None
                             else "not measured (CPU)"))
    print("sample token ids:", ids[0][:12].tolist())
    return dict(arch=cfg.name, n_layers=cfg.n_layers, batch=b,
                prompt_len=s, gen=gen, prefill_ms=prefill_ms,
                decode_ms_per_token=decode_ms, k4_launches=k4,
                peak_bytes=peak, token_ids=ids, prefill_logits=logits,
                last_logits=lg[:, 0] if gen else logits, routing=routing,
                dropped_share=dropped)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-7b", choices=LM_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--width", choices=("full", "reduced"), default=None,
                    help="the published config or the reduced one "
                         "(default: full on the card, reduced on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    width = args.width or ("full" if device.type == "cuda" else "reduced")
    cfg = arch.cfg if width == "full" else arch.reduced_cfg
    print(f"{cfg.name} ({width} width, {cfg.n_layers} layers, "
          f"{cfg.n_params / 1e9:.2f} B parameters) on {device}")
    params = arch.init_params(cfg, torch.Generator(device).manual_seed(0),
                              device)
    return serve(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, device=device)


if __name__ == "__main__":
    main()
