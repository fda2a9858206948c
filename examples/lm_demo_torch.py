"""Train a small starcoder2-family LM for a few hundred steps on the
PyTorch/CUDA port, then serve it: prefill and greedy decode from the KV
cache (the counterpart of ``examples/lm_demo.py``, with its flags and
its config: starcoder2-7b's reduced config at ``--d-model`` and
``--layers``, head size 32, vocabulary 2,048, no window).

    PYTHONPATH=src python examples/lm_demo_torch.py --steps 100 \\
        --d-model 256 [--device cpu]

Training runs through ``train_loop`` and AdamW (lr 1e-3) on
``data.synthetic.lm_batch`` of each step, 8 x ``--seq`` tokens.  Serving
prefills a 32-token prompt and decodes 16 tokens into a bf16 cache of
64 positions; on the card the prefill launches K4 once per layer (head
size 32 is one of its head sizes).  Parameters are drawn on the device
from a ``torch.Generator`` of seed 0.  The last line is a JSON summary:
first and last loss, the decoded ids, ms per decoded token and K4's
launches in the prefill.
"""
import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import lm_train_step  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention  # noqa: E402
from repro_torch.models.transformer import (decode_step, init_lm,  # noqa: E402
                                            prefill)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import TrainLoopConfig, train_loop  # noqa: E402

PROMPT = 32
GEN = 16
SMAX = 64


def demo_config(d_model: int, layers: int):
    """``lm_demo.py:33-37``: starcoder2-7b's reduced config cut to
    ``d_model`` and ``layers``."""
    base = get_arch("starcoder2-7b").reduced_cfg
    return dataclasses.replace(
        base, n_layers=layers, d_model=d_model, n_heads=d_model // 32,
        n_kv_heads=max(1, d_model // 64), d_head=32, d_ff=d_model * 4,
        vocab=2048, window=None)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, params, steps: int, seq: int, device):
    """AdamW through ``train_loop`` on 8 x ``seq`` tokens a step; returns
    the trained parameters and the history."""
    step = lm_train_step(cfg, 8, seq, opt_cfg=AdamWConfig(lr=1e-3),
                         device=device)

    def make_batch(s):
        return {k: torch.from_numpy(v).to(device)
                for k, v in lm_batch(s, 8, seq, cfg.vocab).items()}

    t0 = time.perf_counter()
    params, _, hist = train_loop(
        step, params, make_batch,
        TrainLoopConfig(total_steps=steps, log_every=20,
                        checkpoint_dir=None),
        log_fn=lambda r: print(f"step {r['step']:>4} loss {r['loss']:.4f}"))
    if hist:
        print(f"train: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"in {time.perf_counter() - t0:.1f}s")
    return params, hist


def serve(cfg, params, device) -> dict:
    """``lm_demo.py:57-75``: prefill a 32-token prompt, then 16 greedy
    decode steps against a bf16 cache of 64 positions.  Returns the
    ids, ms per decoded token and K4's launches in the prefill."""
    prompt = torch.from_numpy(lm_batch(999, 1, PROMPT, cfg.vocab)["tokens"])
    launches = flash_attention.launches
    logits, cache = prefill(cfg, params, prompt, device=device)
    k4 = flash_attention.launches - launches
    kc = torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, SMAX, cfg.d_head),
                     dtype=torch.bfloat16, device=device)
    vc = torch.zeros_like(kc)
    kc[:, :, :, :PROMPT] = cache[0]
    vc[:, :, :, :PROMPT] = cache[1]
    tok = logits.argmax(-1)[:, None]
    out = [int(tok[0, 0])]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(GEN):
        lg, (kc, vc) = decode_step(cfg, params, tok, (kc, vc), PROMPT + i,
                                   device=device)
        tok = lg[:, 0].argmax(-1)[:, None]
        out.append(int(tok[0, 0]))
    ms = (time.perf_counter() - t0) * 1e3 / GEN
    print(f"serve: decoded {out} ({ms:.1f} ms/token), K4 launches in the "
          f"prefill {k4}")
    return dict(token_ids=out, ms_per_token=ms, k4_launches=k4,
                prefill_logits=logits)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = demo_config(args.d_model, args.layers)
    params = init_lm(cfg, torch.Generator(device).manual_seed(0), device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {n_params / 1e6:.1f}M params on {device}")
    params, hist = train(cfg, params, args.steps, args.seq, device)
    rec = serve(cfg, params, device)
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"lm_demo_torch: a loss is not finite: {losses}")
    summary = dict(device=str(device), n_layers=cfg.n_layers,
                   steps=len(hist), loss_first=losses[0] if losses else None,
                   loss_last=losses[-1] if losses else None,
                   token_ids=rec["token_ids"],
                   ms_per_token=rec["ms_per_token"],
                   k4_launches=rec["k4_launches"])
    print(json.dumps(summary))
    return dict(rec, history=hist, summary=summary)


if __name__ == "__main__":
    main()
