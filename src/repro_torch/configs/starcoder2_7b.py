"""starcoder2-7b [arXiv:2402.19173]: 32L d=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GELU, learned bias, RoPE, 4k sliding-window attention.
Counterpart of ``repro.configs.starcoder2_7b`` (``CFG`` and ``REDUCED``;
its dry-run cells are ``configs.base.make_lm_arch``'s)."""
import dataclasses

from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
    n_kv_heads=4, d_head=128, d_ff=18432, vocab=49152, act="gelu",
    norm="layernorm", parallel_block=False, use_bias=True,
    rope_theta=1_000_000.0, window=4096,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
    d_ff=192, vocab=512, window=32)
