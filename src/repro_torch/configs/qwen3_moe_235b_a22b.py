"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B]: 94L d=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, 128 experts top-8.  Counterpart of
``repro.configs.qwen3_moe_235b_a22b`` (``CFG``, ``REDUCED`` and the
expert-parallel ``MOE_MODE``)."""
import dataclasses

from repro_torch.models.moe import MoEConfig

CFG = MoEConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, d_head=128, d_ff=1536, vocab=151936, act="swiglu",
    norm="rmsnorm", parallel_block=False, use_bias=False,
    rope_theta=1_000_000.0, n_experts=128, top_k=8,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=512, n_experts=8, top_k=2)

#: the experts' sharding (``make_lm_arch``'s ``moe_mode``): 'ep' shards the expert axis over the model axis
MOE_MODE = "ep"
