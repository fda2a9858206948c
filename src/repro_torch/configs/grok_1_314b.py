"""grok-1-314b [hf:xai-org/grok-1]: 64L d=6144 48H (GQA kv=8) expert
d_ff=32768 vocab=131072, 8 experts top-2.  Counterpart of
``repro.configs.grok_1_314b`` (``CFG``, ``REDUCED`` and the
TP-in-expert ``MOE_MODE``).
``act="geglu"`` as the reference's config, whose gated MoE FFN applies
SiLU (``models/moe.py``)."""
import dataclasses

from repro_torch.models.moe import MoEConfig

CFG = MoEConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_head=128, d_ff=32768, vocab=131072, act="geglu",
    norm="rmsnorm", parallel_block=False, use_bias=False,
    rope_theta=10_000.0, n_experts=8, top_k=2,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, n_experts=4, top_k=2)

#: the experts' sharding (``make_lm_arch``'s ``moe_mode``): 'tp' keeps the 8 experts whole and shards d_ff over the model axis (8 experts < 16 ranks)
MOE_MODE = "tp"
