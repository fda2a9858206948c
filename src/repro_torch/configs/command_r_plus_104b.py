"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-plus]: 64L d=12288
96H (GQA kv=8) d_ff=33792 vocab=256000 — parallel attn+FFN block, no bias.
Counterpart of ``repro.configs.command_r_plus_104b`` (``CFG`` and
``REDUCED``; its 104 B parameters do not fit one 80 GB card)."""
import dataclasses

from repro_torch.configs.base import make_lm_arch
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_head=128, d_ff=33792, vocab=256000, act="swiglu",
    norm="layernorm", parallel_block=True, use_bias=False,
    rope_theta=75_000_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512)


def arch(axes=None):
    return make_lm_arch("command-r-plus-104b", CFG, REDUCED, axes=axes)
