"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01]: 40L d=8192 64H
(GQA kv=8) d_ff=22528 vocab=256000 — parallel block, no bias.
Counterpart of ``repro.configs.command_r_35b`` (``CFG`` and ``REDUCED``;
its dry-run cells are ``configs.base.make_lm_arch``'s)."""
import dataclasses

from repro_torch.configs.base import make_lm_arch
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="command-r-35b", n_layers=40, d_model=8192, n_heads=64,
    n_kv_heads=8, d_head=128, d_ff=22528, vocab=256000, act="swiglu",
    norm="layernorm", parallel_block=True, use_bias=False,
    rope_theta=8_000_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512)


def arch(axes=None):
    return make_lm_arch("command-r-35b", CFG, REDUCED, axes=axes)
