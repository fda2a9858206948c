"""The port's LM serving demo (``repro_torch.launch.lm_demo``) on the
CPU at the reduced widths, and against ``repro.launch.lm_demo``.

The reference's demo serves its reduced config from
``init_lm(jax.random.key(0), cfg)``; here it serves the same config in
float32 (so that greedy decoding cannot flip on a bf16 rounding), and
the port's ``serve`` gets the same parameters through
``lm_params_from_jax``.  Both print the first 12 generated ids of
sequence 0, which must be equal, with a prompt longer than
starcoder2's reduced window.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.launch import lm_demo as j_lm_demo
from repro.models import transformer as JT
from repro_torch.configs.registry import get_arch
from repro_torch.launch import lm_demo
from repro_torch.models.transformer import lm_params_from_jax


@pytest.mark.parametrize("arch", ["starcoder2-7b", "command-r-35b",
                                  "command-r-plus-104b"])
def test_demo_serves_the_reduced_config_on_the_cpu(arch, capsys):
    rec = lm_demo.main(["--arch", arch, "--device", "cpu", "--width",
                        "reduced", "--batch", "2", "--prompt-len", "40",
                        "--gen", "3"])
    out = capsys.readouterr().out
    cfg = get_arch(arch).reduced_cfg
    assert "prefill[2x40]" in out and "ms/token" in out
    assert "peak memory: not measured (CPU)" in out
    assert rec["k4_launches"] == 0            # the CPU runs K4's plain version
    assert rec["peak_bytes"] is None
    assert rec["token_ids"].shape == (2, 4) and rec["n_layers"] == 2
    assert (rec["token_ids"] >= 0).all() and (rec["token_ids"] < cfg.vocab).all()
    assert rec["last_logits"].shape == (2, cfg.vocab)
    assert torch.isfinite(rec["last_logits"]).all()
    assert rec["prefill_ms"] > 0 and rec["decode_ms_per_token"] > 0


def test_demo_defaults_to_the_reduced_width_on_the_cpu(capsys):
    rec = lm_demo.main(["--device", "cpu", "--batch", "1", "--prompt-len",
                        "8", "--gen", "1"])
    assert "reduced width, 2 layers" in capsys.readouterr().out
    assert rec["arch"] == "starcoder2-7b" and rec["n_layers"] == 2


def test_demo_refuses_what_is_not_ported():
    """The demo serves the LMs only: a GNN is refused by its choices (the
    MoEs, ported since, are served: ``tests/test_torch_moe.py``)."""
    with pytest.raises(SystemExit):
        lm_demo.main(["--arch", "schnet", "--device", "cpu"])
    assert set(lm_demo.LM_ARCHS) == {
        "command-r-plus-104b", "command-r-35b", "starcoder2-7b",
        "qwen3-moe-235b-a22b", "grok-1-314b"}


def test_demo_needs_cuda_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the demo would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_demo.main(["--gen", "1"])


def _ids(out: str) -> list:
    line = [l for l in out.splitlines() if l.startswith("sample token ids")]
    return eval(line[-1].split(":", 1)[1])


def test_demo_generates_the_reference_s_tokens(monkeypatch, capsys):
    jcfg = dataclasses.replace(j_get_arch("starcoder2-7b").reduced_cfg,
                               param_dtype="float32")
    monkeypatch.setattr(j_lm_demo, "get_arch", lambda name:
                        types.SimpleNamespace(reduced_cfg=jcfg, family="lm"))
    j_lm_demo.main(["--batch", "2", "--prompt-len", "40", "--gen", "8"])
    want = _ids(capsys.readouterr().out)

    cfg = dataclasses.replace(get_arch("starcoder2-7b").reduced_cfg,
                              param_dtype="float32")
    params = lm_params_from_jax(
        jax.tree.map(np.asarray, JT.init_lm(jax.random.key(0), jcfg)), cfg,
        device="cpu")
    rec = lm_demo.serve(cfg, params, batch=2, prompt_len=40, gen=8,
                        device="cpu")
    assert _ids(capsys.readouterr().out) == want == \
        rec["token_ids"][0][:12].tolist()
    assert 40 > cfg.window
