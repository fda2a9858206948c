"""The port's AdamW and LR schedules (``repro_torch.optim``) against
``repro.optim``, on the CPU.

The same seeded numpy parameters and gradients go through both
packages' ``adamw_update`` for several steps, with the clip binding
(``grad_clip=1.0`` against gradients of global norm ~10) and off
(``grad_clip=inf``), on f32 and bf16 leaves.

Tolerances.  f32: rtol=1e-5 on parameters and moments (the same ops in
the same order; what differs is where XLA and PyTorch fuse a multiply
into an add), atol=1e-7 for elements near 0.  bf16 parameters: one bf16
step (rtol=2**-7) after each of 4 steps, since one f32 rounding on
either side of a bf16 boundary moves the cast by a step; the f32
moments to 1e-5 as above.  Schedules: rtol=1e-6 (both in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import schedules as JS
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, linear_warmup)
from repro_torch.optim.adamw import global_norm, named_leaves

SHAPES = {"w": (24, 16), "b": (16,), "table": (300, 8)}
STEPS = 4
F32_TOL = dict(rtol=1e-5, atol=1e-7)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, scale):
    rng = np.random.default_rng((11, step))
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _f32(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, float("inf")])
def test_adamw_update_matches_the_reference(dtype, clip):
    jcfg = JA.AdamWConfig(lr=1e-2, grad_clip=clip)
    cfg = AdamWConfig(lr=1e-2, grad_clip=clip)
    p0 = _np_params()
    jp = {k: jnp.asarray(v).astype(_jax_dtype(dtype)) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p0.items()}
    js, ts = JA.adamw_init(jp), adamw_init(tp)
    for step in range(STEPS):
        g = _grads(step, scale=3.0)
        jg = {k: jnp.asarray(v).astype(_jax_dtype(dtype))
              for k, v in g.items()}
        # copies: adamw_update uses its f32 gradients up, and jnp.asarray
        # may alias the numpy buffer that JAX reads asynchronously
        tg = {k: torch.tensor(v, dtype=getattr(torch, dtype))
              for k, v in g.items()}
        jp, js, jn = JA.adamw_update(jg, js, jp, jcfg)
        tp2, ts2, tn = adamw_update(tg, ts, tp, cfg)
        assert tp2 is tp and ts2 is ts       # written in place
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, dtype)
            ptol = F32_TOL if dtype == "float32" else dict(rtol=2**-7,
                                                           atol=1e-7)
            np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), **ptol,
                                       err_msg=f"{k} step {step}")
            for mom in ("mu", "nu"):
                assert ts[mom][k].dtype == torch.float32
                np.testing.assert_allclose(
                    _f32(ts[mom][k]), _f32(js[mom][k]), rtol=1e-5,
                    atol=1e-7, err_msg=f"{mom} {k} step {step}")


def test_clip_binds_and_off_does_not():
    """With grad_clip=1 the update sees g / |g|; with inf it sees g."""
    g = _grads(0, scale=3.0)
    norm = float(global_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    want = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                       for v in g.values()))
    np.testing.assert_allclose(norm, want, rtol=1e-6)
    assert norm > 1.0
    for clip, factor in ((1.0, 1.0 / norm), (float("inf"), 1.0)):
        p = {k: torch.zeros(s) for k, s in SHAPES.items()}
        st = adamw_init(p)
        adamw_update({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                     st, p, AdamWConfig(grad_clip=clip))
        np.testing.assert_allclose(st["mu"]["w"].numpy(),
                                   0.1 * g["w"] * factor, rtol=1e-5)


def test_state_mirrors_the_parameters():
    lin = torch.nn.Linear(4, 3)
    st = adamw_init(lin)
    assert set(st) == {"mu", "nu", "step"}
    assert list(st["mu"]) == list(st["nu"]) == ["weight", "bias"]
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    for k, p in named_leaves(lin).items():
        assert st["mu"][k].shape == p.shape
        assert st["mu"][k].dtype == torch.float32


def test_mismatched_grads_raise_before_any_write():
    p = {"a": torch.ones(3), "b": torch.ones(2)}
    st = adamw_init(p)
    with pytest.raises(ValueError):
        adamw_update({"a": torch.ones(3)}, st, p, AdamWConfig())
    assert int(st["step"]) == 0 and torch.equal(p["a"], torch.ones(3))


def test_update_allocates_no_leaf_sized_gradient_copy():
    """A float32 gradient is used up in place: its storage ends holding
    the denominator, so a big table takes one temporary, not six."""
    p = {"t": torch.randn(64, 8)}
    g = {"t": torch.randn(64, 8)}
    ptr = g["t"].data_ptr()
    adamw_update(g, adamw_init(p), p, AdamWConfig())
    assert g["t"].data_ptr() == ptr and bool((g["t"] > 0).all())


@pytest.mark.parametrize("warmup,total", [(0, 20), (5, 20), (10, 10)])
def test_schedules_match_the_reference(warmup, total):
    for step in range(0, 2 * total + 1):
        np.testing.assert_allclose(
            float(linear_warmup(step, warmup, 3e-4)),
            float(JS.linear_warmup(step, warmup, 3e-4)), rtol=1e-6)
        np.testing.assert_allclose(
            float(cosine_schedule(step, warmup, total, 3e-4)),
            float(JS.cosine_schedule(step, warmup, total, 3e-4)),
            rtol=1e-6, err_msg=f"step {step}")
    # a tensor step stays a tensor on its device, in f32
    out = cosine_schedule(torch.tensor(7), warmup, total, 1.0)
    assert out.dtype == torch.float32 and out.dim() == 0
