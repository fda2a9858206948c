"""The port's neural building blocks (``repro_torch.models.layers``)
against ``repro.models.layers``, on the CPU.

The same numpy-seeded inputs and parameters go through both packages in
float32, held to rtol=atol=1e-5 (sums in another order).  Dense layers
also run in bf16, held to one bf16 step of the output (rtol 2**-7):
both round a product accumulated in f32 once, and the bias add once
more.  Attention runs the reference's ``blocked_attention_xla`` and
``gqa_attention`` against the port's ``blocked_attention`` (K4's plain
version on the LM path) and ``gqa_attention`` (which runs it on the
CPU), with and without a sliding window, ragged chunks and GQA groups.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rms_norm_matches_the_reference():
    rng = _rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = L.rms_norm(L.Norm(_t(scale)), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm_matches_the_reference(with_bias):
    rng = _rng(1)
    x = (3 + 2 * rng.standard_normal((2, 5, 96))).astype(np.float32)
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    if with_bias:
        jp["bias"] = jnp.asarray(bias)
    want = JL.layer_norm(jp, jnp.asarray(x))
    got = L.layer_norm(L.Norm(_t(scale), _t(bias) if with_bias else None),
                       _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_has_no_bias_unless_given():
    norm = L.init_norm(32, torch.float32, device=CPU)
    assert norm.bias is None and dict(norm.named_parameters()).keys() == \
        {"scale"}
    x = torch.randn(2, 32)
    with_bias = L.Norm(norm.scale.detach(), torch.full((32,), 0.5))
    torch.testing.assert_close(L.layer_norm(with_bias, x),
                               L.layer_norm(norm, x) + 0.5)


@pytest.mark.parametrize("theta", [1e4, 1e6, 8e6])
def test_rope_matches_the_reference(theta):
    rng = _rng(int(theta) % 97)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    # positions offset, as in decode (the cache already holds 1,000)
    pos = (1000 + np.arange(40))[None, None, :].repeat(2, 0)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_rotates_interleaved_pairs():
    # one pair (x0, x1) at position 1 with theta such that the angle is
    # 1 radian for the first frequency: (cos - sin, sin + cos) on (1, 1)
    x = torch.tensor([[[1.0, 1.0, 0.0, 0.0]]])
    out = L.rope(x, torch.tensor([[1]]), theta=1e4)
    c, s = np.cos(1.0), np.sin(1.0)
    np.testing.assert_allclose(out[0, 0, :2].numpy(), [c - s, s + c],
                               rtol=1e-6)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_the_reference(use_bias, dtype):
    rng = _rng(2 + use_bias)
    x = rng.standard_normal((4, 9, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 80)) / 7).astype(np.float32)
    b = rng.standard_normal(80).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {"w": jnp.asarray(w, jdt)}
    if use_bias:
        jp["b"] = jnp.asarray(b, jdt)
    want = np.asarray(JL.dense(jp, jnp.asarray(x, jdt)), np.float32)
    got = L.dense(L.Dense(_t(w).to(tdt), _t(b).to(tdt) if use_bias
                          else None), _t(x).to(tdt))
    assert got.dtype == tdt                       # the input's type
    tol = TOL if dtype == "float32" else dict(rtol=2**-7, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_init_dense_keeps_the_reference_tree():
    gen = torch.Generator().manual_seed(0)
    d = L.init_dense(64, 32, generator=gen, device=CPU)
    assert d.w.dtype == torch.bfloat16 and d.b is None
    d = L.init_dense(64, 32, True, torch.float32, generator=gen, device=CPU)
    assert d.b.dtype == torch.float32 and not d.b.any()
    assert abs(float(d.w.std()) - 64 ** -0.5) < 0.02


def _mlp_params(rng, act, d=32, f=48):
    p = {"up": {"w": (rng.standard_normal((d, f)) / 6).astype(np.float32)},
         "down": {"w": (rng.standard_normal((f, d)) / 7).astype(np.float32)}}
    if act in ("swiglu", "geglu"):
        p["gate"] = {"w": (rng.standard_normal((d, f)) / 6)
                     .astype(np.float32)}
    return p


@pytest.mark.parametrize("act", L.ACTS)
def test_mlp_matches_the_reference(act):
    rng = _rng(3)
    p = _mlp_params(rng, act)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jp = {k: {"w": jnp.asarray(v["w"])} for k, v in p.items()}
    want = JL.mlp(jp, jnp.asarray(x), act)
    port = L.MLP(L.Dense(_t(p["up"]["w"])), L.Dense(_t(p["down"]["w"])),
                 L.Dense(_t(p["gate"]["w"])) if "gate" in p else None)
    got = L.mlp(port, _t(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_rejects_an_unknown_activation():
    with pytest.raises(ValueError):
        L.init_mlp(8, 16, "tanh", generator=torch.Generator(), device=CPU)


# (B, Hq, Hkv, Sq, Sk, q_chunk, k_chunk): Hq = Hkv and Hq = 3 Hkv; Sq not
# a multiple of q_chunk; Sk not a multiple of k_chunk; a suffix Sq < Sk
ATTN = [(2, 2, 2, 40, 40, 16, 16), (1, 6, 2, 50, 50, 16, 32),
        (1, 3, 1, 24, 70, 16, 16), (2, 4, 4, 33, 33, 1024, 1024)]


def _attn_inputs(b, hq, hkv, sq, sk, seed):
    rng = _rng(seed)
    return (rng.standard_normal((b, hq, sq, 16)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, 16)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, 16)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,qc,kc", ATTN)
def test_blocked_attention_matches_the_reference(b, hq, hkv, sq, sk, qc, kc,
                                                 window):
    q, k, v = _attn_inputs(b, hq, hkv, sq, sk, sq + sk)
    if hq != hkv:
        # the reference takes one head count: repeat K/V for it only
        jk, jv = (np.repeat(a, hq // hkv, axis=1) for a in (k, v))
    else:
        jk, jv = k, v
    want = JL.blocked_attention_xla(jnp.asarray(q), jnp.asarray(jk),
                                    jnp.asarray(jv), causal=True,
                                    window=window, q_chunk=qc, k_chunk=kc)
    got = L.blocked_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, q_chunk=qc, k_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_blocked_attention_without_the_causal_mask():
    q, k, v = _attn_inputs(1, 2, 2, 30, 50, 7)
    want = JL.blocked_attention_xla(*map(jnp.asarray, (q, k, v)),
                                    causal=False, q_chunk=16, k_chunk=16)
    got = L.blocked_attention(_t(q), _t(k), _t(v), causal=False, q_chunk=16,
                              k_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2)])
def test_gqa_attention_matches_the_reference(hq, hkv, window):
    q, k, v = _attn_inputs(2, hq, hkv, 48, 48, hq + (window or 0))
    want = JL.gqa_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                            window=window)
    got = L.gqa_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # on the CPU both implementations are the plain blocked attention
    plain = L.gqa_attention(_t(q), _t(k), _t(v), window=window, impl="plain")
    assert torch.equal(got, plain)


def test_gqa_attention_bf16_matches_the_reference():
    q, k, v = _attn_inputs(1, 6, 2, 40, 40, 5)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(JL.gqa_attention(jq, jk, jv, window=16), np.float32)
    got = L.gqa_attention(*(_t(a).bfloat16() for a in (q, k, v)), window=16)
    assert got.dtype == torch.bfloat16
    # one bf16 step of the output: p rounds to bf16 in both, the rest f32
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=1e-5)


def test_gqa_attention_rejects_an_unknown_impl():
    q, k, v = map(_t, _attn_inputs(1, 2, 2, 8, 8, 0))
    with pytest.raises(ValueError, match="impl"):
        L.gqa_attention(q, k, v, impl="pallas")


# ---------------------------------------------------------------------------
# training: the loss, and K4 refusing a graph it would cut
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_the_reference(dtype):
    """Labels of -1 are ignored; bf16 logits go to f32 first in both, so
    the f32 tolerance holds for both types."""
    rng = _rng(21)
    logits = rng.standard_normal((3, 11, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, -1] = -1
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    want = float(JL.cross_entropy(jl, jnp.asarray(labels)))
    got = L.cross_entropy(_t(logits).to(getattr(torch, dtype)),
                          _t(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, **TOL)


def test_cross_entropy_of_only_ignored_labels_is_zero():
    labels = torch.full((2, 3), -1)
    assert float(L.cross_entropy(torch.randn(2, 3, 7), labels)) == 0.0


def test_cross_entropy_gradient_matches_the_reference():
    import jax
    rng = _rng(22)
    logits = rng.standard_normal((2, 9, 30)).astype(np.float32)
    labels = rng.integers(-1, 30, (2, 9)).astype(np.int32)
    want = jax.grad(lambda x: JL.cross_entropy(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    L.cross_entropy(x, _t(labels)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


def test_blocked_attention_keeps_autograd():
    """The plain version, which training runs, has a backward: its
    gradients match those of the one-pass plain attention."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    q, k, v = (_t(a).requires_grad_(True)
               for a in _attn_inputs(1, 6, 2, 40, 40, 9))
    g = torch.randn(1, 6, 40, 16, generator=torch.Generator().manual_seed(1))
    want = torch.autograd.grad(
        (flash_attention_plain(q, k, v, window=16) * g).sum(), (q, k, v))
    got = torch.autograd.grad(
        (L.blocked_attention(q, k, v, window=16, q_chunk=16, k_chunk=16)
         * g).sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_k4_wrapper_raises_under_grad_mode():
    """K4 has no backward: given an input that requires grad under grad
    mode, the wrapper raises instead of returning an output cut off from
    the graph; under no_grad it runs (here its plain version)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q, k, v = map(_t, _attn_inputs(1, 2, 2, 8, 8, 0))
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
    with torch.inference_mode():
        assert flash_attention(q.detach(), k, v).shape == q.shape
