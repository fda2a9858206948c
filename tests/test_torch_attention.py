"""The port's attention (K4's wrapper and the public ops) against
``repro``'s.

The same numpy-seeded q, k, v go through the reference's Pallas kernel
(interpret mode, 64-row tiles, as its own tests run it) and through the
port's wrapper on the CPU, which runs the plain version: f32 to
atol=2e-3, the tolerance of the reference's own kernel tests (online
softmax against one pass), and bf16 to atol=1e-2 (p rounded to bf16 at
another running max; 0.0039 is the largest difference seen, on outputs
of up to 3.0).  Shapes that are not a multiple of the TPU tile
make the Pallas kernel return NaN; there the port is held against
``gqa_ref``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import decode_ref as j_decode_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import gqa_ref as j_gqa_ref
from repro_torch.kernels.flash_attention import (attention, decode_attention,
                                                 decode_ref, flash_attention,
                                                 flash_attention_plain)

CASES = [(1, 2, 2, 128, 128, 64, True), (2, 4, 2, 256, 256, 64, True),
         (1, 8, 2, 128, 256, 128, True), (1, 2, 1, 64, 64, 32, False)]


def _qkv(b, hq, hkv, sq, sk, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(dtype),
            rng.standard_normal((b, hkv, sk, d)).astype(dtype),
            rng.standard_normal((b, hkv, sk, d)).astype(dtype))


def _port(arrays, dtype=torch.float32, **kw):
    return attention(*(torch.from_numpy(a).to(dtype) for a in arrays),
                     device="cpu", **kw)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_matches_the_pallas_kernel(b, hq, hkv, sq, sk, d, causal):
    qkv = _qkv(b, hq, hkv, sq, sk, d, b + sq)
    want = np.asarray(j_flash(*map(jnp.asarray, qkv), causal=causal, bq=64,
                              bk=64))
    got = _port(qkv, causal=causal).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3)
    # the plain path is the reference's oracle
    np.testing.assert_allclose(
        _port(qkv, causal=causal, impl="plain").numpy(),
        np.asarray(j_gqa_ref(*map(jnp.asarray, qkv), causal=causal)),
        atol=1e-5)


def test_bf16_matches_the_pallas_kernel():
    q, k, v = _qkv(1, 2, 2, 64, 64, 64, 9)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, bq=32, bk=32), np.float32)
    got = attention(*(torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (jq, jk, jv)), device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def test_rows_with_no_visible_key_match_the_pallas_kernel():
    # Sq > Sk: the first Sq - Sk rows see no key; the TPU kernel's -1e30
    # mask makes them the uniform average of V, where gqa_ref gives NaN
    qkv = _qkv(1, 2, 1, 128, 64, 32, 21)
    want = np.asarray(j_flash(*map(jnp.asarray, qkv), causal=True, bq=64,
                              bk=64))
    assert np.isfinite(want).all()
    got = _port(qkv, causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(got[0, :, :64],
                               np.broadcast_to(qkv[2].mean(axis=2),
                                               (2, 64, 32)), atol=1e-5)
    assert np.isnan(_port(qkv, causal=True, impl="plain").numpy()[0, :,
                                                                  :64]).all()


@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (72, 200, True),
                                          (100, 100, False)])
def test_shapes_off_the_tile_match_gqa_ref(sq, sk, causal):
    qkv = _qkv(1, 4, 2, sq, sk, 32, sq + sk)
    want = np.asarray(j_gqa_ref(*map(jnp.asarray, qkv), causal=causal))
    np.testing.assert_allclose(_port(qkv, causal=causal).numpy(), want,
                               atol=2e-3)


@pytest.mark.parametrize("kv_len", [1, 37, 64])
def test_decode_matches_the_reference(kv_len):
    q, k, v = _qkv(2, 8, 2, 1, 64, 32, kv_len)
    want = np.asarray(j_decode_ref(*map(jnp.asarray, (q, k, v)), kv_len))
    got = decode_attention(*map(torch.from_numpy, (q, k, v)), kv_len,
                           device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    want_w = np.asarray(j_decode_ref(*map(jnp.asarray, (q, k, v)), kv_len,
                                     window=16))
    got_w = decode_ref(*map(torch.from_numpy, (q, k, v)), kv_len,
                       window=16).numpy()
    np.testing.assert_allclose(got_w, want_w, atol=1e-5)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 64, 64, 16, 2))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_plain(q, k, v))
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 8, 8, 16, 3))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="fit"):
        flash_attention(q, k, v[..., :8])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="impl"):
        attention(q, k, v, impl="pallas", device="cpu")


def test_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the ops would use it")
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 1, 8, 8, 16, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attention(q, k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_attention(q[:, :, :1], k, v, 8)
