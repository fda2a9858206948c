"""The port's ``CompressedReducer`` against the reference's
(``repro.optim.compression``) bit for bit, with the five properties of
``tests/test_compression.py`` ported: the same gradients, made from a
seed with numpy, go through both."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim.compression import CompressedReducer as JReducer
from repro_torch.optim.compression import CompressedReducer


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((64, 32)) * scale).astype(np.float32),
            "b": (rng.standard_normal((32,)) * scale).astype(np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
            tree.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        want = np.asarray(ref[k])
        got = _np(port[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _both(g, rounds=1, reduce_fn=None, jreduce_fn=None):
    """``rounds`` of reduce on both sides; each round's outputs and
    residuals held bit for bit; returns the port's outputs."""
    cr, jr = CompressedReducer(torch.bfloat16), JReducer(jnp.bfloat16)
    st, jst = cr.init_state(_torch(g)), jr.init_state(
        {k: jnp.asarray(v) for k, v in g.items()})
    outs = []
    for _ in range(rounds):
        out, st = cr.reduce(_torch(g), st, reduce_fn)
        jout, jst = jr.reduce({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jreduce_fn)
        _same(out, jout)
        _same(st, jst)
        outs.append(out)
    return outs, st


class TestCompression:
    def test_wire_dtype(self):
        g = _grads(0)
        cr, jr = CompressedReducer(torch.bfloat16), JReducer(jnp.bfloat16)
        wires, resid = cr.compress(_torch(g), cr.init_state(_torch(g)))
        jw, jres = jr.compress({k: jnp.asarray(v) for k, v in g.items()},
                               jr.init_state(g))
        assert all(w.dtype == torch.bfloat16 for w in wires.values())
        _same(wires, jw)
        _same(resid, jres)

    def test_single_round_error_bounded(self):
        g = _grads(1)
        (out,), _ = _both(g)
        for k in g:
            np.testing.assert_allclose(out[k].numpy(), g[k], rtol=1e-2,
                                       atol=1e-2)

    def test_error_feedback_unbiased_over_time(self):
        """With a CONSTANT gradient, error feedback makes the time-average
        of the compressed stream converge to the true gradient."""
        g = {k: (v * np.float32(1 + 2 ** -10)).astype(np.float32)
             for k, v in _grads(2, scale=1e-3).items()}
        n = 64
        outs, _ = _both(g, rounds=n)
        for k in g:
            total = sum(o[k] for o in outs)
            err = np.abs(total.numpy() / n - g[k]).max()
            scale = np.abs(g[k]).max()
            assert err < 2e-4 * max(scale, 1e-6) + 1e-8, err

    def test_residual_carries_information(self):
        g = _grads(3, scale=1e-4)
        _, st = _both(g)
        assert any(t.abs().max() > 0 for t in st.values())

    def test_with_reduce_fn(self):
        g = _grads(4)
        (out,), _ = _both(
            g, reduce_fn=lambda t: {k: x * 0.5 for k, x in t.items()},
            jreduce_fn=lambda t: {k: x * 0.5 for k, x in t.items()})
        for k in g:
            np.testing.assert_allclose(out[k].numpy(), g[k] * 0.5,
                                       rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_nested_state_matches_the_reference(scale):
    """Nested mappings of gradients (a module's and a table's) over three
    rounds, at three scales, bit for bit."""
    g = _grads(5, scale)
    cr, jr = CompressedReducer(), JReducer()
    tree = {"mlp": _torch(g), "t": _torch(g)["b"]}
    jtree = {"mlp": {k: jnp.asarray(v) for k, v in g.items()},
             "t": jnp.asarray(g["b"])}
    st, jst = cr.init_state(tree), jr.init_state(jtree)
    for _ in range(3):
        out, st = cr.reduce(tree, st)
        jout, jst = jr.reduce(jtree, jst)
        _same(out["mlp"], jout["mlp"])
        _same({"t": out["t"]}, {"t": jout["t"]})
        _same({"t": st["t"]}, {"t": jst["t"]})
