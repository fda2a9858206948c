"""The port's DLRM serving path against ``repro``'s.

The reference's parameters (``init_dlrm(jax.random.key(0), REDUCED)``)
are carried across as numpy arrays by ``dlrm_params_from_jax``; the same
``dlrm_batch`` goes through both forwards.  Logits, loss and retrieval
scores agree to 1e-5: the matmuls add in another order, and the
embedding bags at multi_hot = 1 are exact copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_mlperf as j_configs
from repro.data.synthetic import dlrm_batch as j_dlrm_batch
from repro.models import dlrm as j_dlrm
from repro_torch.configs.dlrm_mlperf import (CFG, REDUCED,
                                             RETRIEVAL_CANDIDATES,
                                             SERVE_CELLS, capped,
                                             serve_step, serving_batch)
from repro_torch.data.synthetic import dlrm_batch
from repro_torch.kernels.embedding_bag import embag
from repro_torch.models import dlrm as t_dlrm
from repro_torch.models.dlrm import (CRITEO_1TB_VOCABS, DLRMConfig, _interact,
                                     _pair_index, dlrm_forward, dlrm_loss,
                                     dlrm_params_from_jax, init_dlrm,
                                     retrieval_score)


@pytest.fixture(scope="module")
def params():
    j_params = j_dlrm.init_dlrm(jax.random.key(0), REDUCED)
    as_np = jax.tree.map(np.asarray, j_params)
    return j_params, dlrm_params_from_jax(as_np, device="cpu")


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_configs_are_the_reference_configs():
    assert CRITEO_1TB_VOCABS == j_dlrm.CRITEO_1TB_VOCABS
    for port, ref in ((CFG, j_configs.CFG), (REDUCED, j_configs.REDUCED)):
        for field in ("n_dense", "vocab_sizes", "embed_dim", "bot_mlp",
                      "top_mlp", "multi_hot", "padded_vocab_sizes",
                      "n_sparse", "n_params"):
            assert getattr(port, field) == getattr(ref, field), field


def test_capped_config_keeps_every_width():
    cap = capped(CFG, 16_000_000)
    assert sum(cap.padded_vocab_sizes) == 84_066_304
    assert sum(cap.padded_vocab_sizes) * 128 * 4 == 43_041_947_648
    assert sum(v > 16_000_000 for v in CFG.vocab_sizes) == 5
    for field in ("n_dense", "embed_dim", "bot_mlp", "top_mlp", "multi_hot",
                  "n_sparse"):
        assert getattr(cap, field) == getattr(CFG, field)
    assert max(cap.vocab_sizes) == 16_000_000
    assert SERVE_CELLS == {"serve_p99": 512, "serve_bulk": 262_144,
                           "retrieval_cand": 1}
    assert RETRIEVAL_CANDIDATES == 1_000_448


@pytest.mark.parametrize("step,batch", [(1, 16), (7, 33)])
def test_dlrm_batch_is_byte_equal(step, batch):
    ref = j_dlrm_batch(step, batch, REDUCED.vocab_sizes, 2, seed=3)
    got = dlrm_batch(step, batch, REDUCED.vocab_sizes, 2, seed=3)
    assert ref.keys() == got.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        assert got[key].tobytes() == ref[key].tobytes()


def test_interaction_pairs_are_in_row_major_order():
    iu, ju = jnp.triu_indices(27, k=1)
    t = torch.triu_indices(27, 27, offset=1)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(iu))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(ju))
    rng = np.random.default_rng(0)
    bottom = rng.standard_normal((5, 16)).astype(np.float32)
    embs = rng.standard_normal((5, 26, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _interact(torch.from_numpy(bottom), torch.from_numpy(embs)).numpy(),
        np.asarray(j_dlrm._interact(jnp.asarray(bottom), jnp.asarray(embs))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("j_impl", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_forward_matches_the_reference(params, j_impl, impl):
    j_params, port = params
    batch = dlrm_batch(1, 16, REDUCED.vocab_sizes)
    want = np.asarray(j_dlrm.dlrm_forward(REDUCED, j_params, _jax(batch),
                                          impl=j_impl))
    before = embag.launches
    got = dlrm_forward(REDUCED, port, batch, impl=impl, device="cpu")
    assert embag.launches == before  # the CPU runs the plain version
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        serve_step(REDUCED, port, batch, impl=impl, device="cpu").numpy(),
        got.numpy())


def test_loss_matches_the_reference(params):
    j_params, port = params
    batch = dlrm_batch(2, 64, REDUCED.vocab_sizes)
    want = float(j_dlrm.dlrm_loss(REDUCED, j_params, _jax(batch)))
    got = float(dlrm_loss(REDUCED, port, batch, device="cpu"))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_retrieval_score_matches_the_reference(params):
    j_params, port = params
    batch = dlrm_batch(3, 1, REDUCED.vocab_sizes)
    cand = np.random.default_rng(4).standard_normal(
        (5000, REDUCED.embed_dim)).astype(np.float32)
    batch = {"dense": batch["dense"], "sparse": batch["sparse"],
             "cand": cand}
    want = np.asarray(j_dlrm.retrieval_score(REDUCED, j_params, _jax(batch)))
    got = retrieval_score(REDUCED, port, batch, device="cpu").numpy()
    assert got.shape == (5000,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_dlrm_draws_the_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    model = init_dlrm(REDUCED, gen, device="cpu")
    ref = jax.eval_shape(lambda: j_dlrm.init_dlrm(jax.random.key(0),
                                                  REDUCED))
    assert [tuple(t.shape) for t in model.tables] == \
        [t.shape for t in ref["tables"]]
    for name in ("bot", "top"):
        layers = getattr(model, name).layers
        assert [(tuple(lp.w.shape), tuple(lp.b.shape)) for lp in layers] == \
            [(lp["w"].shape, lp["b"].shape) for lp in ref[name]["layers"]]
    # tables are N(0, 1) / sqrt(rows)
    big = model.tables[0]
    assert float(big.std()) == pytest.approx(1000 ** -0.5, rel=0.05)
    again = init_dlrm(REDUCED, torch.Generator().manual_seed(0),
                      device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.tables, again.tables))


def test_serving_batch_draws_indices_below_the_cap():
    cfg = DLRMConfig(vocab_sizes=(10**9, 50), embed_dim=8, bot_mlp=(8,),
                     top_mlp=(4, 1))
    batch = serving_batch(capped(cfg, 1000), "serve_p99", 0, device="cpu")
    assert tuple(batch["sparse"].shape) == (512, 2, 1)
    assert int(batch["sparse"][:, 0].max()) < 1000
    assert int(batch["sparse"][:, 1].max()) < 50


def test_entry_points_without_device_need_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    _, port = params
    batch = dlrm_batch(1, 4, REDUCED.vocab_sizes)
    for call in (lambda: dlrm_forward(REDUCED, port, batch),
                 lambda: serve_step(REDUCED, port, batch),
                 lambda: init_dlrm(REDUCED, torch.Generator()),
                 lambda: serving_batch(REDUCED, "serve_p99", 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="parameters are on"):
        dlrm_forward(REDUCED, port, batch, device="meta")


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_stack_matches_the_reference(final_act):
    from repro.models.gnn import common as j_common
    from repro_torch.models.gnn.common import MLPStack, mlp_stack
    from repro_torch.models.layers import Dense
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    ws = [rng.standard_normal((10, 7)).astype(np.float32),
          rng.standard_normal((7, 10)).astype(np.float32)]
    bs = [rng.standard_normal(7).astype(np.float32),
          rng.standard_normal(10).astype(np.float32)]
    j_stack = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                          for w, b in zip(ws, bs)]}
    stack = MLPStack([Dense(torch.from_numpy(w), torch.from_numpy(b))
                      for w, b in zip(ws, bs)])
    np.testing.assert_allclose(
        mlp_stack(stack, torch.from_numpy(x), final_act=final_act).numpy(),
        np.asarray(j_common.mlp_stack(j_stack, jnp.asarray(x),
                                      final_act=final_act)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_forward_pools_every_table_in_one_call(params, monkeypatch, impl):
    j_params, port = params
    calls = []
    real = t_dlrm.embedding_bags

    def counted(*args, **kwargs):
        calls.append(kwargs["out"].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(t_dlrm, "embedding_bags", counted)
    batch = dlrm_batch(4, 16, REDUCED.vocab_sizes)
    want = np.asarray(j_dlrm.dlrm_forward(REDUCED, j_params, _jax(batch),
                                          impl="pallas"))
    got = dlrm_forward(REDUCED, port, batch, impl=impl, device="cpu")
    assert calls == [(16, REDUCED.n_sparse, REDUCED.embed_dim)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pair_index_is_built_once_in_row_major_order():
    cpu = torch.device("cpu")
    index = _pair_index(27, cpu)
    assert _pair_index(27, cpu) is index
    iu, ju = jnp.triu_indices(27, k=1)
    np.testing.assert_array_equal(index.numpy(),
                                  np.asarray(iu) * 27 + np.asarray(ju))
    with torch.inference_mode():
        assert not _pair_index(5, cpu).is_inference()


def test_tables_are_registered_parameters_in_feature_order(params):
    _, port = params
    names = [n for n, _ in port.named_parameters() if n.startswith("table")]
    assert names == [f"table_{i}" for i in range(REDUCED.n_sparse)]
    assert all(t is getattr(port, n) for t, n in zip(port.tables, names))
    assert [t.shape[0] for t in port.tables] == \
        list(REDUCED.padded_vocab_sizes)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _trainable_pair():
    """Fresh parameters (the module fixture's stay frozen for serving)."""
    from repro_torch.configs.base import trainable
    j_params = j_dlrm.init_dlrm(jax.random.key(0), REDUCED)
    port = dlrm_params_from_jax(jax.tree.map(np.asarray, j_params),
                                device="cpu")
    return j_params, port, trainable(port)


def test_loss_gradients_match_jax_grad():
    """Every parameter's gradient, the dense table gradients included,
    against ``jax.grad`` of the reference's loss (its default XLA
    gather): rtol=1e-5, atol=1e-8 (largest difference seen 1.3e-8 on
    gradients of up to 0.03)."""
    from repro_torch.configs.base import value_and_grad
    j_params, port, leaves = _trainable_pair()
    batch = dlrm_batch(3, 64, REDUCED.vocab_sizes)
    jl, jg = jax.value_and_grad(
        lambda p: j_dlrm.dlrm_loss(REDUCED, p, _jax(batch)))(j_params)
    loss, grads = value_and_grad(
        lambda: dlrm_loss(REDUCED, port, batch, device="cpu"), leaves)
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    jg = jax.tree.map(np.asarray, jg)
    for name, g in grads.items():
        if name.startswith("table_"):
            want = jg["tables"][int(name[6:])]
        else:
            tower, _, i, k = name.split(".")
            want = jg[tower]["layers"][int(i)][k]
        assert g.shape == tuple(want.shape)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-8,
                                   err_msg=name)


def test_table_gradient_is_nonzero_exactly_on_the_rows_looked_up():
    from repro_torch.configs.base import value_and_grad
    _, port, leaves = _trainable_pair()
    batch = dlrm_batch(5, 48, REDUCED.vocab_sizes)
    _, grads = value_and_grad(
        lambda: dlrm_loss(REDUCED, port, batch, device="cpu"), leaves)
    for f in range(REDUCED.n_sparse):
        rows = np.zeros(REDUCED.vocab_sizes[f], bool)
        rows[batch["sparse"][:, f].ravel()] = True
        nonzero = (grads[f"table_{f}"] != 0).any(dim=1).numpy()
        np.testing.assert_array_equal(nonzero, rows, err_msg=f"table {f}")


def test_k3_wrappers_raise_when_a_table_requires_grad():
    """K3 writes the interaction's input behind autograd's back: with a
    table that requires grad under grad mode the wrappers raise (and
    the forward with ``impl="kernel"`` with them) instead of leaving the
    tables without a gradient.  Under inference mode, as serving runs,
    they run; the plain path keeps autograd."""
    from repro_torch.kernels.embedding_bag import embag_tables
    _, port, _ = _trainable_pair()
    batch = dlrm_batch(0, 8, REDUCED.vocab_sizes)
    idx = torch.from_numpy(batch["sparse"])
    with pytest.raises(NotImplementedError, match="no backward"):
        embag_tables(port.tables, idx)
    with pytest.raises(NotImplementedError, match="no backward"):
        embag(port.tables[0], idx[:, 0])
    with pytest.raises(NotImplementedError, match="no backward"):
        dlrm_forward(REDUCED, port, batch, impl="kernel", device="cpu")
    with torch.inference_mode():
        served = serve_step(REDUCED, port, batch, device="cpu")
    plain = dlrm_forward(REDUCED, port, batch, impl="plain", device="cpu")
    assert plain.requires_grad
    np.testing.assert_array_equal(plain.detach().numpy(), served.numpy())


def test_training_batch_is_the_train_cell():
    from repro_torch.configs.dlrm_mlperf import TRAIN_CELLS, training_batch
    assert TRAIN_CELLS == {"train_batch": 65_536}
    b = training_batch(REDUCED, 3, batch=32, device="cpu")
    want = dlrm_batch(3, 32, REDUCED.vocab_sizes)
    for k in want:
        np.testing.assert_array_equal(b[k].numpy(), want[k])
