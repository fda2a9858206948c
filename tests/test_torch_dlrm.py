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
from repro_torch.models.dlrm import (CRITEO_1TB_VOCABS, DLRMConfig, _interact,
                                     dlrm_forward, dlrm_loss,
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
