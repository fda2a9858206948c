"""The port's dense LM serving path (``repro_torch.models.transformer``)
against ``repro.models.transformer``, on the CPU, for the ``REDUCED``
configs of the three dense LMs.

The reference's parameters (``init_lm(jax.random.key(0), cfg)``) go
across with ``lm_params_from_jax``.  A 48-token prompt, longer than
starcoder2's reduced ``window=32``, so that the window binds in prefill
and in decode, goes through both prefills; then 8 decode steps are
teacher-forced (the same next token into both packages, so that one
argmax flip cannot cascade), each against the cache of the package's
own prefill.

Tolerances.  With ``param_dtype="float32"``: logits rtol=atol=1e-4,
caches 1e-5 (sums in another order; the largest differences seen are
7e-7 and 2.7e-6).  With the default bf16: logits atol=2e-2 on logits of
up to 0.70 (largest difference seen 0.0078), caches two bf16 steps
(rtol 2**-6) plus atol=3e-2 (largest difference seen 0.031 on values of
up to 4.6, at most 0.018 beyond two steps, on values near 0): the
packages round bf16 at other places (XLA rounds each op of a GELU or a
SiLU; PyTorch once per fused op), and a step's difference in one layer
moves the next layer's inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.models import transformer as JT
from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import transformer as T

LM_ARCHS = ["starcoder2-7b", "command-r-35b", "command-r-plus-104b"]
PROMPT, STEPS = 48, 8
TOLS = {"float32": (dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-5, atol=1e-5)),
        "bfloat16": (dict(rtol=0.0, atol=2e-2), dict(rtol=2**-6, atol=3e-2))}
CPU = torch.device("cpu")


def _f32(a):
    return np.asarray(a, np.float32) if not torch.is_tensor(a) \
        else a.float().numpy()


def _configs(name, dtype):
    jcfg = dataclasses.replace(j_get_arch(name).reduced_cfg,
                               param_dtype=dtype)
    cfg = dataclasses.replace(get_arch(name).reduced_cfg, param_dtype=dtype)
    return jcfg, cfg


_RUNS = {}


def _run(name, dtype):
    """Both packages' prefill and teacher-forced decode outputs for one
    (arch, dtype), computed once per process."""
    if (name, dtype) not in _RUNS:
        _RUNS[name, dtype] = _both(name, dtype)
    return _RUNS[name, dtype]


def _both(name, dtype):
    jcfg, cfg = _configs(name, dtype)
    jp = JT.init_lm(jax.random.key(0), jcfg)
    port = T.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks[:, :PROMPT]))
    tl, tc = T.prefill(cfg, port, toks[:, :PROMPT], device="cpu")
    out = dict(prefill=(jl, jc, tl, tc), decode=[])
    smax = PROMPT + STEPS
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, smax, cfg.d_head)
    jkc = jnp.zeros(shape, jcfg.dtype).at[:, :, :, :PROMPT].set(jc[0])
    jvc = jnp.zeros(shape, jcfg.dtype).at[:, :, :, :PROMPT].set(jc[1])
    tkc = torch.zeros(shape, dtype=cfg.dtype)
    tvc = torch.zeros(shape, dtype=cfg.dtype)
    tkc[:, :, :, :PROMPT], tvc[:, :, :, :PROMPT] = tc
    for i in range(STEPS):
        tok = toks[:, PROMPT + i:PROMPT + i + 1]
        jlg, (jkc, jvc) = JT.decode_step(jcfg, jp, jnp.asarray(tok),
                                         (jkc, jvc),
                                         jnp.int32(PROMPT + i))
        tlg, (tkc, tvc) = T.decode_step(cfg, port, tok, (tkc, tvc),
                                        PROMPT + i, device="cpu")
        out["decode"].append((jlg, tlg))
    out["caches"] = (jkc, jvc, tkc, tvc)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_matches_the_reference(name, dtype):
    jl, jc, tl, tc = _run(name, dtype)["prefill"]
    logit_tol, cache_tol = TOLS[dtype]
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), _f32(jl), **logit_tol)
    for j, t in zip(jc, tc):
        assert t.dtype == getattr(torch, dtype) and t.shape == j.shape
        np.testing.assert_allclose(_f32(t), _f32(j), **cache_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_teacher_forced_decode_matches_the_reference(name, dtype):
    out = _run(name, dtype)
    logit_tol, cache_tol = TOLS[dtype]
    for step, (jlg, tlg) in enumerate(out["decode"]):
        assert tuple(tlg.shape) == (2, 1, get_arch(name).reduced_cfg.vocab)
        np.testing.assert_allclose(tlg.numpy(), _f32(jlg), **logit_tol,
                                   err_msg=f"step {step}")
    jkc, jvc, tkc, tvc = out["caches"]
    np.testing.assert_allclose(_f32(tkc), _f32(jkc), **cache_tol)
    np.testing.assert_allclose(_f32(tvc), _f32(jvc), **cache_tol)


def test_the_window_binds_in_this_test():
    cfg = get_arch("starcoder2-7b").reduced_cfg
    assert cfg.window is not None and PROMPT > cfg.window


@pytest.mark.parametrize("name", LM_ARCHS)
def test_configs_are_the_reference_configs(name):
    for port, ref in ((get_arch(name).cfg, j_get_arch(name).cfg),
                      (get_arch(name).reduced_cfg,
                       j_get_arch(name).reduced_cfg)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params == ref.n_params
    assert get_arch(name).family == j_get_arch(name).family == "lm"


def test_registry_names_every_reference_arch():
    from repro.configs.registry import ARCH_NAMES as J_NAMES
    assert ARCH_NAMES == J_NAMES
    # every family is ported: no name raises
    for name in ARCH_NAMES:
        assert get_arch(name).family == j_get_arch(name).family
    with pytest.raises(KeyError):
        get_arch("gpt-2")
    assert get_arch("dlrm-mlperf").family == "recsys"


def test_config_rejects_sharding_fields():
    """The sharding fields are accepted (they used to be refused), and a
    mesh's axes are bound into every dense LM's config as the
    reference's ``make_lm_arch`` binds them."""
    from repro.configs.base import axes_for_mesh as j_axes_for_mesh
    from repro_torch.configs.base import axes_for_mesh
    cfg = get_arch("starcoder2-7b").reduced_cfg
    assert dataclasses.replace(cfg, tp_axis="model").tp_axis == "model"
    for sizes in ({"data": 16, "model": 16},
                  {"pod": 2, "data": 16, "model": 16}):
        mesh = type("Mesh", (), {"axis_names": tuple(sizes),
                                 "shape": sizes})()
        for name in LM_ARCHS:
            bound = get_arch(name, axes=axes_for_mesh(mesh)).cfg
            want = j_get_arch(name, axes=j_axes_for_mesh(mesh)).cfg
            assert dataclasses.asdict(bound) == dataclasses.asdict(want)
            assert bound.dp_axes == tuple(n for n in sizes if n != "model")
    assert T.LMConfig(**{**dataclasses.asdict(cfg),
                         "param_dtype": "float32"}).dtype == torch.float32


@pytest.mark.parametrize("name", LM_ARCHS)
def test_init_lm_keeps_the_reference_tree(name):
    jcfg, cfg = _configs(name, "bfloat16")
    shapes = jax.eval_shape(lambda: JT.init_lm(jax.random.key(0), jcfg))
    port = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat.items()}
    got = {}
    for pname, t in port.named_parameters():
        parts = pname.split(".")
        if parts[0] == "blocks":
            key = "/".join(["blocks"] + parts[2:])
            shape = (cfg.n_layers,) + tuple(t.shape)
            got.setdefault(key, (shape, t.dtype))
        else:
            got["/".join(parts)] = (tuple(t.shape), t.dtype)
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert got[key][0] == tuple(leaf.shape), key
        assert str(got[key][1]).removeprefix("torch.") == str(leaf.dtype)
    assert sum(t.numel() for _, t in port.named_parameters()) == \
        sum(int(np.prod(x.shape)) for x in want.values())


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_matches_prefill_logits(name):
    """The port alone: decoding token t against prefill(tokens[:t])'s
    cache gives prefill(tokens[:t + 1])'s last logits (f32, so that only
    the order of sums differs: 1e-4), at t = 40 > starcoder2's window."""
    cfg = dataclasses.replace(get_arch(name).reduced_cfg,
                              param_dtype="float32")
    params = T.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 41)))
    full, _ = T.prefill(cfg, params, toks, device="cpu")
    _, cache = T.prefill(cfg, params, toks[:, :40], device="cpu")
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 48, cfg.d_head)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    kc[:, :, :, :40], vc[:, :, :, :40] = cache
    lg, (kc2, _) = T.decode_step(cfg, params, toks[:, 40:], (kc, vc), 40,
                                 device="cpu")
    assert kc2 is kc and kc[:, :, :, 40].abs().sum() > 0   # in place
    torch.testing.assert_close(lg[:, 0], full, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="cache holds"):
        T.decode_step(cfg, params, toks[:, :1], (kc, vc), 48, device="cpu")


@pytest.mark.parametrize("step,batch,seq", [(0, 4, 32), (3, 2, 8192)])
def test_lm_batch_is_byte_equal(step, batch, seq):
    got, want = lm_batch(step, batch, seq, 49152), \
        j_lm_batch(step, batch, seq, 49152)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype == np.int32
        assert got[key].tobytes() == want[key].tobytes()


def test_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    cfg = get_arch("starcoder2-7b").reduced_cfg
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = (torch.zeros(2, 1, 2, 8, 16), torch.zeros(2, 1, 2, 8, 16))
    toks = np.zeros((1, 4), np.int32)
    for call in (lambda: T.init_lm(cfg, torch.Generator()),
                 lambda: T.prefill(cfg, params, toks),
                 lambda: T.decode_step(cfg, params, toks[:, :1], cache, 4),
                 lambda: T.lm_params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="parameters are on"):
        T.prefill(cfg, params, toks, device="meta")


# ---------------------------------------------------------------------------
# training: chunked_ce and train_forward's loss and gradients
# ---------------------------------------------------------------------------
#: Gradient tolerances, per leaf, as a share of that leaf's largest
#: reference gradient.  f32 1e-5 (largest seen 1.9e-6); bf16 6e-2 (largest
#: seen 2.9e-2, on starcoder2's K bias, whose gradient is rounding noise:
#: a bias on K shifts a whole row of scores and the softmax cancels it).
#: Loss: f32 rtol=1e-6; bf16 atol=1e-3 (seen 2.5e-4).
GRAD_TOLS = {"float32": (dict(rtol=1e-6, atol=0.0), 1e-5),
             "bfloat16": (dict(rtol=0.0, atol=1e-3), 6e-2)}
TRAIN_SEQ, CE_CHUNK = 41, 16     # 2 chunks of 16, 9 positions left out


def _train_batch(vocab):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, vocab, (2, TRAIN_SEQ)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, TRAIN_SEQ)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": toks, "labels": labels}


def _jax_leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for k in parts[2:]:
            node = node[k]
        return np.asarray(node[int(parts[1])], np.float32)
    for k in parts:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _train_pair(name, dtype, **over):
    jcfg, cfg = _configs(name, dtype)
    jcfg = dataclasses.replace(jcfg, ce_chunk=CE_CHUNK, **over)
    cfg = dataclasses.replace(cfg, ce_chunk=CE_CHUNK, **over)
    jp = JT.init_lm(jax.random.key(0), jcfg)
    port = T.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    return jcfg, cfg, jp, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_train_forward_loss_and_gradients_match_the_reference(name, dtype):
    from repro_torch.configs.base import trainable, value_and_grad
    jcfg, cfg, jp, port = _train_pair(name, dtype)
    batch = _train_batch(cfg.vocab)
    jl, jg = jax.value_and_grad(lambda p: JT.train_forward(
        jcfg, p, jax.tree.map(jnp.asarray, batch)))(jp)
    leaves = trainable(port)
    loss, grads = value_and_grad(
        lambda: T.train_forward(cfg, port, batch, device="cpu"), leaves)
    loss_tol, grad_share = GRAD_TOLS[dtype]
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), **loss_tol)
    jg = jax.tree.map(np.asarray, jg)
    for n, g in grads.items():
        assert g.dtype == cfg.dtype, n
        want = _jax_leaf(jg, n)
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0,
                                   atol=grad_share * np.abs(want).max(),
                                   err_msg=n)


def test_remat_changes_no_number():
    """``remat`` recomputes each block and loss chunk in the backward;
    loss and gradients stay bit for bit those without it."""
    from repro_torch.configs.base import trainable, value_and_grad
    out = []
    for remat in (True, False):
        _, cfg, _, port = _train_pair("command-r-35b", "float32",
                                      remat=remat)
        out.append(value_and_grad(
            lambda: T.train_forward(cfg, port, _train_batch(cfg.vocab),
                                    device="cpu"), trainable(port)))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n


@pytest.mark.parametrize("seq", [32, 41, 8])
def test_chunked_ce_matches_the_reference(seq):
    """Logits in the parameters' type, CE in f32, ``-1`` labels ignored,
    and, when the chunk does not divide S, the reference's cut of the
    last S mod c positions (S = 8 < the chunk: one chunk of 8)."""
    jcfg, cfg, jp, port = _train_pair("starcoder2-7b", "float32")
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab, (2, seq)).astype(np.int32)
    want = float(JT.chunked_ce(jcfg, jp, jnp.asarray(x), jnp.asarray(labels)))
    got = T.chunked_ce(cfg, port, torch.from_numpy(x),
                       torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if seq % CE_CHUNK:
        # the positions past the last whole chunk do not count
        labels2 = labels.copy()
        labels2[:, (seq // min(CE_CHUNK, seq)) * min(CE_CHUNK, seq):] = 0
        assert float(T.chunked_ce(cfg, port, torch.from_numpy(x),
                                  torch.from_numpy(labels2))) == float(got)


def test_serving_records_no_graph_after_training_turns_grad_on():
    """Once a train step has turned ``requires_grad`` on, prefill and
    decode still run under inference mode (on the card, K4 would raise
    under grad mode)."""
    from repro_torch.configs.base import trainable
    _, cfg, _, port = _train_pair("starcoder2-7b", "float32")
    trainable(port)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 12))
    logits, (k, v) = T.prefill(cfg, port, toks, device="cpu")
    assert not logits.requires_grad and logits.is_inference()
