"""The port's MoE LMs (``repro_torch.models.moe``) against
``repro.models.moe``, on the CPU, for the ``REDUCED`` configs of
qwen3-moe-235b-a22b (8 experts, top 2, SwiGLU) and grok-1-314b (4
experts, top 2, "geglu", which the reference's MoE FFN runs with SiLU).

The reference's parameters (``init_moe_lm(jax.random.key(0), cfg)``) go
across with ``moe_params_from_jax``; inputs are numpy draws of fixed
seeds.  The reference's routing is its own top-k of its own router
softmax, computed here with the same jnp calls as ``moe.py:96-100``.

Tolerances.  f32: routing (``expert_idx``) equal, ``moe_apply`` 1e-5,
the aux loss rtol 1e-6, prefill logits and caches as
``test_torch_transformer.py``'s f32 (1e-4 / 1e-5), loss rtol 1e-6 and
each gradient 1e-5 of its leaf's largest.  bf16: ``moe_apply`` and the
logits atol 2e-2 plus two bf16 steps (rtol 2**-6) of the value,
caches rtol 2**-6 atol 3e-2 (``test_torch_transformer.py``'s bf16
bounds; the combine's scatter-add rounds in bf16 in an order each
package picks), loss atol 1e-3 and each gradient 6e-2 of its leaf's
largest, as the dense LMs'.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import moe as JM
from repro_torch.configs.registry import get_arch
from repro_torch.launch import lm_demo
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as M

MOE_ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]
DTYPES = ["float32", "bfloat16"]
PROMPT, STEPS, TOKENS = 24, 8, 64
APPLY_TOL = {"float32": dict(rtol=0.0, atol=1e-5),
             "bfloat16": dict(rtol=2**-6, atol=2e-2)}
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=2**-6, atol=2e-2)}
CACHE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=2**-6, atol=3e-2)}
GRAD_TOLS = {"float32": (dict(rtol=1e-6, atol=0.0), 1e-5),
             "bfloat16": (dict(rtol=0.0, atol=1e-3), 6e-2)}


def _f32(a):
    return a.float().numpy() if torch.is_tensor(a) else \
        np.asarray(a, np.float32)


def _configs(name, dtype, **over):
    return (dataclasses.replace(j_get_arch(name).reduced_cfg,
                                param_dtype=dtype, **over),
            dataclasses.replace(get_arch(name).reduced_cfg,
                                param_dtype=dtype, **over))


_PAIRS = {}


def _pair(name, dtype, **over):
    """(jcfg, cfg, reference params, port params), built once."""
    key = (name, dtype, tuple(sorted(over.items())))
    if key not in _PAIRS:
        jcfg, cfg = _configs(name, dtype, **over)
        jp = JM.init_moe_lm(jax.random.key(0), jcfg)
        port = M.moe_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
        _PAIRS[key] = (jcfg, cfg, jp, port)
    return _PAIRS[key]


def _ref_expert_idx(jcfg, lp, x):
    """The reference's top-k experts of ``x`` (``moe.py:96-100``)."""
    g = jcfg.dispatch_groups if x.shape[0] % jcfg.dispatch_groups == 0 \
        else 1
    xg = jnp.asarray(x).reshape(g, -1, x.shape[-1])
    gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg.astype(jnp.float32),
                                      lp["router"]), axis=-1)
    return np.asarray(jax.lax.top_k(gates, jcfg.top_k)[1])


def _apply_both(name, dtype, tokens=TOKENS, seed=5, **over):
    jcfg, cfg, jp, port = _pair(name, dtype, **over)
    x = np.random.default_rng(seed).standard_normal(
        (tokens, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    jy, jaux = jax.jit(lambda p, v: JM.moe_apply(p, v, jcfg))(
        lp, jnp.asarray(x).astype(jcfg.dtype))
    routing = []
    ty, taux = M.moe_apply(port.blocks[0].moe,
                           torch.from_numpy(x).to(cfg.dtype), cfg, routing)
    return dict(jcfg=jcfg, cfg=cfg, x=x, jy=jy, jaux=jaux, ty=ty, taux=taux,
                routing=routing[0], j_idx=_ref_expert_idx(jcfg, lp, x))


def _expected_keep(expert_idx, cap):
    """Which assignments find a slot: per group, the first ``cap`` of
    each expert in (token, k) order (a stable sort by expert)."""
    g = expert_idx.shape[0]
    flat = expert_idx.reshape(g, -1)
    keep = np.zeros(flat.shape, bool)
    for gi in range(g):
        seen = {}
        for i, ex in enumerate(flat[gi]):
            seen[ex] = seen.get(ex, 0) + 1
            keep[gi, i] = seen[ex] <= cap
    return keep.reshape(expert_idx.shape)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_apply_matches_the_reference(name, dtype):
    r = _apply_both(name, dtype)
    assert r["ty"].dtype == r["cfg"].dtype and r["ty"].shape == r["x"].shape
    np.testing.assert_allclose(_f32(r["ty"]), _f32(r["jy"]),
                               **APPLY_TOL[dtype])
    assert r["taux"].dtype == torch.float32
    np.testing.assert_allclose(float(r["taux"]), float(r["jaux"]),
                               rtol=1e-6)
    if dtype == "float32":
        np.testing.assert_array_equal(r["routing"]["expert_idx"].numpy(),
                                      r["j_idx"])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_capacity_drops_the_reference_tokens(name):
    """At capacity_factor 0.5 a quarter or more of the assignments
    overflow; the outputs agree to 1e-5 only if the port drops the
    reference's tokens, and ``keep`` is the stable order's."""
    r = _apply_both(name, "float32", capacity_factor=0.5)
    idx = r["routing"]["expert_idx"].numpy()
    np.testing.assert_array_equal(idx, r["j_idx"])
    cap = M.capacity(TOKENS, r["cfg"])
    keep = r["routing"]["keep"].numpy()
    np.testing.assert_array_equal(keep, _expected_keep(idx, cap))
    assert 0 < (~keep).sum() < keep.size
    np.testing.assert_allclose(_f32(r["ty"]), _f32(r["jy"]),
                               **APPLY_TOL["float32"])
    # an unstable sort would keep other tokens: the outputs would differ
    full = _apply_both(name, "float32")
    assert np.abs(_f32(full["ty"]) - _f32(r["ty"])).max() > 1e-3


@pytest.mark.parametrize("over", [dict(dispatch_groups=2),
                                  dict(dispatch_groups=3),
                                  dict(act="gelu"), dict(act="geglu")],
                         ids=["groups2", "groups3-uneven", "gelu-no-gate",
                              "geglu-gate"])
def test_moe_apply_variants_match_the_reference(over):
    """Grouped dispatch without a mesh (3 groups do not divide 64 tokens:
    one group), GELU (tanh) without a gate, and "geglu" with a gate,
    which the reference runs with SiLU."""
    r = _apply_both("qwen3-moe-235b-a22b", "float32", **over)
    np.testing.assert_array_equal(r["routing"]["expert_idx"].numpy(),
                                  r["j_idx"])
    groups = 2 if over.get("dispatch_groups") == 2 else 1
    assert r["routing"]["expert_idx"].shape[0] == groups
    np.testing.assert_allclose(_f32(r["ty"]), _f32(r["jy"]),
                               **APPLY_TOL["float32"])
    np.testing.assert_allclose(float(r["taux"]), float(r["jaux"]),
                               rtol=1e-6)
    has_gate = r["cfg"].act in ("swiglu", "geglu")
    assert (_pair("qwen3-moe-235b-a22b", "float32", **over)[3]
            .blocks[0].moe.gate is not None) == has_gate


@pytest.mark.parametrize("tokens,top_k,experts", [
    (64, 2, 8), (4, 2, 8), (4, 8, 128), (16384, 8, 128), (16384, 2, 8),
    (3, 1, 4)])
def test_capacity_is_the_reference_rule(tokens, top_k, experts):
    cfg = dataclasses.replace(get_arch("grok-1-314b").reduced_cfg,
                              top_k=top_k, n_experts=experts)
    tk = tokens * top_k
    want = int(max(8, -(-tk // experts) * cfg.capacity_factor)) \
        if tk >= experts else max(8, tk)
    assert M.capacity(tokens, cfg) == want


# ---------------------------------------------------------------------------
# prefill, decode
# ---------------------------------------------------------------------------
_RUNS = {}


def _serve_both(name, dtype):
    if (name, dtype) in _RUNS:
        return _RUNS[name, dtype]
    jcfg, cfg, jp, port = _pair(name, dtype)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.moe_prefill(jcfg, p, t))(
        jp, jnp.asarray(toks[:, :PROMPT]))
    decode = jax.jit(lambda p, t, c, n: JM.moe_decode_step(jcfg, p, t, c, n))
    tl, tc = M.moe_prefill(cfg, port, toks[:, :PROMPT], device="cpu")
    out = dict(prefill=(jl, jc, tl, tc), decode=[])
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, PROMPT + STEPS, cfg.d_head)
    jkc = jnp.zeros(shape, jcfg.dtype).at[:, :, :, :PROMPT].set(jc[0])
    jvc = jnp.zeros(shape, jcfg.dtype).at[:, :, :, :PROMPT].set(jc[1])
    tkc, tvc = torch.zeros(shape, dtype=cfg.dtype), \
        torch.zeros(shape, dtype=cfg.dtype)
    tkc[:, :, :, :PROMPT], tvc[:, :, :, :PROMPT] = tc
    for i in range(STEPS):
        tok = toks[:, PROMPT + i:PROMPT + i + 1]
        jlg, (jkc, jvc) = decode(jp, jnp.asarray(tok), (jkc, jvc),
                                 jnp.int32(PROMPT + i))
        tlg, (tkc, tvc) = M.moe_decode_step(cfg, port, tok, (tkc, tvc),
                                            PROMPT + i, device="cpu")
        out["decode"].append((jlg, tlg))
    out["caches"] = (jkc, jvc, tkc, tvc)
    _RUNS[name, dtype] = out
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_prefill_matches_the_reference(name, dtype):
    jl, jc, tl, tc = _serve_both(name, dtype)["prefill"]
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), _f32(jl), **LOGIT_TOL[dtype])
    for j, t in zip(jc, tc):
        assert t.shape == j.shape
        np.testing.assert_allclose(_f32(t), _f32(j), **CACHE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_teacher_forced_decode_matches_the_reference(name, dtype):
    """8 decode steps, the same next token into both packages: each
    step routes B = 2 tokens (the ``max(8, tk)`` capacity branch)."""
    out = _serve_both(name, dtype)
    for step, (jlg, tlg) in enumerate(out["decode"]):
        np.testing.assert_allclose(tlg.numpy(), _f32(jlg),
                                   **LOGIT_TOL[dtype], err_msg=f"step {step}")
    jkc, jvc, tkc, tvc = out["caches"]
    np.testing.assert_allclose(_f32(tkc), _f32(jkc), **CACHE_TOL[dtype])
    np.testing.assert_allclose(_f32(tvc), _f32(jvc), **CACHE_TOL[dtype])


def test_moe_decode_matches_prefill_logits():
    """The port alone, f32: decoding token t against prefill(tokens[:t])'s
    cache gives prefill(tokens[:t + 1])'s last logits, once no prefill
    token overflows its expert (capacity factor 8; at 1.25 prefill drops
    tokens that decode, with its ``max(8, tk)`` slots, keeps)."""
    _, cfg, _, port = _pair("grok-1-314b", "float32", capacity_factor=8.0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 21)))
    full, _ = M.moe_prefill(cfg, port, toks, device="cpu")
    _, cache = M.moe_prefill(cfg, port, toks[:, :20], device="cpu")
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 24, cfg.d_head)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    kc[:, :, :, :20], vc[:, :, :, :20] = cache
    lg, _ = M.moe_decode_step(cfg, port, toks[:, 20:], (kc, vc), 20,
                              device="cpu")
    torch.testing.assert_close(lg[:, 0], full, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _train_batch(vocab, seq=24):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, vocab, (2, seq)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, seq)).astype(np.int32)
    labels[0, :4] = -1
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_train_forward_loss_and_gradients_match_the_reference(name,
                                                                   dtype):
    from repro_torch.configs.base import trainable, value_and_grad
    jcfg, cfg, jp, port = _pair(name, dtype, ce_chunk=8)
    batch = _train_batch(cfg.vocab)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.moe_train_forward(
        jcfg, p, b)))(jp, jax.tree.map(jnp.asarray, batch))
    loss, grads = value_and_grad(
        lambda: M.moe_train_forward(cfg, port, batch, device="cpu"),
        trainable(port))
    for p in port.parameters():
        p.requires_grad_(False)
    loss_tol, share = GRAD_TOLS[dtype]
    np.testing.assert_allclose(float(loss), float(jl), **loss_tol)
    jg = jax.tree.map(np.asarray, jg)
    for n, g in grads.items():
        want = _jax_leaf(jg, n)
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0,
                                   atol=share * np.abs(want).max(),
                                   err_msg=n)


def test_moe_remat_changes_no_number():
    """Remat recomputes the routing in the backward; loss and gradients
    stay bit for bit those without it."""
    from repro_torch.configs.base import trainable, value_and_grad
    out = []
    for remat in (True, False):
        _, cfg, _, port = _pair("qwen3-moe-235b-a22b", "float32",
                                remat=remat, ce_chunk=8)
        out.append(value_and_grad(
            lambda: M.moe_train_forward(cfg, port, _train_batch(cfg.vocab),
                                        device="cpu"), trainable(port)))
        for p in port.parameters():
            p.requires_grad_(False)
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n


def test_moe_train_step_is_lm_train_step_with_the_moe_forward():
    """``lm_train_step(forward=moe_train_forward)`` with 2 microbatches:
    one AdamW step moves every leaf (f32: a bf16 norm scale of 1 does not
    move by lr 3e-4), the loss is finite."""
    from repro_torch.configs.base import lm_train_step
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_arch("grok-1-314b").reduced_cfg,
                              param_dtype="float32")
    params = M.init_moe_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    step = lm_train_step(cfg, 4, 16, microbatches=2, device="cpu",
                         forward=M.moe_train_forward)
    batch = _train_batch(cfg.vocab, 16)
    batch = {k: np.concatenate([v, v]) for k, v in batch.items()}
    params, _, metrics = step(params, adamw_init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    for n, p in params.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n


# ---------------------------------------------------------------------------
# configs, registry, parameters, entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_configs_are_the_reference_configs(name):
    arch, ref = get_arch(name), j_get_arch(name)
    assert arch.family == ref.family == "moe"
    assert arch.init_params is M.init_moe_lm
    assert arch.loss is M.moe_train_forward
    for port, want in ((arch.cfg, ref.cfg),
                       (arch.reduced_cfg, ref.reduced_cfg)):
        assert dataclasses.asdict(port) == dataclasses.asdict(want)
        assert port.n_params == want.n_params
        assert port.n_active_params == want.n_active_params
    with pytest.raises(ValueError, match="sharding"):
        dataclasses.replace(arch.reduced_cfg, tp_axis="model")


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_init_moe_lm_keeps_the_reference_tree(name):
    jcfg, cfg = _configs(name, "bfloat16")
    shapes = jax.eval_shape(lambda: JM.init_moe_lm(jax.random.key(0), jcfg))
    port = M.init_moe_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat.items()}
    got = {}
    for pname, t in port.named_parameters():
        parts = pname.split(".")
        if parts[0] == "blocks":
            got.setdefault("/".join(["blocks"] + parts[2:]),
                           ((cfg.n_layers,) + tuple(t.shape), t.dtype))
        else:
            got["/".join(parts)] = (tuple(t.shape), t.dtype)
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert got[key][0] == tuple(leaf.shape), key
        assert str(got[key][1]).removeprefix("torch.") == str(leaf.dtype)
    assert sum(t.numel() for t in port.parameters()) == \
        sum(int(np.prod(x.shape)) for x in want.values())
    # the scales: the router N(0,1)/sqrt(d), the experts' 1/sqrt(d_in)
    moe = port.blocks[0].moe
    assert abs(float(moe.router.std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(float(moe.down.float().std()) * cfg.d_ff ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_lm_demo_serves_a_reduced_moe(name, capsys):
    rec = lm_demo.main(["--arch", name, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "reduced width, 2 layers" in out and "dropped at capacity" in out
    cfg = get_arch(name).reduced_cfg
    assert rec["token_ids"].shape == (2, 5)
    assert torch.isfinite(rec["last_logits"]).all()
    assert len(rec["routing"]) == cfg.n_layers
    assert 0.0 <= rec["dropped_share"] < 1.0
    assert rec["routing"][0]["expert_idx"].shape == (1, 32, cfg.top_k)


def _reference_main(argv):
    import repro.launch.train as JTR
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["train"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            JTR.main()
    finally:
        sys.argv = old
    return [float(line.split("loss")[1].split()[0])
            for line in buf.getvalue().splitlines()
            if line.startswith("step")]


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread, restored after: the reduced models'
    many small ops crawl on a pool of 8 threads when other test
    processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_torch_thread")
def test_launcher_trains_a_reduced_moe_as_the_reference(capsys):
    """``launch.train --arch qwen3-moe-235b-a22b`` from the reference's
    parameters prints the reference's losses (bf16: atol 1e-2 after 11
    AdamW steps) and falls."""
    name = "qwen3-moe-235b-a22b"
    argv = ["--arch", name, "--steps", "11", "--seq", "32"]
    want = _reference_main(argv)
    ja = j_get_arch(name)
    jp = jax.tree.map(np.asarray, ja.init_params(jax.random.key(0),
                                                 ja.reduced_cfg))
    params = M.moe_params_from_jax(jp, get_arch(name).reduced_cfg,
                                   device="cpu")
    capsys.readouterr()
    hist = launch_train.train(name, steps=11, seq=32, device="cpu",
                              params=params)
    got = [float(line.split("loss")[1].split()[0])
           for line in capsys.readouterr().out.splitlines()
           if line.startswith("step")]
    assert len(want) == len(got) == 2 and len(hist) == 11
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_moe_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    _, cfg, _, port = _pair("grok-1-314b", "float32")
    toks = np.zeros((1, 4), np.int32)
    cache = (torch.zeros(2, 1, 2, 8, 16), torch.zeros(2, 1, 2, 8, 16))
    for call in (lambda: M.init_moe_lm(cfg, torch.Generator()),
                 lambda: M.moe_prefill(cfg, port, toks),
                 lambda: M.moe_decode_step(cfg, port, toks[:, :1], cache, 4),
                 lambda: M.moe_train_forward(
                     cfg, port, {"tokens": toks, "labels": toks}),
                 lambda: M.moe_params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
