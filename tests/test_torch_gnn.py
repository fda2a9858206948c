"""The port's GNN family (``repro_torch.models.gnn``) against
``repro.models.gnn``, on the CPU: ``aggregate`` and ``segment_softmax``
under the six coherence x consistency configs, the spherical harmonics
and Wigner blocks, PNA, MeshGraphNet, SchNet and EquiformerV2 at their
``REDUCED`` configs (forward, loss and gradients), the configs of every
shape, ``gnn_batch`` and the launcher.

The reference's parameters (``init_*(jax.random.key(0), cfg)``) go
across with the ``*_params_from_jax`` functions; inputs are numpy draws
of fixed seeds, with nodes that no edge reaches so that empty segments
are exercised.

Tolerances.  ``aggregate`` min and max bit-equal, empty segments
included (+-inf); sums 1e-5 (the chunks' partials add in another
order).  SH and Wigner blocks 1e-5.  PNA, MeshGraphNet and SchNet in
f32: the forward 1e-5, the loss rtol 1e-6, each gradient 1e-4 of its
leaf's largest.  EquiformerV2 runs its edge tensors in bf16 in both
packages (the gathered features, the SO(2) conv, the messages and
their scatter-sum), and the packages round them at other places
(a three-operand einsum's intermediate, the bf16 scatter-add's order):
its forward is held to 2e-2 of its largest energy, the loss to rtol
1e-2 and each gradient to 5e-2 of its leaf's largest.
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

from repro.configs import base as j_base
from repro.configs.registry import get_arch as j_get_arch
from repro.core.config_space import SystemConfig as JSystemConfig
from repro.data.synthetic import gnn_batch as j_gnn_batch
from repro.graph import powerlaw_graph as j_powerlaw_graph
from repro.models.gnn import common as JC
from repro.models.gnn import equiformer_v2 as JEQ
from repro.models.gnn import meshgraphnet as JMG
from repro.models.gnn import pna as JP
from repro.models.gnn import schnet as JSN
from repro.models.gnn import sh as JSH
from repro_torch.configs.base import GNN_SHAPES, trainable, value_and_grad
from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.core.config_space import SystemConfig
from repro_torch.data.synthetic import gnn_batch
from repro_torch.graph import powerlaw_graph
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import equiformer_v2 as EQ
from repro_torch.models.gnn import meshgraphnet as MG
from repro_torch.models.gnn import pna as P
from repro_torch.models.gnn import schnet as SN
from repro_torch.models.gnn import sh as SH

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of every test here on one intra-op thread,
    restored after.  On some x86 hosts a worker thread of torch's CPU
    pool now and then computes ``torch.exp`` with relative errors near
    1.5e-4 over one 4,096-element grain (seen in 4 of 16 fresh processes
    for a [8195, 4] f32 tensor; never on one thread, 0 of 20), which no
    tolerance here is meant to absorb; and the GNNs' many small ops run
    far slower on a pool of 8 threads when other test processes share
    the cores (the PNA launcher test took 211 s so, 6.5 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GNN_ARCHS = ["pna", "meshgraphnet", "schnet", "equiformer-v2"]
CONFIGS = [c.name for c in C.GNN_CONFIGS]
KINDS = ["sum", "min", "max"]
#: model -> (reference init, reference loss, reference forward, port
#: loader, port loss, port forward)
MODELS = {
    "pna": (JP.init_pna, JP.pna_loss, JP.pna_forward,
            P.pna_params_from_jax, P.pna_loss, P.pna_forward),
    "meshgraphnet": (JMG.init_mgn, JMG.mgn_loss, JMG.mgn_forward,
                     MG.mgn_params_from_jax, MG.mgn_loss, MG.mgn_forward),
    "schnet": (JSN.init_schnet, JSN.schnet_loss, JSN.schnet_forward,
               SN.schnet_params_from_jax, SN.schnet_loss,
               SN.schnet_forward),
    "equiformer-v2": (JEQ.init_equiformer, JEQ.equiformer_loss,
                      JEQ.equiformer_forward, EQ.equiformer_params_from_jax,
                      EQ.equiformer_loss, EQ.equiformer_forward),
}
#: forward (share of the largest output), loss rtol, gradient share
TOLS = {"pna": (1e-5, 1e-6, 1e-4), "meshgraphnet": (1e-5, 1e-6, 1e-4),
        "schnet": (1e-5, 1e-6, 1e-4), "equiformer-v2": (2e-2, 1e-2, 5e-2)}


# ---------------------------------------------------------------------------
# aggregate, segment_softmax
# ---------------------------------------------------------------------------
N_AGG, E_AGG = 700, 8195     # 8 chunks of 1,025 edges, the last padded by 5


def _agg_inputs(dim):
    rng = np.random.default_rng(11)
    # nodes >= 600 receive no edge: empty segments
    dst = rng.integers(0, 600, E_AGG).astype(np.int32)
    shape = (E_AGG,) if dim is None else (E_AGG, dim)
    return rng.standard_normal(shape).astype(np.float32), dst


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("config", CONFIGS)
def test_aggregate_matches_the_reference(config, kind):
    for dim in (None, 3):
        v, dst = _agg_inputs(dim)
        want = np.asarray(JC.aggregate(jnp.asarray(v), jnp.asarray(dst),
                                       N_AGG, kind,
                                       JSystemConfig.from_name(config)))
        got = C.aggregate(torch.from_numpy(v), torch.from_numpy(dst), N_AGG,
                          kind, SystemConfig.from_name(config)).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if kind == "sum":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
            assert np.isinf(got[600:]).all()


@pytest.mark.parametrize("config", CONFIGS)
def test_segment_softmax_matches_the_reference(config):
    rng = np.random.default_rng(12)
    dst = rng.integers(0, 600, E_AGG).astype(np.int32)
    logits = rng.standard_normal((E_AGG, 4)).astype(np.float32) * 3
    want = np.asarray(JC.segment_softmax(jnp.asarray(logits),
                                         jnp.asarray(dst), N_AGG,
                                         JSystemConfig.from_name(config)))
    got = C.segment_softmax(torch.from_numpy(logits), torch.from_numpy(dst),
                            N_AGG, SystemConfig.from_name(config)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gnn_configs_are_the_six_push_configs():
    assert sorted(CONFIGS) == ["SD0", "SD1", "SDR", "SG0", "SG1", "SGR"]
    assert C.DEFAULT_GNN_CONFIG.name == JC.DEFAULT_GNN_CONFIG.name == "SGR"


# ---------------------------------------------------------------------------
# spherical harmonics
# ---------------------------------------------------------------------------
def _unit_dirs(n, seed):
    v = np.random.default_rng(seed).standard_normal((n, 3))
    v[0] = (0, 0, 1)
    v[1] = (0, 0, -1)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("l_max", [0, 1, 3, 6])
def test_real_sph_harm_matches_the_reference(l_max):
    d = _unit_dirs(200, l_max)
    want = np.asarray(JSH.real_sph_harm(jnp.asarray(d), l_max))
    got = SH.real_sph_harm(torch.from_numpy(d), l_max).numpy()
    assert got.shape == (200, SH.n_coeffs(l_max))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("l_max,m_max", [(6, None), (6, 2), (3, 2), (2, 1)])
def test_wigner_blocks_match_the_reference(l_max, m_max):
    d = _unit_dirs(50, 7)
    rot_j = JSH.align_z_rotation(jnp.asarray(d))
    rot = SH.align_z_rotation(torch.from_numpy(d))
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_j), rtol=0,
                               atol=1e-6)
    # R e = z; but at e = -z exactly both packages keep the identity (the
    # antipodal branch tests c < -1 + 1e-9, which is c < -1 in f32)
    np.testing.assert_allclose((rot @ torch.from_numpy(d)[..., None])[..., 0]
                               .numpy()[[0] + list(range(2, 50))],
                               np.tile([0, 0, 1.0], (49, 1)), atol=1e-5)
    assert torch.equal(rot[1], torch.eye(3))
    want = jax.jit(lambda r: JSH.wigner_blocks(r, l_max, m_max=m_max))(
        rot_j)
    got = SH.wigner_blocks(rot, l_max, m_max=m_max)
    assert len(got) == len(want) == l_max + 1
    for l, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, l
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=f"l={l}")
    assert SH.kept_rows(l_max, m_max if m_max is not None else l_max) \
        .tolist() == JSH.kept_rows(l_max, m_max if m_max is not None
                                   else l_max).tolist()


def test_wigner_blocks_rotate_the_harmonics():
    """The port alone: ``Y(R r) = D Y(r)`` per degree, l_max 6."""
    d = torch.from_numpy(_unit_dirs(64, 3))
    rot = SH.align_z_rotation(torch.from_numpy(_unit_dirs(3, 9)))[2]
    blocks = SH.wigner_blocks(rot, 6)
    y, y_rot = SH.real_sph_harm(d, 6), SH.real_sph_harm(d @ rot.T, 6)
    off = 0
    for l, b in enumerate(blocks):
        sl = slice(off, off + 2 * l + 1)
        torch.testing.assert_close(y_rot[:, sl], y[:, sl] @ b.T, rtol=0,
                                   atol=1e-4)
        off += 2 * l + 1


# ---------------------------------------------------------------------------
# the four models
# ---------------------------------------------------------------------------
def _batch(name, cfg):
    """64 nodes, 256 random edges (as ``tests/test_models.py``'s train
    step), some nodes with no incoming edge."""
    n, e = 64, 256
    r = np.random.default_rng(0)
    b = {"src": r.integers(0, n, e).astype(np.int32),
         "dst": r.integers(0, n - 6, e).astype(np.int32)}
    if name in ("schnet", "equiformer-v2"):
        g = cfg.n_graphs
        b.update(species=r.integers(0, 10, n).astype(np.int32),
                 positions=r.standard_normal((n, 3)).astype(np.float32) * 2,
                 graph_ids=(np.arange(n) % g).astype(np.int32),
                 energy=r.standard_normal(g).astype(np.float32))
    elif name == "meshgraphnet":
        b.update(node_feat=r.standard_normal((n, cfg.d_node_in))
                 .astype(np.float32),
                 edge_feat=r.standard_normal((e, cfg.d_edge_in))
                 .astype(np.float32),
                 target=r.standard_normal((n, cfg.d_out)).astype(np.float32))
    else:
        deg = np.zeros(n)
        np.add.at(deg, b["dst"], 1)
        b.update(node_feat=r.standard_normal((n, cfg.d_in))
                 .astype(np.float32),
                 in_degree=deg.astype(np.int32),
                 labels=r.integers(0, cfg.n_classes, n).astype(np.int32))
    return b


def _leaf(tree, name):
    """The reference's leaf for a port parameter name (blocks stacked)."""
    parts = name.split(".")
    node, idx = tree, None
    i = 0
    while i < len(parts):
        k = parts[i]
        if k == "blocks":
            node, idx = node["blocks"], int(parts[i + 1])
            i += 2
            continue
        k = "in" if k == "in_" else k
        node = node[int(k)] if isinstance(node, list) else node[k]
        i += 1
    a = np.asarray(node, np.float32)
    return a if idx is None else a[idx]


_RESULTS = {}


def _both(name, sys_name=None):
    """Reference and port forward, loss and gradients at REDUCED, once
    per (model, config)."""
    key = (name, sys_name)
    if key in _RESULTS:
        return _RESULTS[key]
    j_init, j_loss, j_fwd, load, loss_fn, fwd = MODELS[name]
    jcfg, cfg = j_get_arch(name).reduced_cfg, get_arch(name).reduced_cfg
    if sys_name is not None:
        jcfg = dataclasses.replace(jcfg,
                                   sys=JSystemConfig.from_name(sys_name))
        cfg = dataclasses.replace(cfg, sys=SystemConfig.from_name(sys_name))
    jp = jax.jit(lambda k: j_init(k, jcfg))(jax.random.key(0))
    port = load(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    b = _batch(name, cfg)
    jb = jax.tree.map(jnp.asarray, b)
    # one compile: the loss's value and gradients, the forward as aux
    (jl, j_out), jg = jax.jit(jax.value_and_grad(
        lambda p, x: (j_loss(jcfg, p, x), j_fwd(jcfg, p, x)),
        has_aux=True))(jp, jb)
    j_out = np.asarray(j_out)
    with torch.no_grad():
        out = fwd(cfg, port, b, device="cpu").numpy()
    loss, grads = value_and_grad(lambda: loss_fn(cfg, port, b, device="cpu"),
                                 trainable(port))
    for p in port.parameters():
        p.requires_grad_(False)
    _RESULTS[key] = dict(j_out=j_out, out=out, jl=float(jl), loss=float(loss),
                         jg=jax.tree.map(np.asarray, jg), grads=grads,
                         port=port, jp=jp)
    return _RESULTS[key]


def _same_gradients(r, share):
    """Each leaf within ``share`` of its largest reference gradient, or
    of 1e-4 of the model's largest, whichever is more: a leaf whose
    gradient is rounding noise (EquiformerV2's last attention bias, a
    per-head shift that the edge softmax cancels) is held to the
    model's scale."""
    floor = 1e-4 * max(np.abs(_leaf(r["jg"], n)).max() for n in r["grads"])
    n_leaves = 0
    for n, g in r["grads"].items():
        want = _leaf(r["jg"], n)
        assert g.shape == want.shape, n
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=share * max(np.abs(want).max(), floor), err_msg=n)
        n_leaves += 1
    return n_leaves


def _same_forward(r, share):
    assert r["out"].shape == r["j_out"].shape and r["out"].dtype == np.float32
    np.testing.assert_allclose(r["out"], r["j_out"], rtol=0,
                               atol=share * max(1.0, np.abs(r["j_out"])
                                                .max()))


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_forward_matches_the_reference(name):
    _same_forward(_both(name), TOLS[name][0])


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_loss_and_gradients_match_the_reference(name):
    r = _both(name)
    _, loss_rtol, grad_share = TOLS[name]
    np.testing.assert_allclose(r["loss"], r["jl"], rtol=loss_rtol)
    assert _same_gradients(r, grad_share) == sum(
        (getattr(get_arch(name).reduced_cfg, "n_layers", None)
         or get_arch(name).reduced_cfg.n_interactions)
        if "blocks" in "/".join(str(getattr(k, "key", k)) for k in path)
        else 1 for path, _ in jax.tree_util.tree_flatten_with_path(r["jg"])[0])


@pytest.mark.parametrize("config", ["SG0", "SG1", "SD0", "SD1", "SDR"])
def test_pna_under_every_config_matches_the_reference(config):
    """PNA, the densest user of ``aggregate`` (sum, max, min, sum of
    squares per layer), under the other five configs (SGR above)."""
    r = _both("pna", config)
    fwd_share, loss_rtol, grad_share = TOLS["pna"]
    _same_forward(r, fwd_share)
    np.testing.assert_allclose(r["loss"], r["jl"], rtol=loss_rtol)
    _same_gradients(r, grad_share)


def test_equiformer_rotation_invariance():
    """The port's EquiformerV2 at REDUCED, as the reference's
    ``tests/test_models.py`` holds it: energies of a rotated molecule
    within 5e-3 of the original's."""
    cfg = get_arch("equiformer-v2").reduced_cfg
    params = EQ.init_equiformer(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    n, e, g = 48, 128, cfg.n_graphs
    batch = {
        "species": rng.integers(0, 10, n).astype(np.int32),
        "positions": rng.standard_normal((n, 3)).astype(np.float32) * 2,
        "src": rng.integers(0, n, e).astype(np.int32),
        "dst": rng.integers(0, n, e).astype(np.int32),
        "graph_ids": (np.arange(n) % g).astype(np.int32),
    }
    rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    if np.linalg.det(rot) < 0:
        rot[:, 0] *= -1
    with torch.no_grad():
        e1 = EQ.equiformer_forward(cfg, params, batch, device="cpu")
        batch2 = dict(batch, positions=(batch["positions"]
                                        @ rot.T.astype(np.float32)))
        e2 = EQ.equiformer_forward(cfg, params, batch2, device="cpu")
    rel = float((e1 - e2).abs().max() / (e1.abs().max() + 1e-9))
    assert rel < 5e-3


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_init_keeps_the_reference_tree(name):
    ja = j_get_arch(name)
    shapes = jax.eval_shape(lambda: ja.init_params(jax.random.key(0),
                                                   ja.reduced_cfg))
    arch = get_arch(name)
    port = arch.init_params(arch.reduced_cfg,
                            torch.Generator().manual_seed(0), "cpu")
    got = dict(port.named_parameters())
    want = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert sum(t.numel() for t in got.values()) == \
        sum(x.size for x in jax.tree.leaves(want))
    for n, t in got.items():
        assert t.dtype == torch.float32
        assert tuple(t.shape) == _leaf(want, n).shape, n


# ---------------------------------------------------------------------------
# configs, data, launcher
# ---------------------------------------------------------------------------
def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["sys"] = cfg.sys.name
    return d


@pytest.mark.parametrize("shape", list(GNN_SHAPES))
@pytest.mark.parametrize("name", GNN_ARCHS)
def test_configs_are_the_reference_configs(name, shape):
    arch, ref = get_arch(name), j_get_arch(name)
    assert arch.family == ref.family == "gnn"
    assert GNN_SHAPES[shape] == j_base.GNN_SHAPES[shape]
    assert _fields(arch.cfg_for(shape)) == _fields(_ref_shape_cfg(name,
                                                                  shape))
    assert _fields(arch.cfg) == _fields(ref.cfg)
    assert _fields(arch.reduced_cfg) == _fields(ref.reduced_cfg)


def _ref_shape_cfg(name, shape):
    import importlib
    mod = importlib.import_module(
        "repro.configs." + name.replace("-", "_"))
    return mod._builder(j_base.GNN_SHAPES[shape])


def test_registry_resolves_every_reference_arch():
    from repro.configs.registry import ARCH_NAMES as J_NAMES
    assert ARCH_NAMES == J_NAMES
    for name in ARCH_NAMES:
        assert get_arch(name).family == j_get_arch(name).family
    assert j_base._pad512(10556) == 10752


@pytest.mark.parametrize("step,d_feat,classes", [(0, 16, 5), (3, 602, 16)])
def test_gnn_batch_is_byte_equal(step, d_feat, classes):
    g = powerlaw_graph(512, 4000, alpha=1.0, seed=0, block_size=64)
    jg = j_powerlaw_graph(512, 4000, alpha=1.0, seed=0, block_size=64)
    got, want = gnn_batch(step, g, d_feat, classes), \
        j_gnn_batch(step, jg, d_feat, classes)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


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
    return [line.split("loss")[1].split()[0]
            for line in buf.getvalue().splitlines() if line.startswith("step")]


@pytest.mark.parametrize("name", ["pna", "schnet"])
def test_launcher_prints_the_reference_losses(name, capsys):
    """``launch.train --arch`` from the reference's parameters prints the
    reference's losses to the 4 decimals both print (f32), on the
    reference's graph and batches."""
    want = _reference_main(["--arch", name, "--steps", "11"])
    ja = j_get_arch(name)
    jp = jax.tree.map(np.asarray, ja.init_params(jax.random.key(0),
                                                 ja.reduced_cfg))
    params = MODELS[name][3](jp, get_arch(name).reduced_cfg, device="cpu")
    capsys.readouterr()
    hist = launch_train.train(name, steps=11, device="cpu", params=params)
    got = [line.split("loss")[1].split()[0]
           for line in capsys.readouterr().out.splitlines()
           if line.startswith("step")]
    assert len(want) == 2 and got == want and len(hist) == 11


def test_example_trains_under_another_config(capsys, tmp_path):
    """``examples/train_gnn_torch.py`` on the CPU under SD1: the loss
    falls."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / \
        "train_gnn_torch.py"
    spec = importlib.util.spec_from_file_location("train_gnn_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hist = mod.main(["--steps", "12", "--device", "cpu", "--config", "SD1",
                     "--ckpt", str(tmp_path)])
    assert len(hist) == 12 and hist[-1]["loss"] < hist[0]["loss"]
    assert "under SD1 on cpu" in capsys.readouterr().out


def test_gnn_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    cfg = get_arch("pna").reduced_cfg
    params = P.init_pna(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _batch("pna", cfg)
    for call in (lambda: P.init_pna(cfg, torch.Generator()),
                 lambda: P.pna_forward(cfg, params, b),
                 lambda: P.pna_loss(cfg, params, b)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="parameters are on"):
        P.pna_forward(cfg, params, b, device="meta")
