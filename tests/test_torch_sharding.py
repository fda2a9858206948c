"""The port's sharding specs against the reference's
(``repro.configs.base``): every arch's parameter sharding on both
production meshes, every cell's input specs and shardings, the abstract
parameters against ``jax.eval_shape`` of the reference's init at the
full configs, the roofline's analytic terms, and the spec -> placement
bridge.  No devices are needed: the meshes are stand-ins with
``axis_names`` and ``shape``, the DTensor cases a fake process group."""
import jax
import pytest
import torch

from repro.configs.base import axes_for_mesh as j_axes_for_mesh
from repro.configs.registry import get_arch as j_get_arch
from repro_torch.configs.base import P, axes_for_mesh, to_placements
from repro_torch.configs.registry import ARCH_NAMES, get_arch

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
LM_FAMILIES = ("lm", "moe")


def _mesh(sizes):
    return type("Mesh", (), {"axis_names": tuple(sizes), "shape": sizes})()


def _norm(spec) -> tuple:
    """A spec's entries, a one-axis tuple written as the axis (newer jax
    normalises ``("data",)`` so; the two place a tensor alike)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else tuple(e) if isinstance(e, tuple) else e
                 for e in spec)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _flat(tree):
    """{path: leaf} of a reference pytree, the path's keys joined by '.'
    (lists by index), PartitionSpecs kept whole."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(_key(k) for k in path): leaf for path, leaf in leaves}


def _port_names(flat_ref, family, n_layers):
    """The reference's flat paths as the port's parameter names: the
    stacked blocks per layer (their leading layer dimension dropped by
    ``drop``), DLRM's tables ``table_<i>``."""
    out = {}
    for path, leaf in flat_ref.items():
        if family in LM_FAMILIES and path.startswith("blocks."):
            for i in range(n_layers):
                out[f"blocks.{i}.{path[len('blocks.'):]}"] = ("drop", leaf)
        elif path.startswith("tables."):
            out[f"table_{path.split('.')[1]}"] = ("keep", leaf)
        else:
            out[path] = ("keep", leaf)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_sharding_is_the_references(name, mesh):
    m = _mesh(MESHES[mesh])
    ax, jax_ax = axes_for_mesh(m), j_axes_for_mesh(m)
    assert (ax.dp, ax.tp, ax.all_axes, ax.dp_size) == (
        tuple(jax_ax.dp), jax_ax.tp, tuple(jax_ax.all_axes), jax_ax.dp_size)
    arch, ref = get_arch(name, axes=ax), j_get_arch(name, axes=jax_ax)
    got, want = arch.param_sharding(ax), ref.param_sharding(jax_ax)
    if want is None:
        assert got is None and arch.family == "gnn"
        return
    expected = {}
    for n, (how, spec) in _port_names(_flat(want), arch.family,
                                      getattr(arch.cfg, "n_layers", 0)).items():
        entries = _norm(spec)
        if how == "drop":
            assert entries[0] is None, (n, spec)
            entries = entries[1:]
        expected[n] = entries
    assert {n: _norm(s) for n, s in got.items()} == expected
    assert set(got) == {n for n, _ in arch.abstract_params()
                        .named_parameters()}


def _cells():
    return [(a, s) for a in ARCH_NAMES for s in sorted(get_arch(a).cells)]


_DT = {"int32": torch.int32, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("name,shape", _cells())
def test_cell_inputs_are_the_references(name, shape):
    cell, ref = get_arch(name).cell(shape), j_get_arch(name).cell(shape)
    assert cell.kind == ref.kind
    assert cell.needs_opt == ref.needs_opt
    got, want = cell.input_specs(), ref.input_specs()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert got[k].dtype == _DT[str(v.dtype)], k
    for mesh in MESHES.values():
        m = _mesh(mesh)
        gs = cell.input_sharding(axes_for_mesh(m))
        ws = ref.input_sharding(j_axes_for_mesh(m))
        assert {k: _norm(s) for k, s in gs.items()} == \
            {k: _norm(s) for k, s in ws.items()}


def _abstract_cases():
    out = []
    for a in ARCH_NAMES:
        if get_arch(a).family == "gnn":
            out += [(a, s) for s in sorted(get_arch(a).cells)]
        else:
            out.append((a, None))
    return out


@pytest.mark.parametrize("name,shape", _abstract_cases())
def test_abstract_params_are_the_references_at_full_size(name, shape):
    arch, ref = get_arch(name), j_get_arch(name)
    if shape is None:
        got, want = arch.abstract_params(), ref.abstract_params()
    else:
        got, want = arch.abstract_params_for(shape), \
            ref.abstract_params_for(shape)
    expected = {}
    for n, (how, leaf) in _port_names(_flat(want), arch.family,
                                      getattr(arch.cfg, "n_layers", 0)).items():
        shp = tuple(leaf.shape)[1:] if how == "drop" else tuple(leaf.shape)
        expected[n] = (shp, _DT[str(leaf.dtype)])
    have = {}
    for n, p in got.named_parameters():
        assert p.device.type == "meta", n
        have[n] = (tuple(p.shape), p.dtype)
    if arch.family == "gnn":
        # the reference stacks a GNN's blocks along a leading layer
        # dimension (blocks.*); the port keeps a list of blocks whose
        # attribute names need not be the pytree's: every leaf's shape
        # and type, per layer, as a multiset
        want_leaves = []
        for path, leaf in _flat(want).items():
            if path.startswith("blocks."):
                want_leaves += [(tuple(leaf.shape)[1:], str(leaf.dtype))] \
                    * leaf.shape[0]
            else:
                want_leaves.append((tuple(leaf.shape), str(leaf.dtype)))
        got_leaves = [(shp, str(dt).replace("torch.", ""))
                      for shp, dt in have.values()]
        assert sorted(got_leaves) == sorted(want_leaves)
        return
    assert have == expected


@pytest.mark.parametrize("name,shape", [
    (a, s) for a in ARCH_NAMES for s in sorted(get_arch(a).cells)])
def test_analytic_roofline_terms_are_the_references(name, shape):
    import benchmarks.roofline as jroof
    from repro_torch.benchmarks import roofline
    assert roofline.analytic_cell(name, shape) == \
        jroof.analytic_cell(name, shape)


def test_roofline_uses_h100_peaks():
    from repro_torch.benchmarks import roofline
    assert roofline.H100_BF16_FLOPS == 989e12
    assert roofline.H100_HBM_BW == 3.35e12
    assert roofline.H100_NIC_BW == 50e9


class _Dims:
    def __init__(self, names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec,names,want", [
    (P(("data",), "model"), ("data", "model"), "S0 S1"),
    (P("model", ("data",)), ("data", "model"), "S1 S0"),
    (P(None, ("pod", "data"), "model"), ("pod", "data", "model"),
     "S1 S1 S2"),
    (P(("pod", "data", "model")), ("pod", "data", "model"), "S0 S0 S0"),
    (P(None, ("pod", "data")), ("pod", "data", "model"), "S1 S1 R"),
    (P("model", ("pod", "data")), ("pod", "data", "model"), "S1 S1 S0"),
    (P(), ("data", "model"), "R R"),
    (None, ("data", "model"), "R R"),
])
def test_to_placements(spec, names, want):
    from torch.distributed.tensor import Shard
    got = to_placements(spec, _Dims(names))
    assert " ".join(f"S{p.dim}" if isinstance(p, Shard) else "R"
                    for p in got) == want


@pytest.mark.parametrize("spec,names", [
    (P(("data", "pod")), ("pod", "data", "model")),   # out of mesh order
    (P("data", "data"), ("data", "model")),           # an axis twice
    (P("expert"), ("data", "model")),                 # not the mesh's
    (P("pod", "pod"), ("pod", "data", "model")),      # on two dims
])
def test_to_placements_refuses(spec, names):
    with pytest.raises(ValueError):
        to_placements(spec, _Dims(names))


def test_unsharded_archs_keep_todays_configs():
    """No axes: the configs are the unsharded ones every caller had."""
    for name in ARCH_NAMES:
        cfg = get_arch(name).cfg
        if hasattr(cfg, "tp_axis"):
            assert cfg.tp_axis is None and cfg.dp_axes == ()
