"""The port's distributed pieces on the CPU: the dry run of one cell in
a subprocess (its fake 256-rank group is process-global), the
``ElasticMesh`` and a resharding restore on a fake group, and a real
4-rank gloo group (a 2 x 2 mesh, which the reference's tests cannot
run on one host device) holding a sharded train step and a sharded MoE
prefill against the unsharded ones."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

#: memory.argument_bytes of repro.launch.dryrun's record for
#: dlrm-mlperf serve_p99 on 16 x 16 (XLA's argument_size_in_bytes)
REF_SERVE_P99_ARGUMENT_BYTES = 6_020_606_340
#: the cell's label input, [512] int32 split 16 ways: the serve step
#: does not read it, and XLA drops an unused argument from the
#: executable; the port holds the shard like every other input
UNUSED_LABEL_BYTES = 512 // 16 * 4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_dryrun_single_cell_subprocess(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dlrm-mlperf", "--shape", "serve_p99", "--mesh", "single",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=_env(), timeout=600,
        cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(
        (tmp_path / "dlrm-mlperf__serve_p99__single.json").read_text())
    assert res["ok"] and res["n_devices"] == 256
    assert res["mesh"] == "16x16" and res["kind"] == "serve"
    assert res["memory"]["argument_bytes"] == \
        REF_SERVE_P99_ARGUMENT_BYTES + UNUSED_LABEL_BYTES
    assert res["memory"]["peak_bytes"] >= res["memory"]["argument_bytes"]
    assert res["cost"]["flops"] > 0 and res["cost"]["flops_scope"] == \
        "per rank"
    assert all(v["count"] > 0 and v["bytes"] > 0
               for v in res["collectives"].values())


# ---------------------------------------------------------------------------
# a fake group in this process
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _fake_world(n):
    """A fake group of ``n`` ranks inside the block; a group that was
    there before it is made again after it (at its own size)."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import ensure_fake_group
    before = dist.get_world_size() if dist.is_initialized() else None
    ensure_fake_group(n)
    try:
        yield n
    finally:
        if before is None:
            dist.destroy_process_group()
        else:
            ensure_fake_group(before)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_the_references(multi_pod):
    """16 x 16 ``("data", "model")`` on 256 ranks, 2 x 16 x 16 ``("pod",
    "data", "model")`` on 512, as ``repro.launch.mesh`` builds them; a
    spec over dp and tp leaves each rank its block; a group of the other
    size is refused."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import P, axes_for_mesh, to_placements
    from repro_torch.launch.mesh import make_production_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    with _fake_world(int(np.prod(shape))):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        assert mesh.device_type == "cpu"
        ax = axes_for_mesh(mesh)
        assert ax.dp == (("pod", "data") if multi_pod else ("data",))
        assert ax.tp == "model" and ax.dp_size == (32 if multi_pod else 16)
        w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                              to_placements(P(ax.dp, ax.tp), mesh))
        assert tuple(w.to_local().shape) == (64 // ax.dp_size, 2)
        with pytest.raises(ValueError, match="ranks"):
            make_production_mesh(multi_pod=not multi_pod)


@pytest.fixture(scope="module")
def traced_train_cell():
    """A reduced starcoder2-7b train cell (8 x 64 tokens in 2
    microbatches, meta tensors) on a fake 2 x 2 mesh, its step run under
    ``RankTrace`` and under each of the torch tools it stands in for.
    DTensor's sharding propagation runs ops on fake tensors of the
    global shapes, which a mode below DTensor sees; a first run fills
    its cache, so that the later runs issue only each rank's own ops.
    ``FlopCounterMode`` and ``MemTracker`` run under a mode that lets
    DTensor unwrap first, so they too count rank 0's local ops;
    ``CommDebugMode`` does so itself, and a subclass adds each counted
    collective's result bytes."""
    import collections
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import (axes_for_mesh, distribute_params,
                                          distribute_tree, lm_param_sharding,
                                          lm_train_cell)
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.dryrun import COLLECTIVE_KINDS, RankTrace
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.mesh_compat import use_mesh
    from repro_torch.models.transformer import (abstract_lm_params,
                                                train_forward)
    from repro_torch.optim.adamw import adamw_init

    class LocalOps(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            return func(*args, **(kwargs or {}))

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.nbytes = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n = sum(self.comm_counts.values())
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if sum(self.comm_counts.values()) > n:
                self.nbytes[COLLECTIVE_KINDS[func._overloadpacket.__name__]] \
                    += sum(t.numel() * t.element_size()
                           for t in (out if isinstance(out, (list, tuple))
                                     else [out]))
            return out

    with _fake_world(4):
        mesh = make_local_mesh(n_model=2)
        ax = axes_for_mesh(mesh)
        cfg = dataclasses.replace(
            get_arch("starcoder2-7b").reduced_cfg, dp_axes=tuple(ax.dp),
            tp_axis=ax.tp, sp_axis=ax.tp)
        cell = lm_train_cell(cfg, "train", 8, 64, train_forward,
                             microbatches=2)
        params = abstract_lm_params(cfg)
        distribute_params(params, mesh, lm_param_sharding(cfg, ax))
        opt = adamw_init(params)
        inputs = distribute_tree(cell.input_specs(), mesh,
                                 cell.input_sharding(ax))
        step = cell.make_step(torch.device("meta"))

        def run(*modes):
            with contextlib.ExitStack() as stack:
                stack.enter_context(use_mesh(mesh))
                for m in modes:
                    stack.enter_context(m)
                step(params, opt, inputs)

        run()
        rt, fc, cm, mt = (RankTrace(), FlopCounterMode(display=False),
                          CommBytes(), MemTracker())
        run(rt)
        run(fc, LocalOps())
        run(cm)
        run(mt, LocalOps())
    peaks = mt.get_tracker_snapshot("peak")
    return dict(
        rank_trace=dict(flops=rt.flops, peak=rt.peak_bytes,
                        collectives=rt.collectives),
        flops=fc.get_total_flops(),
        collectives={COLLECTIVE_KINDS[k.__name__]: {
            "count": v, "bytes": cm.nbytes[COLLECTIVE_KINDS[k.__name__]]}
            for k, v in cm.comm_counts.items()},
        peak_meta=peaks[torch.device("meta")]["Total"],
        peak_all=sum(v["Total"] for v in peaks.values()))


@pytest.mark.parametrize("tool", ["FlopCounterMode", "CommDebugMode",
                                  "MemTracker"])
def test_rank_trace_counts_as_the_torch_tools(traced_train_cell, tool):
    """``RankTrace``'s per-rank FLOPs equal ``FlopCounterMode``'s, its
    collectives per kind (count and result bytes) ``CommDebugMode``'s,
    and its peak lies between ``MemTracker``'s peak on the meta device
    (where the step's tensors live) and its peak summed over devices."""
    got = traced_train_cell["rank_trace"]
    if tool == "FlopCounterMode":
        assert got["flops"] > 0
        assert got["flops"] == traced_train_cell["flops"]
    elif tool == "CommDebugMode":
        assert set(got["collectives"]) == {"all-gather", "all-reduce",
                                           "reduce-scatter"}
        assert got["collectives"] == traced_train_cell["collectives"]
    else:
        assert traced_train_cell["peak_meta"] > 0
        assert traced_train_cell["peak_meta"] <= got["peak"] \
            <= traced_train_cell["peak_all"]


@pytest.fixture(scope="module")
def fake24():
    import torch.distributed as dist
    from repro_torch.launch.dryrun import ensure_fake_group
    ensure_fake_group(24)
    yield 24
    dist.destroy_process_group()


def test_elastic_mesh_keeps_the_model_axis(fake24):
    from repro_torch.train.fault_tolerance import ElasticMesh
    em = ElasticMesh(model_parallel=8)
    mesh = em.build()
    assert tuple(mesh.shape) == (3, 8)
    assert mesh.mesh_dim_names == ("data", "model")
    # lose a quarter of the ranks: the data axis shrinks, model stays
    small = em.build(list(range(20)))
    assert tuple(small.shape) == (2, 8)


def test_elastic_mesh_data_axis_takes_every_rank(fake24):
    """``test_train.py``'s first case: model_parallel=1 -> the data
    axis is every rank."""
    from repro_torch.train.fault_tolerance import ElasticMesh
    mesh = ElasticMesh(model_parallel=1).build()
    assert tuple(mesh.shape) == (fake24, 1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"w": torch.arange(10, dtype=torch.int32),
                  "s": torch.tensor(3.5)}}


def test_elastic_reshard_roundtrip(fake24):
    """``test_train.py``'s second case: replicated on the rebuilt mesh,
    every value as it was; and a sharded spec leaves this rank's shard
    of each leaf."""
    from repro_torch.configs.base import P
    from repro_torch.train.fault_tolerance import ElasticMesh
    em = ElasticMesh(model_parallel=8)
    mesh = em.build()
    t = _tree()
    t2 = em.reshard(t, mesh, None)
    np.testing.assert_array_equal(t2["a"].to_local().numpy(),
                                  t["a"].numpy())
    np.testing.assert_array_equal(t2["b"]["w"].to_local().numpy(),
                                  t["b"]["w"].numpy())
    t3 = em.reshard(t, mesh, {"a": P("data", "model"),
                              "b": {"w": P(None), "s": P()}})
    # rank 0 holds rows 0..2 of 8 (3 data ranks) and cols 0..1 of 16
    np.testing.assert_array_equal(t3["a"].to_local().numpy(),
                                  t["a"][:3, :2].numpy())
    assert tuple(t3["a"].shape) == (8, 16)


def test_restore_reshards_onto_another_mesh(fake24, tmp_path):
    """A checkpoint saved from plain tensors, restored with
    ``shardings=`` onto a 3 x 8 mesh and, separately, into DTensors of
    another layout: each rank's shards are its slices of the saved
    values, bit for bit."""
    from repro_torch.configs.base import P
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.fault_tolerance import ElasticMesh
    t = _tree(1)
    save_checkpoint(tmp_path, 3, t)
    mesh = ElasticMesh(model_parallel=8).build()
    like = {"a": torch.zeros(8, 16),
            "b": {"w": torch.zeros(10, dtype=torch.int32),
                  "s": torch.tensor(0.0)}}
    got, step, _ = restore_checkpoint(
        tmp_path, like, shardings=(mesh, {"a": P("model", "data"),
                                          "b": {"w": P("data"), "s": P()}}))
    assert step == 3
    np.testing.assert_array_equal(got["a"].to_local().numpy(),
                                  t["a"][:1, :6].numpy())
    np.testing.assert_array_equal(got["b"]["w"].to_local().numpy(),
                                  t["b"]["w"][:4].numpy())
    assert got["b"]["s"].to_local().item() == 3.5
    # into existing DTensors: their local shards are filled in place
    again, _, _ = restore_checkpoint(tmp_path, got)
    assert again["a"] is got["a"]
    np.testing.assert_array_equal(again["a"].to_local().numpy(),
                                  t["a"][:1, :6].numpy())


# ---------------------------------------------------------------------------
# a real 4-rank gloo group
# ---------------------------------------------------------------------------
_GLOO = textwrap.dedent('''
    import dataclasses, json, socket, sys
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, world, port, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.configs.base import (axes_for_mesh, distribute_params,
                                              distribute_tree, lm_param_sharding,
                                              lm_train_step)
        from repro_torch.configs.registry import get_arch
        from repro_torch.data.synthetic import lm_batch
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import moe as M, transformer as T
        from repro_torch.models.mesh_compat import use_mesh
        from repro_torch.optim.adamw import adamw_init
        mesh = make_local_mesh(n_model=2)
        ax = axes_for_mesh(mesh)
        res = {}

        # starcoder2-7b reduced, f32: one step of 8 x 64 tokens in 2
        # microbatches, sharded against unsharded
        arch = get_arch("starcoder2-7b", axes=ax)
        cfg = dataclasses.replace(arch.cfg.__class__(**{
            **dataclasses.asdict(arch.reduced_cfg), "param_dtype": "float32"}),
            dp_axes=tuple(ax.dp), tp_axis=ax.tp, sp_axis=ax.tp)
        plain = dataclasses.replace(cfg, dp_axes=(), tp_axis=None, sp_axis=None)
        batch = {k: torch.from_numpy(v)
                 for k, v in lm_batch(0, 8, 64, cfg.vocab).items()}
        ref = T.init_lm(plain, torch.Generator().manual_seed(0), device="cpu")
        params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        distribute_params(params, mesh, lm_param_sharding(cfg, ax))
        binp = distribute_tree(batch, mesh,
                               arch.cell("train_4k").input_sharding(ax))
        with use_mesh(mesh):
            p2, _, m2 = lm_train_step(cfg, 8, 64, 2, device="cpu")(
                params, adamw_init(params), binp)
        r2, _, rm = lm_train_step(plain, 8, 64, 2, device="cpu")(
            ref, adamw_init(ref), batch)
        res["train"] = dict(
            loss=[float(m2["loss"]), float(rm["loss"])],
            grad_norm=[float(m2["grad_norm"]), float(rm["grad_norm"])],
            params={n: [a.full_tensor().tolist(), b.tolist()]
                    for (n, a), (_, b) in zip(p2.named_parameters(),
                                              r2.named_parameters())})

        # qwen3-moe reduced, f32, dispatch_groups=2 (the 2 x 2 mesh's dp):
        # a prefill of 4 x 16 tokens, the routing of every layer
        march = get_arch("qwen3-moe-235b-a22b", axes=ax)
        mcfg = dataclasses.replace(march.cfg.__class__(**{
            **dataclasses.asdict(march.reduced_cfg), "param_dtype": "float32"}),
            dp_axes=tuple(ax.dp), tp_axis=ax.tp, sp_axis=ax.tp,
            moe_mode="ep", dispatch_groups=2)
        mplain = dataclasses.replace(mcfg, dp_axes=(), tp_axis=None,
                                     sp_axis=None)
        tokens = torch.from_numpy(lm_batch(1, 4, 16, mcfg.vocab)["tokens"])
        mref = M.init_moe_lm(mplain, torch.Generator().manual_seed(1), "cpu")
        mp_ = M.init_moe_lm(mcfg, torch.Generator().manual_seed(1), "cpu")
        distribute_params(mp_, mesh, lm_param_sharding(mcfg, ax, "ep"))
        dtok = distribute_tree({"t": tokens}, mesh, {"t": (ax.dp, None)})["t"]
        got, want = [], []
        with use_mesh(mesh):
            lg, _ = M.moe_prefill(mcfg, mp_, dtok, device="cpu", routing=got)
        lw, _ = M.moe_prefill(mplain, mref, tokens, device="cpu", routing=want)
        res["moe"] = dict(
            routing=[[g[k].full_tensor().tolist() for k in ("expert_idx",
                                                             "keep")]
                     for g in got],
            want=[[w[k].tolist() for k in ("expert_idx", "keep")]
                  for w in want],
            logits=[lg.full_tensor().tolist(), lw.tolist()])
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        mp.spawn(worker, args=(4, port, sys.argv[1]), nprocs=4, join=True)
''')


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    script = d / "run.py"
    script.write_text(_GLOO)
    out = d / "out.json"
    run = subprocess.run([sys.executable, str(script), str(out)],
                         capture_output=True, text=True, env=_env(),
                         timeout=600, cwd=str(REPO))
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(out.read_text())


def test_sharded_train_step_equals_unsharded_on_four_ranks(gloo_run):
    """The reduced starcoder2-7b's step (f32, 2 microbatches, AdamW) on a
    2 x 2 gloo mesh against the unsharded step, at ``chip_smoke.py``'s
    f32 ``TRAIN_TOL``: loss and grad norm rtol 1e-5, parameters rtol
    1e-5 atol 1e-4."""
    t = gloo_run["train"]
    np.testing.assert_allclose(*t["loss"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(*t["grad_norm"], rtol=1e-5, atol=0)
    assert len(t["params"]) == len(list(
        _reduced_lm_param_names()))
    for n, (a, b) in t["params"].items():
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-4, err_msg=n)


def _reduced_lm_param_names():
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T
    return [n for n, _ in T.abstract_lm_params(
        get_arch("starcoder2-7b").reduced_cfg).named_parameters()]


def test_sharded_moe_prefill_routes_as_unsharded_on_four_ranks(gloo_run):
    """The reduced qwen3-moe's prefill with dispatch_groups=2 on the
    2 x 2 mesh (routing, dispatch and combine in ``local_map`` over the
    groups): every layer's experts and kept slots equal the unsharded
    prefill's, and the last-token logits agree to f32 rounding."""
    m = gloo_run["moe"]
    assert len(m["routing"]) == len(m["want"]) == 2
    for got, want in zip(m["routing"], m["want"]):
        assert got == want
    np.testing.assert_allclose(*m["logits"], rtol=1e-4, atol=1e-4)
