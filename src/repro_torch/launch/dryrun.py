"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): run every
(arch x input-shape) cell's step once on a production mesh of 256 or
512 ranks that exist only as a ``torch.distributed`` ``"fake"`` process
group, and record each rank's memory, FLOPs and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-7b \\
        --shape train_4k --mesh both --out results/torch/dryrun

This proves the distribution config coherent without the hardware: a
spec DTensor cannot place, an op without a sharding rule or a step that
does not run fails the cell.  The fake group and its CPU ``DeviceMesh``
exist only in this process (``init_process_group`` is process-global; a
second mesh size re-initialises the group), so tests and benchmarks
keep their own.

One cell: the parameters are built on the meta device (nothing is
allocated or drawn) and distributed by ``arch.param_sharding``, the
AdamW state by ``adamw_init`` on them (the moments take the parameters'
placements: ``opt_sharding_like``), the inputs by
``cell.input_sharding``, all as DTensors over meta shards.  The step
runs once under ``mesh_compat.use_mesh`` and :class:`RankTrace`, a
dispatch mode that sees each rank's local ops (DTensor unwraps first):

- the collectives DTensor issues: per kind, the count and the bytes of
  each rank's results (an all-gather's gathered tensor, a
  reduce-scatter's shard), the reference's "per-device result shapes";
- FLOPs per rank, by ``FlopCounterMode``'s formulas on the local ops
  (so ``local_map`` regions and DTensor ops count alike);
- the peak bytes the step allocates on a rank, as ``MemTracker``
  counts them.

``tests/test_torch_dryrun.py`` holds these three against
``FlopCounterMode``, ``CommDebugMode`` and ``MemTracker`` on a reduced
train cell.  The two-pod cells run on the reference's 2 x 16 x 16 mesh:
DTensor moves a tensor split over pod and data as one collective per
mesh dimension, and the records count each.

``memory.argument_bytes`` is one rank's shards of parameters, optimizer
state and inputs (rank 0's, the largest where a dimension does not
divide); ``memory.peak_bytes`` adds the step's tracked peak to it.
Every path is the plain one (``blocked_attention``, the plain embedding
bag, the scatter reductions), as the reference's dry run lowers its XLA
paths.  The fake group's CPU mesh has no all-to-all: DTensor moves a
shard from one dimension to another as an all-gather and a local
chunk, so such moves count as all-gathers.  Records keep the
reference's keys (``arch``, ``shape``, ``mesh``, ``n_devices``,
``kind``, ``memory.peak_bytes``, ``cost.flops``,
``collectives.{kind: {count, bytes}}``, ``ok``), which
``repro_torch.benchmarks.roofline`` reads.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["run_cell", "ensure_fake_group", "RankTrace",
           "COLLECTIVE_KINDS", "main"]

#: the functional collectives DTensor issues -> the reference's kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

#: the port's own source, for attributing a collective to its caller
_SRC = str(Path(__file__).resolve().parents[1])


def ensure_fake_group(world_size: int) -> None:
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    being rank 0; an existing group of another size is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _caller() -> str:
    """``file:function`` of the innermost frame of the port's models,
    optimizer or configs on the stack."""
    for fr in reversed(traceback.extract_stack()):
        f = fr.filename
        if f.startswith(_SRC) and "/launch/" not in f:
            return f"{f[len(_SRC) + 1:]}:{fr.name}"
    return "?"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankTrace(TorchDispatchMode):
    """One dispatch mode over each rank's local ops (a DTensor op is let
    through to run as its local ops first) that keeps

    - ``collectives``: per kind, the count and the bytes of this rank's
      results of the functional collectives DTensor issues, and
      ``sites``, the bytes per (kind, caller);
    - ``flops``: FLOPs by ``FlopCounterMode``'s formulas, and by op;
    - ``peak_bytes``: the most bytes of storage alive at once among the
      tensors the step allocates (each storage counted once, freed when
      its last tensor dies), as ``MemTracker`` counts them.

    ``CommDebugMode``, ``FlopCounterMode`` and ``MemTracker`` stacked
    took 84 s where this takes 13 s (starcoder2-7b train_4k cut to two
    layers, one CPU core): each mode's per-op bookkeeping (module
    trees, operation lists, fake-mode probes) costs more than the meta
    op it watches.  On a reduced train cell its three figures equal
    theirs (``test_rank_trace_counts_as_the_torch_tools``)."""

    def __init__(self, sites: bool = False):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.by_op = collections.Counter()
        self.collectives = {}
        self.sites = collections.Counter() if sites else None
        self.live = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not None:
            # DTensor's sharding propagation runs ops on fake tensors of
            # the global shapes to learn the outputs' metadata: no rank
            # runs them
            return out
        packet = func._overloadpacket
        fn = self.registry.get(packet)
        if fn is not None:
            n = fn(*args, **kwargs, out_val=out)
            self.flops += n
            self.by_op[str(packet)] += n
        kind = COLLECTIVE_KINDS.get(getattr(packet, "__name__", ""))
        if kind is not None:
            b = sum(_nbytes(t) for t in _tensors(out))
            c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += b
            if self.sites is not None:
                self.sites[(kind, _caller())] += b
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def exclude(self, tensors) -> None:
        """Storages that exist before the step (its arguments, counted
        apart): a view of one is not a new allocation."""
        from torch.distributed.tensor import DTensor
        for t in tensors:
            local = t._local_tensor if isinstance(t, DTensor) else t
            self._seen[local.untyped_storage()] = 0


def _local_bytes(tensors) -> int:
    """Bytes of this rank's shards of ``tensors`` (each storage once)."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in tensors:
        local = t._local_tensor if isinstance(t, DTensor) else t
        key = (id(local.untyped_storage()) if local.device.type != "meta"
               else id(local))
        if key in seen:
            continue
        seen.add(key)
        total += _nbytes(local)
    return total


def _build(arch_name: str, shape_name: str, multi_pod: bool,
           layers: Optional[int] = None):
    """The mesh, the cell, and its step's arguments, distributed."""
    from repro_torch.configs.base import (axes_for_mesh, distribute_params,
                                          distribute_tree, to_placements,
                                          opt_sharding_like)
    from repro_torch.configs.registry import get_arch, with_layers
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, \
        make_production_mesh
    from repro_torch.optim.adamw import adamw_init
    shape, _ = PRODUCTION_SHAPES[bool(multi_pod)]
    world = 1
    for s in shape:
        world *= s
    ensure_fake_group(world)
    mesh = make_production_mesh(multi_pod=multi_pod)
    ax = axes_for_mesh(mesh)
    arch = get_arch(arch_name, axes=ax) if layers is None \
        else with_layers(arch_name, layers, axes=ax)
    cell = arch.cell(shape_name)
    params = (arch.abstract_params_for(shape_name)
              if arch.abstract_params_for is not None
              else arch.abstract_params())
    spec = arch.param_sharding(ax)
    distribute_params(params, mesh, spec)
    args = [params]
    if cell.needs_opt:
        opt = adamw_init(params)
        if spec is not None:      # the moments mirror the parameters
            want = opt_sharding_like(spec)
            for k in ("mu", "nu"):
                for n, t in opt[k].items():
                    assert list(t.placements) == to_placements(want[k][n],
                                                               mesh), n
        args.append(opt)
    args.append(distribute_tree(cell.input_specs(), mesh,
                                cell.input_sharding(ax)))
    return mesh, cell, args


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, sites: Optional[list] = None,
             layers: Optional[int] = None) -> dict:
    """One cell's record (the keys above).  ``sites``, when given, gets
    ``((kind, caller), bytes)`` pairs for every collective call site.
    ``layers`` cuts an LM's depth (the record says so: ``layers``)."""
    from repro_torch.models.mesh_compat import use_mesh
    t0 = time.time()
    mesh, cell, args = _build(arch_name, shape_name, multi_pod, layers)
    result = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size(), "kind": cell.kind,
        "layers": layers if layers is not None else "all",
        "build_s": round(time.time() - t0, 1),
    }
    arg_tensors = list(_tensors(args[1:])) + [
        p for _, p in args[0].named_parameters()]
    arg_bytes = _local_bytes(arg_tensors)
    step = cell.make_step(torch.device("meta"))
    trace = RankTrace(sites=sites is not None)
    trace.exclude(arg_tensors)
    t1 = time.time()
    with use_mesh(mesh), trace:
        out = step(*args)
    result["step_s"] = round(time.time() - t1, 1)
    arg_ids = {id(t) for t in arg_tensors}
    outs = [t for t in _tensors(out) if id(t) not in arg_ids]
    result["memory"] = {"argument_bytes": arg_bytes,
                        "output_bytes": _local_bytes(outs),
                        "step_peak_bytes": int(trace.peak_bytes),
                        "peak_bytes": arg_bytes + int(trace.peak_bytes)}
    result["cost"] = {"flops": float(trace.flops), "flops_scope": "per rank",
                      "flops_by_op": {k: float(v) for k, v in
                                      trace.by_op.most_common()}}
    result["collectives"] = trace.collectives
    if sites is not None:
        sites.extend(trace.sites.items())
    result["total_s"] = round(time.time() - t0, 1)
    result["ok"] = True
    if verbose:
        print(json.dumps({k: v for k, v in result.items()
                          if k != "cost"} | {"flops": result["cost"]["flops"]}),
              flush=True)
    return result


def _cells(arch: str, shape: str):
    from repro_torch.configs.registry import ARCH_NAMES, get_arch
    for a in (ARCH_NAMES if arch == "all" else [arch]):
        cells = get_arch(a).cells
        for s in (sorted(cells) if shape == "all" else [shape]):
            yield a, s


def _tag(arch_name, shape_name, multi) -> str:
    return f"{arch_name}__{shape_name}__{'multi' if multi else 'single'}"


def _one(arch_name, shape_name, multi, out: Path, layers=None) -> dict:
    tag = _tag(arch_name, shape_name, multi)
    print(f"=== {tag}", flush=True)
    try:
        res = run_cell(arch_name, shape_name, multi, layers=layers)
    except Exception as exc:
        res = {"arch": arch_name, "shape": shape_name,
               "mesh": "multi" if multi else "single",
               "ok": False, "error": str(exc)[:2000],
               "traceback": traceback.format_exc()[-4000:]}
        print(f"FAIL {tag}: {str(exc)[:500]}", flush=True)
    (out / f"{tag}.json").write_text(json.dumps(res, indent=2))
    return res


def main(argv=None):
    from repro_torch.configs.registry import ARCH_NAMES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_NAMES} or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each LM's depth to this many layers (widths "
                         "kept; the records say so)")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    todo = []
    n_skipped = 0
    for a, s in _cells(args.arch, args.shape):
        for multi in meshes:
            path = out / f"{_tag(a, s, multi)}.json"
            if args.skip_existing and path.exists() \
                    and json.loads(path.read_text()).get("ok"):
                n_skipped += 1
                continue
            todo.append((a, s, multi))
    if args.jobs > 1 and len(todo) > 1:
        # the LMs' train and prefill cells take minutes: start them first
        todo.sort(key=lambda c: c[1] not in ("train_4k", "prefill_32k"))
        _run_jobs(todo, out, args.jobs, args.layers)
    else:
        for a, s, multi in todo:
            _one(a, s, multi, out, _layers_of(a, args.layers))
    n_fail = 0
    for a, s, multi in todo:
        path = out / f"{_tag(a, s, multi)}.json"
        n_fail += not (path.exists()
                       and json.loads(path.read_text()).get("ok"))
    n_ok = n_skipped + len(todo) - n_fail
    print(f"dryrun complete: {n_ok} ok, {n_fail} failed", flush=True)
    raise SystemExit(1 if n_fail else 0)


def _layers_of(arch_name: str, layers: Optional[int]) -> Optional[int]:
    from repro_torch.configs.registry import get_arch
    return layers if get_arch(arch_name).family in ("lm", "moe") else None


def _run_jobs(todo, out: Path, jobs: int, layers=None) -> None:
    """Each cell in its own ``python -m repro_torch.launch.dryrun``
    process, ``jobs`` at a time."""
    pending = list(todo)
    running = []
    while pending or running:
        while pending and len(running) < jobs:
            a, s, multi = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s,
                   "--mesh", "multi" if multi else "single",
                   "--out", str(out)]
            if layers is not None:
                cmd += ["--layers", str(layers)]
            running.append(subprocess.Popen(cmd))
        time.sleep(0.2)
        for p in list(running):
            if p.poll() is not None:
                running.remove(p)


if __name__ == "__main__":
    main()
