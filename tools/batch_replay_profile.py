#!/usr/bin/env python3
"""Profile one replay of a captured batch against one of a single graph.

    python3 tools/batch_replay_profile.py [--config SG0] [--sizes 1,4,16,32]
                                          [--out FILE]

On the batch benchmark's pinned workload (``repro_torch.benchmarks.batch``:
R-MAT scale 6, BFS), taking B graphs of its most common padding bucket
(one packed batch) for each batch size B, the batched engine is
captured by one ``run_batch``, then a single launch of its graph (the
first ``STEPS_PER_LAUNCH`` guarded steps, from the initial state) runs
under ``torch.profiler``; the same for the sequential fused engine of
the first graph.  Only the replay is profiled: no packing, upload or
unpacking.  Prints, per B, the launch's device ops, busy ms and the ops
with the most time, and with ``--out`` writes them as JSON.  Needs CUDA
and ``nvcc``.
"""
import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.algorithms import REGISTRY  # noqa: E402
from repro_torch.benchmarks.batch import (APP, PINNED_WORKLOAD,  # noqa: E402
                                          SIZES)
from repro_torch.core import (BatchedEdgeContext, EdgeContext,  # noqa: E402
                              SystemConfig, bucket_key, capture,
                              get_graph_batch, run, run_batch)
from repro_torch.core.executor import _trace_flags  # noqa: E402
from repro_torch.graph import rmat_batch  # noqa: E402


def _profile_launch(ex, state) -> dict:
    """One launch of ``ex``'s graph from ``state``, profiled."""
    ex.reset(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ex.launch()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in ops:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(ops=len(ops), busy_ms=sum(v[0] for v in by_name.values()),
                iterations=int(ex.it), top=[
                    dict(name=n[:90], ms=ms, count=c) for n, (ms, c) in top])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="SG0")
    ap.add_argument("--sizes", default="1,4,16,32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    config = SystemConfig.from_name(args.config)
    sizes = [int(b) for b in args.sizes.split(",")]
    program = REGISTRY[APP]()
    graphs = rmat_batch(max(SIZES), **PINNED_WORKLOAD)
    common = collections.Counter(map(bucket_key, graphs)).most_common(1)
    graphs = [g for g in graphs if bucket_key(g) == common[0][0]]
    sizes = [b for b in sizes if b <= len(graphs)]
    record = {}
    # the sequential engine of the first graph
    run(program, graphs[0], config, device=dev)
    ctx = EdgeContext.create(graphs[0], config, device=dev)
    state = {k: torch.as_tensor(v).to(dev)
             for k, v in program.init(graphs[0]).items()}
    traced, occ = _trace_flags(program, state)
    ex = capture.cached_engine(program, ctx,
                               (program.max_iters, traced, occ), None)
    record["sequential"] = _profile_launch(ex, state)
    for b in sizes:
        gs = graphs[:b]
        run_batch(program, gs, config, device=dev)
        batch = get_graph_batch(gs)
        bctx = BatchedEdgeContext.create(batch, config, device=dev)
        packed = {k: v.to(dev) for k, v in batch.pack_state(
            [program.init(g) for g in gs], pad=program.state_pad).items()}
        ex = capture.cached_engine(
            program, bctx.inner,
            ("batched", bctx.B, bctx.n_q, bctx.m_q, program.max_iters,
             traced, occ, bctx.cap_key), None)
        record[f"B={b}"] = _profile_launch(ex, packed)
    for label, r in record.items():
        print(f"{label}: iterations={r['iterations']} ops={r['ops']} "
              f"busy_ms={r['busy_ms']:.4f}", flush=True)
        for t in r["top"]:
            print(f"  {t['ms']:.4f} ms {t['count']}x {t['name']}")
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
