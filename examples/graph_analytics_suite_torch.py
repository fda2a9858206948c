"""End-to-end pipeline of the PyTorch/CUDA port over the six Table II
stand-ins and every registered app: profile (Eqs. 1-7), specialize
(Fig. 4, or the learned model), run, validate against the numpy oracles.

    PYTHONHASHSEED=0 PYTHONPATH=src python examples/graph_analytics_suite_torch.py \
        [--scale 48] [--graphs DCT RAJ] [--specialize static|learned] \
        [--device cuda|cpu]

``--specialize learned`` reads ``results/torch/specialize_model.json``
(relative to the working directory; run from the repository's root) and
falls back to the static partial tree with a warning when it is absent.
Exits non-zero when a result fails its oracle.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.algorithms import REGISTRY  # noqa: E402
from repro_torch.algorithms import reference as ref  # noqa: E402
from repro_torch.core import SystemConfig, profile_graph, run  # noqa: E402
from repro_torch.graph.datasets import PAPER_GRAPHS, paper_graph  # noqa: E402

#: MIS and CLR draw their priorities from a generator of this seed
KEY_SEED = 0


def validate(app: str, g, res, program) -> bool:
    got = res.extract(program).cpu().numpy()
    if app == "MIS":
        return bool(ref.is_maximal_independent_set(g, got))
    if app == "CLR":
        return bool(ref.is_proper_coloring(g, got))
    if app == "BFS":
        return np.array_equal(got, ref.bfs_np(g))
    if app == "CC":
        return np.array_equal(got, ref.cc_np(g))
    if app == "SSSP":
        want = ref.sssp_np(g)
        return np.allclose(got, want, rtol=1e-5)
    if app == "PR":
        return np.abs(got - ref.pagerank_np(g)).max() < 1e-4
    want = ref.bc_np(g)
    return np.allclose(got, want, rtol=1e-4,
                       atol=1e-5 * float(np.abs(want).max()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=48)
    ap.add_argument("--graphs", nargs="*", default=list(PAPER_GRAPHS))
    ap.add_argument("--specialize", choices=("static", "learned"),
                    default="static")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    total_t0 = time.perf_counter()
    n_ok = n_all = 0
    caller = SystemConfig.from_name("TG0")
    for gname in args.graphs:
        for app, factory in REGISTRY.items():
            program = factory()
            g = paper_graph(gname, scale=args.scale,
                            weighted=program.weighted)
            prof = profile_graph(g)
            key = (torch.Generator().manual_seed(KEY_SEED)
                   if app in ("MIS", "CLR") else None)
            res = run(program, g, caller, key=key, device=args.device,
                      use_kernels=True, specialize=args.specialize)
            ok = bool(res.converged) and validate(app, g, res, program)
            n_ok += ok
            n_all += 1
            dirs = (f" dirs={res.direction_trace}"
                    if res.config_name.startswith("D")
                    and res.direction_trace else "")
            print(f"{gname:>4}/{app:<4} "
                  f"[{prof.volume_class}{prof.reuse_class}"
                  f"{prof.imbalance_class}] -> {res.config_name} "
                  f"({res.config_source})  iters={res.iterations:<4} "
                  f"{res.seconds * 1e3:8.3f}ms  converged={res.converged} "
                  f"valid={ok}{dirs}", flush=True)
    dt = time.perf_counter() - total_t0
    print(f"\nsuite done: {n_ok}/{n_all} validated, {dt:.1f}s total")
    return 0 if n_ok == n_all else 1


if __name__ == "__main__":
    sys.exit(main())
