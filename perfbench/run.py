"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's graph on the card from the seed
(:mod:`perfbench.generators`), hands its COO arrays to
``repro_torch.graph.Graph.from_coo``, builds the mix's programs and
warms each with ``warm_runs`` runs (the first captures its CUDA graph).
The window is a closed loop of one client: runs of
``repro_torch.core.run`` back to back, cycling through the programs,
each timed from the call until its answer is on the host, for
``--seconds`` seconds.  With ``--trace 1`` the window is followed by
``trace_runs`` runs under ``torch.profiler``, each inside a
``perfbench.run`` span.  Then the program's state is freed and the
answers of a sample of the window's runs, drawn from the seed, are
compared with the plain reference of :mod:`perfbench.reference`.

The last line of standard output is the result; the last lines of
standard error are the compared numbers beside their limits.  The run
exits non-zero with no result when no CUDA card is present, when the
cell asks for more cards than there are, and when ``jax``, ``jaxlib``,
``flax`` or ``repro`` is loaded once the window has closed.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """The names of :data:`FORBIDDEN` among ``names``' top-level parts
    (the part before the first dot, compared whole)."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class RunRecord:
    """One ``run()`` call: its wall time to the answer on the host, the
    program's own ``RunResult`` span and counters, and its outcome."""
    program: int
    wall_s: float
    seconds: float
    iterations: int
    direction_trace: Optional[str]
    occupancy_trace: Optional[list]
    outcome: str

    @property
    def ok(self) -> bool:
        return self.outcome == "converged"


@dataclasses.dataclass
class Record:
    """What the metric readers of ``metrics/`` read."""
    n_nodes: int
    n_edges: int
    sparse_capacity: int
    setup_s: float
    graph_build_s: float
    warm_s: float
    window_s: float
    runs: List[RunRecord]
    memory_peak_bytes: Optional[int] = None
    profile: object = None
    profiled_runs: List[RunRecord] = dataclasses.field(default_factory=list)


class Sample:
    """A reservoir of ``k`` answers per program, drawn with ``rng``."""

    def __init__(self, n_programs: int, k: int, rng: random.Random):
        self.k, self.rng = k, rng
        self.seen = [0] * n_programs
        self.kept = [[] for _ in range(n_programs)]

    def offer(self, program: int, answer) -> None:
        self.seen[program] += 1
        kept = self.kept[program]
        if len(kept) < self.k:
            kept.append(answer)
            return
        j = self.rng.randrange(self.seen[program])
        if j < self.k:
            kept[j] = answer


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _one_run(run, programs, index, graph, config, device, span=None):
    """One timed call; returns ``(RunRecord, answer on the host, error)``:
    the answer None and the traceback's text when the call raised."""
    program = programs[index]
    t0 = time.perf_counter()
    try:
        with span("perfbench.run") if span else contextlib.nullcontext():
            res = run(program, graph, config, use_kernels=True,
                      engine="fused", autotune="off", device=device)
            answer = res.extract(program).cpu()
    except Exception:  # a failed run is counted, and the window goes on
        return (RunRecord(index, time.perf_counter() - t0, math.nan, 0, None,
                          None, "raised"), None, traceback.format_exc())
    return RunRecord(index, time.perf_counter() - t0, res.seconds,
                     res.iterations, res.direction_trace,
                     res.occupancy_trace, res.outcome), answer, None


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(bench, cell, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None) -> dict:
    """Set-up, window, optional profile and check of one cell on
    ``device``; returns the result line as a dict.  Makes no check for
    a card: :func:`main` does."""
    import torch

    from perfbench import generators, trace as tracing
    from repro_torch import algorithms
    from repro_torch.core import EdgeContext, SystemConfig, run
    from repro_torch.core.plan_cache import PLAN_CACHE
    from repro_torch.graph import Graph

    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    mix = cell.mix
    t_gen = time.perf_counter()
    coo = generators.generate(cell.config, seed, mix.get("sources", 0),
                              device, here=bench.here)

    t_build = time.perf_counter()
    graph = Graph.from_coo(coo.src, coo.dst, coo.n_nodes, weight=coo.weight)
    graph_build_s = time.perf_counter() - t_build

    t_warm = time.perf_counter()
    factory = getattr(algorithms, mix["program"])
    if coo.sources:
        programs = [factory(**mix["args"], **{mix["source_arg"]: s})
                    for s in coo.sources]
    else:
        programs = [factory(**mix["args"])]
    config = SystemConfig.from_name(mix["config"])
    errors = []
    for i in range(len(programs)):
        for _ in range(mix["warm_runs"]):
            errors.append(_one_run(run, programs, i, graph, config,
                                   device)[2])
    _sync(device)
    warm_s = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - t0
    print(f"perfbench: set-up {setup_s:.3f} s: start {t_gen - t0:.3f}, "
          f"generate {t_build - t_gen:.3f}, from_coo {graph_build_s:.3f}, "
          f"warm {warm_s:.3f}", file=sys.stderr)

    sample = Sample(len(programs), mix["sample_per_program"],
                    random.Random(seed))
    runs: List[RunRecord] = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        i = len(runs) % len(programs)
        rec, answer, err = _one_run(run, programs, i, graph, config, device)
        runs.append(rec)
        errors.append(err)
        sample.offer(i, None if answer is None else answer.numpy())
    window_s = time.perf_counter() - start
    record = Record(n_nodes=coo.n_nodes, n_edges=coo.n_edges,
                    sparse_capacity=EdgeContext.default_sparse_capacity(
                        graph),
                    setup_s=setup_s, graph_build_s=graph_build_s,
                    warm_s=warm_s, window_s=window_s, runs=runs)
    if cuda:
        record.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            device))

    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for n in range(mix["trace_runs"]):
                rec, _, err = _one_run(run, programs, n % len(programs),
                                       graph, config, device,
                                       span=torch.profiler.record_function)
                record.profiled_runs.append(rec)
                errors.append(err)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            record.profile = tracing.load_trace(path)
        finally:
            os.unlink(path)
        del prof

    first_error = next((e for e in errors if e), None)
    if first_error:
        print(f"perfbench: {sum(map(bool, errors))} runs raised; the "
              f"first:\n{first_error}", file=sys.stderr)

    # free the program's state before the reference runs on the device
    del graph, programs
    PLAN_CACHE.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reference = bench.reference(mix["program"])
    readings: dict = {}
    for i, source in enumerate(coo.sources or [None]):
        expected = reference.solve(coo, mix["args"], source, device,
                                   torch.float64, exact=True)
        for name, value in reference.readings(sample.kept[i],
                                              expected).items():
            readings[name] = max(readings.get(name, value), value)
    missing = sorted(set(readings) ^ set(cell.limits))
    if missing:
        raise KeyError(f"{cell.name}: readings and limits differ in "
                       f"{missing}")
    checks = {name: {"value": readings[name], "limit": cell.limits[name]}
              for name in sorted(readings)}
    raised = sum(r.outcome == "raised" for r in runs)
    correct = raised == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    specs = (bench.per_layer(cell.name) if trace
             else bench.end_to_end(cell.name))
    metrics = {}
    for spec in specs:
        value = bench.reader(spec["name"]).read(record)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else device.type),
           "count": cell.chips,
           "memory_peak_bytes": record.memory_peak_bytes or 0}
    if trace:
        prof = record.profile
        dev["busy_s"] = prof.busy_s if prof else 0.0
        dev["window_s"] = prof.window_s if prof else 0.0
    if cuda:
        dev["power_limit_w"] = _power_limit()
    result = {"correct": bool(correct), "attempted": len(runs),
              "failed": sum(not r.ok for r in runs), "metrics": metrics,
              "device": dev}
    if trace and record.profile is not None:
        result["breakdown"] = record.profile.breakdown()
    result["checks"] = checks
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from perfbench import registry

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; this benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    bench = registry.load(ROOT)
    cell = bench.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t0=_T0)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
