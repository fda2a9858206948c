"""Single source of truth for the README's knob tables of the port.

Counterpart of ``repro.doctables`` for three knob surfaces of
``repro_torch``: ``run()``, the ``GraphGateway`` constructor and the
per-``submit`` request knobs.  Each documented row sits here beside the
callable it describes; the module renders the markdown tables and
rewrites the README blocks between ``<!-- knobs:<section>:begin/end -->``
markers.  The port's sections are named ``torch-run``, ``torch-gateway``
and ``torch-submit``, so that their markers never match the reference's
``run``, ``gateway`` and ``submit`` blocks, which ``repro.doctables``
keeps:

    PYTHONPATH=src python -m repro_torch.doctables --check   # tests
    PYTHONPATH=src python -m repro_torch.doctables --write   # regenerate

``tests/test_torch_docs.py`` enforces both directions of freshness:
every documented knob exists in the target's ``inspect.signature`` and
every signature parameter has a documented row, and each README block
equals the rendered table byte for byte.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import re
import sys
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["SECTIONS", "render", "doc_knobs", "signature_knobs",
           "inject", "check_text", "marker"]

#: one documented row: (knob names it covers, values column, meaning)
Row = Tuple[Tuple[str, ...], str, str]

_RUN_ROWS: List[Row] = [
    (("device",), "`None` (the CUDA card) \\| `\"cpu\"` \\| any device",
     "where the run happens; without a CUDA device `None` raises "
     "`RuntimeError`, never a silent fall back to the CPU"),
    (("engine",), '`"fused"` \\| `"host"`',
     "replays of a captured CUDA graph of `STEPS_PER_LAUNCH` guarded "
     "steps (conditional IF nodes, one poll per replay; eager on a CPU "
     "device) vs the step-per-iteration oracle"),
    (("use_kernels",), "`False` \\| `True`",
     "plain `scatter_reduce` reductions vs the hand-written K1/K2 "
     "blocked reducers on the owned push order and the CSC pull order "
     "(on a CPU device their plain versions)"),
    (("sparse_edge_capacity",), "`ceil(E/alpha)` \\| `0` \\| any int",
     "static gather capacity of the sparse frontier path (0 disables "
     "it), whose reduce is a hand-written kernel on a CUDA device "
     "whatever `use_kernels` says"),
    (("autotune",), '`"off"` \\| `"heuristic"` \\| `"measure"`',
     "K1/K2 plans: the default (512 threads per CTA) / the degree "
     "heuristic at 256 threads / the fastest candidate of a sweep timed "
     "with CUDA events, cached per graph and persisted to "
     "`results/torch/autotune_cache.json` keyed by degree signature and "
     "card; results never depend on the mode"),
    (("specialize",), '`"off"` \\| `"static"` \\| `"learned"`',
     "resolve the config this workload runs under: as passed / the "
     "paper's Fig. 4 tree on (Table III properties, taxonomy profile "
     "under `PAPER_GPU`) / the model at "
     "`results/torch/specialize_model.json`, falling back learned → "
     "static partial → caller with a `SpecializeFallbackWarning`; "
     "stamped on `RunResult.config_name`/`config_source`"),
    (("max_iters",), "program default",
     "iteration cap (a fused run launches whole graphs of steps; the "
     "guards stop at the cap)"),
    (("checkpoint_every",), "`0` \\| int",
     "run the fused loop in K-iteration segments of one captured graph, "
     "snapshotting each boundary into a host `CheckpointRing` and "
     "checking the sentinels; equal to the plain run (float sums to "
     "tolerance)"),
    (("retry",), "`None` \\| `RetryPolicy(max_attempts, backoff_s)`",
     "on a sentinel trip / runner exception: roll back one checkpoint "
     "deeper per attempt and walk the degradation chain (as-is → "
     "default plans → dense → host engine); a `KernelBuildError` is "
     'raised, never contained; exhausted attempts return `outcome="'
     'faulted"`'),
    (("sentinels",), "`True` \\| `False`",
     "per-segment invariant battery (NaN guard, declared monotonicity, "
     "program sentinels, occupancy sanity) plus the convergence "
     "certificate at retire"),
    (("ring_capacity",), "`4` \\| int",
     "checkpoints kept (pinned initial + newest `C-1`); `1` = "
     "cold-restart semantics"),
    (("checkpoint_dir",), "`None` \\| path",
     "spill every boundary to a durable `CheckpointStore` (the "
     "reference's file format, so either package resumes the other's); "
     "a rerun resumes from the newest intact generation"),
    (("fault_injector",), "`None` \\| `FaultInjector`",
     "test/benchmark hook: the seeded injectors of "
     "`repro_torch.testing.faults`"),
]

_GATEWAY_ROWS: List[Row] = [
    (("device",), "`None` (the CUDA card) \\| `\"cpu\"`",
     "the device of every lane; the worker thread does all device "
     "work, and clients keep to the host arrays it returns"),
    (("max_batch", "slice_len"), "`8`, `4`",
     "roster slots packed per lane and iterations per "
     "`run_batch_slice` slice (the continuous-batching grain)"),
    (("max_queue",), "`256`",
     "waiting-queue bound; admissions beyond it raise "
     "`GatewayBackpressure`"),
    (("clock",), "`time.monotonic`",
     "injectable time source (tests drive deterministic clocks)"),
    (("retry", "sentinels"), "`RetryPolicy(max_attempts=2)`, `True`",
     "slice-level fault containment: host-side sentinels on every "
     "commit, whole-roster retry then solo isolation, quarantine with "
     "an `ExecutionFault`; a `KernelBuildError` is raised, never "
     "contained"),
    (("fault_injector",), "`None` \\| `FaultInjector`",
     "seeded fault harness hook (`repro_torch.testing.faults`)"),
    (("journal_dir",), "`None` \\| path",
     "write-ahead admission journal (the reference's format: either "
     "package recovers the other's); `recover(journal_dir)` finishes "
     "every unfinished ticket from its last committed slice"),
    (("breaker_threshold", "breaker_cooldown"), "`3`, `4`",
     "per-lane circuit breaker: that many consecutive faulty slices "
     "open it (solo B=1 slices), a packed probe after `cooldown` solo "
     "rounds half-opens it, a clean probe closes it"),
]

_SUBMIT_ROWS: List[Row] = [
    (("key", "max_iters"), "`None`; program default",
     "per-request `torch.Generator` (MIS/CLR priorities) and iteration "
     "cap"),
    (("deadline_s",), "`None` \\| seconds",
     "retire with partial state flagged `timed_out` at the next slice "
     "boundary past the deadline; shed at admission with "
     '`OverloadError(code="overload_shed")` when the projected delay '
     "already exceeds it"),
    (("use_kernels", "sparse_edge_capacity", "autotune"),
     "as on `run()`",
     "execution knobs, part of the lane key: requests differing in them "
     "never share a packed roster"),
    (("specialize",), '`"off"` \\| `"static"` \\| `"learned"`',
     "resolve this request's config at admission (after the admission "
     "checks); the resolved config picks the lane, is journaled and "
     "lands on the result's `config_source`"),
]

#: section -> (target "module:qualname", params excluded from the
#: cross-check, header row, documented rows)
SECTIONS: Dict[str, dict] = {
    "torch-run": {
        "target": "repro_torch.core.executor:run",
        "exclude": ("program", "graph", "config", "key"),
        "header": ("Knob", "Values (default first)", "What it picks"),
        "rows": _RUN_ROWS,
    },
    "torch-gateway": {
        "target": "repro_torch.launch.serve:GraphGateway.__init__",
        "exclude": ("self",),
        "header": ("Knob", "Default", "What it does"),
        "rows": _GATEWAY_ROWS,
    },
    "torch-submit": {
        "target": "repro_torch.launch.serve:ContinuousScheduler.submit",
        "exclude": ("self", "program", "graph", "config"),
        "header": ("Knob (per `submit`)", "Values (default first)",
                   "What it does"),
        "rows": _SUBMIT_ROWS,
    },
}

# `run()` takes `key=` as the documented program input, not a knob row;
# submit documents it as a row, so "key" sits in run's exclude list only.


def doc_knobs(section: str) -> set:
    """Knob names the section's table documents."""
    return {n for names, _, _ in SECTIONS[section]["rows"] for n in names}


def signature_knobs(section: str) -> set:
    """Parameter names of the section's target callable (minus the
    structural ones in ``exclude``)."""
    spec = SECTIONS[section]
    mod_name, qualname = spec["target"].split(":")
    obj = importlib.import_module(mod_name)
    for attr in qualname.split("."):
        obj = getattr(obj, attr)
    params = inspect.signature(obj).parameters
    return {p for p in params if p not in spec["exclude"]}


def render(section: str) -> str:
    """The section's markdown table (no markers)."""
    spec = SECTIONS[section]
    h = spec["header"]
    lines = [f"| {h[0]} | {h[1]} | {h[2]} |", "|---|---|---|"]
    for names, values, desc in spec["rows"]:
        knob = ", ".join(f"`{n}=`" for n in names)
        lines.append(f"| {knob} | {values} | {desc} |")
    return "\n".join(lines)


def marker(section: str, which: str) -> str:
    if which == "begin":
        return (f"<!-- knobs:{section}:begin — generated by `python -m "
                "repro_torch.doctables --write`; edit "
                "src/repro_torch/doctables.py, not this table -->")
    return f"<!-- knobs:{section}:end -->"


def _block(section: str) -> str:
    return (marker(section, "begin") + "\n" + render(section) + "\n"
            + marker(section, "end"))


def _block_re(section: str) -> re.Pattern:
    return re.compile(
        re.escape(marker(section, "begin")) + r"\n(?:.*?\n)?"
        + re.escape(marker(section, "end")), re.DOTALL)


def inject(text: str) -> str:
    """Rewrite every marked block in ``text`` with the fresh render;
    raises ValueError for a section whose markers are missing or
    malformed (a silent skip would let the table drift again)."""
    for section in SECTIONS:
        pat = _block_re(section)
        if not pat.search(text):
            raise ValueError(
                f"README markers for knob table {section!r} missing or "
                f"malformed (expected {marker(section, 'begin')!r} ... "
                f"{marker(section, 'end')!r})")
        block = _block(section)
        text = pat.sub(lambda _m: block, text)
    return text


def check_text(text: str) -> List[str]:
    """Drift report for a README body: one message per stale/missing
    block, empty when everything is fresh."""
    problems = []
    for section in SECTIONS:
        m = _block_re(section).search(text)
        if not m:
            problems.append(f"{section}: markers missing")
        elif m.group(0) != _block(section):
            problems.append(f"{section}: table out of date (run "
                            "`python -m repro_torch.doctables --write`)")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readme", default="README.md")
    ap.add_argument("--write", action="store_true",
                    help="rewrite the marked README blocks in place")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any marked block is stale")
    args = ap.parse_args(argv)
    path = Path(args.readme)
    text = path.read_text()
    if args.write:
        path.write_text(inject(text))
        print(f"doctables: rewrote {len(SECTIONS)} knob tables in {path}")
        return 0
    problems = check_text(text)
    for p in problems:
        print(f"doctables: {p}")
    if not problems:
        print(f"doctables: {len(SECTIONS)} knob tables fresh in {path}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
