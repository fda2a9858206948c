"""The port's perf-regression gate over its tracked benchmark artifacts.

Counterpart of ``benchmarks/compare.py``: diffs the current
``results/torch/BENCH_{dispatch,autotune,batch,matrix,serve,resilience,
chaos,specialize}.json`` against committed baselines under
``results/torch/baselines/`` and **fails** (exit 1) when an artifact's
geomean regression exceeds the threshold (default 20%).

What is compared: the **within-run speedup ratios** each artifact
records (fused-vs-host per config, tuned-vs-default per workload x
config, batched-vs-sequential per config x batch size, best-config-vs-
TG0 per workload, gateway-vs-serial-server throughput and p99 ratios,
plain-vs-checkpointed efficiency and cold-vs-warm recovery, the chaos
and specialize invariants as 1.0-vs-1e-6 metrics), *not* absolute
microseconds: a ratio's numerator and denominator come from one run on
one card.  Per metric the regression ratio is ``baseline / current``
(> 1 means worse); the gate fails an artifact when the **geomean** of
its ratios exceeds ``1 + threshold``.  The metrics, fingerprints, caps
and threshold are the reference's.

One rule differs, the tolerance rule of the port's differential tests:
where the reference is exact only to a float tolerance (the float SUM
of PR and BC: K1's float atomics and ``scatter_add`` add in a
run-dependent order on the card), identity is read as agreement to
that tolerance.  ``resilience/<cfg>/identical`` reads a PR or BC
record's ``within_tolerance``, and ``chaos/core/identical`` reads the
core scenario's ``agrees`` when its app is PR or BC.  A record without
those keys (the reference's) falls back to ``bit_identical``; every
exact app keeps bit-identity.

Baselines must be *compatible*: the same pinned workload and smoke flag.
Incompatible or missing baselines exit 2.  A baseline holds the
per-metric **medians** of several clean card runs of one tree
(``gate_metrics``, beside a copy of the first run's artifact), so that
one noisy run does not set the bar.  Refresh them from three or more
such runs: read the numbers, then ``python -m
repro_torch.benchmarks.compare --update-baselines --current-dir RUN1
--current-dir RUN2 --current-dir RUN3`` and commit the files under
``results/torch/baselines/`` (never to make a regression pass).
``--trip-rate RUN1 RUN2 ...`` reports how often clean runs trip the
gate: each run against the median of the others, and each run against
each other run alone.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

from repro_torch.benchmarks import RESULTS

__all__ = ["extract_metrics", "fingerprint", "compare_artifact",
           "compare_dirs", "update_baselines", "median_baseline",
           "trip_rates", "ARTIFACTS",
           "DEFAULT_THRESHOLD", "TOLERANCE_APPS", "RESULTS", "BASELINES"]

#: artifact kind -> tracked file name.
ARTIFACTS = {
    "dispatch": "BENCH_dispatch.json",
    "autotune": "BENCH_autotune.json",
    "batch": "BENCH_batch.json",
    "matrix": "BENCH_matrix.json",
    "serve": "BENCH_serve.json",
    "resilience": "BENCH_resilience.json",
    "chaos": "BENCH_chaos.json",
    "specialize": "BENCH_specialize.json",
}
DEFAULT_THRESHOLD = 0.20
BASELINES = RESULTS / "baselines"

#: apps whose float SUM is exact only to a tolerance on the card: their
#: identity metrics read agreement to the differential tests' tolerance
TOLERANCE_APPS = ("PR", "BC")

#: serve metrics are clamped at caps *below* their run-to-run noise
#: floor (closed-loop speedup swings ~1.7-4.2x with thread scheduling;
#: open-loop p99_gain 5-10x): healthy runs saturate every cap, so the
#: gate reads exactly 1.0 between runs and trips only when the gateway
#: genuinely stops paying for itself (throughput advantage lost, or
#: tail latency no longer better than the serial server's).
SERVE_CAPS = {
    ("closed", "throughput_speedup"): 1.5,
    ("closed", "p99_gain"): 1.5,
    ("open", "throughput_speedup"): 1.15,
    ("open", "p99_gain"): 1.5,
}

#: same cap idiom for the resilience artifact: checkpointing efficiency
#: (fused_us / ckpt_us) sits ~0.95-1.0 with a few-% noise band, so the
#: gate clamps at 0.90 — it trips only when checkpoint boundaries cost
#: real time again; recovery_speedup (cold restart / warm ring) swings
#: with how late the injected fault lands relative to convergence, so
#: it clamps just above break-even.  Bit-identity is uncapped on
#: purpose: any config losing it drives its ratio through the roof.
RESILIENCE_EFFICIENCY_CAP = 0.90
RESILIENCE_RECOVERY_CAP = 1.1

#: the learned specializer's e2e advantage over the best single-config
#: policy is clamped at break-even + margin: the >= 1.0x acceptance
#: bound is enforced by the ``e2e_ge_best_always`` invariant, and
#: headroom above it varies with which cells the fresh matrix measured
#: fastest — not something to hold future runs to
SPECIALIZE_CAP = 1.05


def extract_metrics(kind: str, data: dict) -> dict:
    """The artifact's tracked speedup metrics as ``{name: ratio}``."""
    out = {}
    if kind == "dispatch":
        for cfg, cell in data.get("configs", {}).items():
            out[f"dispatch/{cfg}/fused_speedup"] = cell["fused_speedup"]
    elif kind == "autotune":
        for wl, w in data.get("workloads", {}).items():
            for cfg, cell in w.get("configs", {}).items():
                out[f"autotune/{wl}/{cfg}/speedup"] = cell["speedup"]
    elif kind == "batch":
        for cfg, per_b in data.get("configs", {}).items():
            for b, cell in per_b.items():
                out[f"batch/{cfg}/B{b}/speedup"] = cell["speedup"]
    elif kind == "matrix":
        for wl, cell in data.get("cells", {}).items():
            out[f"matrix/{wl}/specialization_gain"] = (
                cell["specialization_gain"])
    elif kind == "serve":
        for mode, cell in data.get("modes", {}).items():
            for metric in ("throughput_speedup", "p99_gain"):
                cap = SERVE_CAPS.get((mode, metric), 1.5)
                out[f"serve/{mode}/{metric}"] = min(cell[metric], cap)
    elif kind == "resilience":
        tolerant = data.get("workload", {}).get("app") in TOLERANCE_APPS
        for cfg, cell in data.get("configs", {}).items():
            out[f"resilience/{cfg}/efficiency"] = min(
                cell["efficiency"], RESILIENCE_EFFICIENCY_CAP)
            # 1e-6, not 0: a config that loses identity against a
            # clean baseline blows its ratio up to 1e6 (the gate can't
            # miss it), while two matching runs still read exactly 1.0
            same = (cell.get("within_tolerance", cell["bit_identical"])
                    if tolerant else cell["bit_identical"])
            out[f"resilience/{cfg}/identical"] = 1.0 if same else 1e-6
        rec = data.get("recovery", {})
        if rec:
            out["resilience/recovery/speedup"] = min(
                rec["recovery_speedup"], RESILIENCE_RECOVERY_CAP)
    elif kind == "chaos":
        # every chaos metric is a 1.0-vs-1e-6 invariant: recovery
        # wall-clock is noise, but losing bit-identity, replaying the
        # whole run (lost_work_ratio >= 1 means durable checkpoints
        # bought nothing over cold restart), or overload breaking an
        # admitted request must blow the gate up unmissably
        core = data.get("core", {})
        if core:
            tolerant = data.get("workload", {}).get("core_app") \
                in TOLERANCE_APPS
            same = (core.get("agrees", core.get("bit_identical"))
                    if tolerant else core.get("bit_identical"))
            out["chaos/core/identical"] = 1.0 if same else 1e-6
            out["chaos/core/lost_work_contained"] = (
                1.0 if core.get("lost_work_ratio", 1.0) < 1.0 else 1e-6)
        gw = data.get("gateway", {})
        for app, cell in gw.get("apps", {}).items():
            out[f"chaos/gateway/{app}/identical"] = (
                1.0 if cell.get("bit_identical") else 1e-6)
        if gw:
            out["chaos/gateway/lost_work_contained"] = (
                1.0 if gw.get("lost_work_ratio", 1.0) < 1.0 else 1e-6)
        ov = data.get("overload", {})
        if ov:
            out["chaos/overload/contained"] = (
                1.0 if ov.get("contained") else 1e-6)
    elif kind == "specialize":
        # the two acceptance invariants as 1.0-vs-1e-6 metrics (the
        # chaos idiom): the learned model must pick at least as well as
        # the static partial tree, and its e2e geomean must beat every
        # always-one-config policy
        acc = data.get("accuracy", {})
        gate = data.get("gate", {})
        if gate:
            out["specialize/accuracy_ge_partial"] = (
                1.0 if gate.get("accuracy_ge_partial") else 1e-6)
            out["specialize/e2e_ge_best_always"] = (
                1.0 if gate.get("e2e_ge_best_always") else 1e-6)
        # the tolerant accuracy itself, as a ratio: labels come from
        # the same run's measurements, so this is stable within the
        # normal threshold and trips only on a real model regression
        if "learned_tol" in acc:
            out["specialize/accuracy_learned_tol"] = max(
                acc["learned_tol"], 1e-6)
        spd = data.get("e2e", {}).get("speedup_vs_best_always")
        if spd is not None:
            # capped at the invariant's break-even, like the serve
            # caps: extra headroom above 1.0x is workload luck, not a
            # property the gate should hold future runs to
            out["specialize/speedup_vs_best_always"] = min(spd,
                                                           SPECIALIZE_CAP)
    else:
        raise ValueError(f"unknown artifact kind {kind!r}")
    return out


def fingerprint(kind: str, data: dict) -> dict:
    """What must match between baseline and current for the diff to be
    meaningful: the pinned workload identity and the smoke flag."""
    if kind == "dispatch":
        return {"workload": data.get("workload")}
    if kind == "autotune":
        return {"smoke": data.get("smoke"),
                "workloads": {n: {"generator": w.get("generator"),
                                  "params": w.get("params")}
                              for n, w in data.get("workloads", {}).items()}}
    if kind == "batch":
        return {"smoke": data.get("smoke"),
                "workload": data.get("workload")}
    if kind == "matrix":
        # input sources matter: a run against real fetched graphs is a
        # different workload than one against the synthetic stand-ins
        return {"smoke": data.get("smoke"),
                "workload": data.get("workload"),
                "sources": {n: i.get("source")
                            for n, i in data.get("inputs", {}).items()}}
    if kind == "serve":
        return {"smoke": data.get("smoke"),
                "workload": data.get("workload")}
    if kind == "resilience":
        return {"smoke": data.get("smoke"),
                "workload": data.get("workload"),
                "checkpoint_every": data.get("checkpoint_every")}
    if kind == "chaos":
        return {"smoke": data.get("smoke"),
                "workload": data.get("workload")}
    if kind == "specialize":
        # carries the training matrix's pinned workload: a model
        # trained on a different sweep is a different experiment
        return {"smoke": data.get("smoke"),
                "workload": data.get("workload")}
    raise ValueError(f"unknown artifact kind {kind!r}")


def compare_artifact(kind: str, baseline: dict, current: dict,
                     threshold: float = DEFAULT_THRESHOLD) -> dict:
    """Diff one artifact; returns ``{status, geomean_ratio, ratios,
    worst, n_metrics}`` with status in {"ok", "regression",
    "incompatible", "empty"}."""
    if fingerprint(kind, baseline) != fingerprint(kind, current):
        return {"status": "incompatible", "n_metrics": 0,
                "geomean_ratio": None, "ratios": {}, "worst": [],
                "baseline": {}, "current": {}}
    # a baseline written from several runs holds their medians
    base = baseline.get("gate_metrics") or extract_metrics(kind, baseline)
    cur = extract_metrics(kind, current)
    shared = sorted(set(base) & set(cur))
    ratios = {m: base[m] / max(cur[m], 1e-12) for m in shared}
    if not ratios:
        return {"status": "empty", "n_metrics": 0, "geomean_ratio": None,
                "ratios": {}, "worst": [], "baseline": {}, "current": {}}
    geomean = math.exp(sum(math.log(max(r, 1e-12))
                           for r in ratios.values()) / len(ratios))
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    return {
        "status": "regression" if geomean > 1.0 + threshold else "ok",
        "n_metrics": len(ratios),
        "geomean_ratio": geomean,
        "ratios": ratios,
        "worst": worst,
        "baseline": base,
        "current": cur,
    }


def compare_dirs(baseline_dir: str, current_dir: str,
                 artifacts=None, threshold: float = DEFAULT_THRESHOLD,
                 allow_missing: bool = False) -> int:
    """Diff every requested artifact; prints a report, returns the exit
    code (0 pass, 1 regression, 2 missing/incompatible baseline)."""
    artifacts = artifacts or list(ARTIFACTS)
    base_dir, cur_dir = Path(baseline_dir), Path(current_dir)
    exit_code = 0
    for kind in artifacts:
        fname = ARTIFACTS[kind]
        bpath, cpath = base_dir / fname, cur_dir / fname
        if not cpath.exists():
            # a requested artifact the benchmarks did not produce would
            # silently un-gate itself if this were a pass — fail loudly
            # (CI runs every benchmark before the gate, so this only
            # fires when an output path drifted)
            if allow_missing:
                print(f"perf-gate {kind}: SKIP (no current {cpath})")
                continue
            print(f"perf-gate {kind}: MISSING current {cpath} — did the "
                  f"benchmark step run (or its --out path drift)?")
            exit_code = max(exit_code, 2)
            continue
        if not bpath.exists():
            if allow_missing:
                print(f"perf-gate {kind}: SKIP (no baseline {bpath})")
                continue
            print(f"perf-gate {kind}: MISSING baseline {bpath} — run the "
                  f"benchmarks and `--update-baselines` (see README)")
            exit_code = max(exit_code, 2)
            continue
        # a corrupt/truncated artifact must gate as loudly as a missing
        # one — an unhandled JSONDecodeError here would read as a CI
        # infrastructure flake instead of "your baseline is broken"
        try:
            baseline = json.loads(bpath.read_text())
        except (ValueError, OSError) as exc:
            print(f"perf-gate {kind}: UNREADABLE baseline {bpath} "
                  f"({exc}) — re-run the benchmarks and "
                  f"`python -m repro_torch.benchmarks.compare "
                  f"--update-baselines` from a card run (see README), "
                  f"then commit the refreshed copy")
            exit_code = max(exit_code, 2)
            continue
        try:
            current = json.loads(cpath.read_text())
        except (ValueError, OSError) as exc:
            print(f"perf-gate {kind}: UNREADABLE current {cpath} "
                  f"({exc}) — the benchmark step emitted a corrupt "
                  f"artifact; re-run it before gating")
            exit_code = max(exit_code, 2)
            continue
        rep = compare_artifact(kind, baseline, current, threshold)
        if rep["status"] == "incompatible":
            print(f"perf-gate {kind}: INCOMPATIBLE baseline (pinned "
                  f"workload or smoke flag changed) — refresh "
                  f"{bpath}")
            exit_code = max(exit_code, 2)
            continue
        if rep["status"] == "empty":
            print(f"perf-gate {kind}: SKIP (no shared metrics)")
            continue
        gm = rep["geomean_ratio"]
        line = (f"perf-gate {kind}: geomean_regression="
                f"{(gm - 1) * 100:+.1f}% over {rep['n_metrics']} metrics "
                f"(threshold +{threshold * 100:.0f}%)")
        if rep["status"] == "regression":
            print(line + " — FAIL")
            # name each offender with what was measured vs what the
            # committed baseline recorded, so the CI log alone says
            # which artifact/metric regressed and by how much
            for name, r in rep["worst"]:
                print(f"  worst [{kind}]: {name} — measured "
                      f"{rep['current'][name]:.4g} vs baseline "
                      f"{rep['baseline'][name]:.4g} "
                      f"({(r - 1) * 100:+.1f}% regression)")
            exit_code = max(exit_code, 1)
        else:
            print(line + " — ok")
    return exit_code


def median_baseline(kind: str, runs: list) -> dict:
    """A baseline from several runs' artifacts of one kind: the first
    run's artifact with the per-metric medians of all of them under
    ``gate_metrics``.  Runs of different workloads are refused."""
    fps = [fingerprint(kind, r) for r in runs]
    if any(fp != fps[0] for fp in fps):
        raise ValueError(f"{kind}: the runs are of different workloads")
    metrics = [extract_metrics(kind, r) for r in runs]
    shared = set.intersection(*(set(m) for m in metrics))
    return {**runs[0], "gate_median_of": len(runs),
            "gate_metrics": {k: statistics.median(m[k] for m in metrics)
                             for k in sorted(shared)}}


def _dirs(current_dir) -> list:
    if isinstance(current_dir, (str, Path)):
        return [Path(current_dir)]
    return [Path(d) for d in current_dir]


def update_baselines(baseline_dir: str, current_dir,
                     artifacts=None) -> None:
    """Write each artifact's baseline from one run directory or the
    per-metric medians of several (``median_baseline``)."""
    artifacts = artifacts or list(ARTIFACTS)
    base_dir = Path(baseline_dir)
    base_dir.mkdir(parents=True, exist_ok=True)
    for kind in artifacts:
        srcs = [d / ARTIFACTS[kind] for d in _dirs(current_dir)]
        missing = [str(p) for p in srcs if not p.exists()]
        if missing:
            print(f"baseline NOT updated ({', '.join(missing)} missing)")
            continue
        runs = [json.loads(p.read_text()) for p in srcs]
        dst = base_dir / ARTIFACTS[kind]
        dst.write_text(json.dumps(median_baseline(kind, runs), indent=2))
        print(f"baseline updated: {dst} (median of {len(runs)})")


def trip_rates(run_dirs, artifacts=None,
               threshold: float = DEFAULT_THRESHOLD) -> dict:
    """How often clean runs of one tree trip the gate.  Per artifact:
    each run against the median baseline of the other runs
    (``leave_one_out``), and each ordered pair of runs with the first as
    a one-run baseline (``pairs``).  Values are geomean regressions."""
    artifacts = artifacts or list(ARTIFACTS)
    dirs = _dirs(run_dirs)
    out = {}
    for kind in artifacts:
        runs = [json.loads((d / ARTIFACTS[kind]).read_text())
                for d in dirs]
        loo = [compare_artifact(kind, median_baseline(
                   kind, runs[:i] + runs[i + 1:]), cur, threshold)
               for i, cur in enumerate(runs)]
        pairs = [compare_artifact(kind, b, c, threshold)
                 for i, b in enumerate(runs)
                 for j, c in enumerate(runs) if i != j]
        out[kind] = {
            name: {"geomean_regressions": [r["geomean_ratio"] - 1
                                           for r in reps],
                   "trips": sum(r["status"] != "ok" for r in reps),
                   "n": len(reps)}
            for name, reps in (("leave_one_out", loo), ("pairs", pairs))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-dir", default=str(BASELINES))
    ap.add_argument("--current-dir", action="append", default=None,
                    help="the run's artifacts (default results/torch); "
                         "with --update-baselines, repeat it to take the "
                         "per-metric medians of several runs")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="relative geomean regression that fails the "
                         "gate (default 0.20 = 20%%)")
    ap.add_argument("--artifacts", default=",".join(ARTIFACTS),
                    help="comma-separated subset of "
                         + "/".join(ARTIFACTS))
    ap.add_argument("--allow-missing", action="store_true",
                    help="skip artifacts without a committed baseline "
                         "instead of failing")
    ap.add_argument("--update-baselines", action="store_true",
                    help="write the baselines from the current artifacts "
                         "instead of diffing")
    ap.add_argument("--trip-rate", nargs="+", metavar="RUN_DIR",
                    help="report how often these clean runs of one tree "
                         "trip the gate, and stop")
    args = ap.parse_args(argv)
    artifacts = [a for a in args.artifacts.split(",") if a]
    unknown = [a for a in artifacts if a not in ARTIFACTS]
    if unknown:
        ap.error(f"unknown artifacts: {unknown}")
    current = args.current_dir or [str(RESULTS)]
    if args.trip_rate:
        if len(args.trip_rate) < 3:
            ap.error("--trip-rate needs three or more runs")
        rates = trip_rates(args.trip_rate, artifacts, args.threshold)
        for kind, rep in rates.items():
            for name, r in rep.items():
                print(f"trip-rate {kind} {name}: {r['trips']}/{r['n']} "
                      "geomean_regressions=" + ",".join(
                          f"{g * 100:+.1f}%"
                          for g in r["geomean_regressions"]))
        print(json.dumps(rates))
        return 0
    if args.update_baselines:
        update_baselines(args.baseline_dir, current, artifacts)
        return 0
    if len(current) != 1:
        ap.error("the gate reads one --current-dir")
    return compare_dirs(args.baseline_dir, current[0], artifacts,
                        threshold=args.threshold,
                        allow_missing=args.allow_missing)


if __name__ == "__main__":
    sys.exit(main())
