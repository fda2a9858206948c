"""Train and evaluate the learned best-config specializer (paper Sec. IV,
the predictive half).

Counterpart of ``benchmarks/specialize.py``.  It reads the port's matrix
(``results/torch/BENCH_matrix.json``: run
``repro_torch.benchmarks.matrix`` first, under the same
``PYTHONHASHSEED``), fits the numpy decision tree of
:mod:`repro_torch.core.specialize_learned` to each workload's
measured-best cell, refreshes the serving model
(``results/torch/specialize_model.json``) and evaluates every policy
against the same measured cells:

- **learned**: the serving model (admission-time features only);
- **trace_augmented**: the ablation model that also sees the matrix's
  direction and occupancy traces (an upper bound: no trace exists at
  admission time);
- **static_full / static_partial**: the trees of ``core/model.py`` fed by
  the Sec. III taxonomy profile of each input, materialized again at the
  matrix's scale (the matrix does not record it);
- **always-X**: one config for every workload.

Metrics, on the matrix's measured seconds: **accuracy**, the share of
workloads whose chosen cell is the measured best, and ``*_tol``
accuracy, which also credits a cell within ``tol`` (10 %) of the best
(near-tied cells flip on timing noise; on the card PR's and BC's float
sums are not repeatable either); a choice the sweep never measured is
projected onto its configs first (``project_config``); **e2e**, the
geomean over workloads of the chosen cell's µs, and
``speedup_vs_best_always``, the best always-X policy's geomean over the
learned one's.  The ``gate`` holds the two invariants: learned
``*_tol`` accuracy >= static_partial's, and ``speedup_vs_best_always``
>= 1.0.

    PYTHONHASHSEED=0 python -m repro_torch.benchmarks.specialize

writes ``results/torch/BENCH_specialize.json`` with the card's name and
power limit taken from the matrix's header.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from pathlib import Path

from repro_torch.core import specialize_learned as sl
from repro_torch.core.model import specialize, specialize_partial
from repro_torch.core.properties import TABLE_III
from repro_torch.core.taxonomy import profile_graph
from repro_torch.graph.datasets import dataset_graph

__all__ = ["run_specialize", "DEFAULT_TOL", "OUT", "MATRIX", "MODEL_OUT"]

#: a cell within this fraction of the measured-best cell counts as a
#: correct pick for the ``*_tol`` accuracies
DEFAULT_TOL = 0.10
_ROOT = Path(__file__).resolve().parents[3]
_RESULTS = _ROOT / "results" / "torch"
OUT = _RESULTS / "BENCH_specialize.json"
MATRIX = _RESULTS / "BENCH_matrix.json"
MODEL_OUT = _RESULTS / "specialize_model.json"


def _geomean(xs):
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 1.0


def _taxonomy_profiles(matrix: dict) -> dict:
    """Materialize each matrix input again at its recorded scale and
    profile it (Sec. III): the static trees' graph-side input."""
    wl = matrix["workload"]
    profs = {}
    for name, rec in matrix["inputs"].items():
        g, source = dataset_graph(name, scale=wl["scale"],
                                  block_size=wl["block_size"])
        if source != rec.get("source", source):
            print(f"specialize: input {name} resolves to {source} graph "
                  f"but the matrix measured {rec['source']}: static-tree "
                  "accuracy is evaluated against a different graph",
                  flush=True)
        if (g.n_nodes, g.n_edges) != (rec["n_nodes"], rec["n_edges"]):
            print(f"specialize: input {name} has {g.n_nodes} vertices and "
                  f"{g.n_edges} edges here, {rec['n_nodes']} and "
                  f"{rec['n_edges']} in the matrix (another "
                  "PYTHONHASHSEED?)", flush=True)
        profs[name] = profile_graph(g)
    return profs


def run_specialize(out_path=OUT, matrix_path=MATRIX, model_out=MODEL_OUT,
                   smoke: bool = False, tol: float = DEFAULT_TOL,
                   max_depth: int = 6) -> dict:
    """Train the model, write it to ``model_out``, evaluate every
    policy; write the record to ``out_path`` (None: neither file is
    written) and return it."""
    mpath = Path(matrix_path)
    if not mpath.exists():
        raise SystemExit(
            f"specialize: no matrix at {matrix_path}: run `python -m "
            "repro_torch.benchmarks.matrix" + (" --smoke" if smoke else "")
            + "` first (the specializer trains on its cells)")
    matrix = json.loads(mpath.read_text())
    if bool(matrix.get("smoke")) != bool(smoke):
        raise SystemExit(
            f"specialize: the matrix has smoke={matrix.get('smoke')} but "
            f"this run asked smoke={smoke}: train on a matrix produced "
            "with the same flag")

    rows = sl.training_table(matrix)
    avail = sorted({c for r in rows for c in r.seconds})
    model = sl.fit_matrix(matrix, max_depth=max_depth)
    model_path = None
    if out_path is not None:
        model_path = Path(sl.save_model(model, model_out)).resolve()
        if model_path.is_relative_to(_ROOT):  # recorded from the root
            model_path = model_path.relative_to(_ROOT)
        model_path = str(model_path)
    trace_model = sl.fit_matrix(matrix, max_depth=max_depth,
                                trace_features=True)
    profs = _taxonomy_profiles(matrix)

    policies = {
        "learned": {r.workload: model.predict_name(r.features)
                    for r in rows},
        "trace_augmented": {
            r.workload: trace_model.predict_name({**r.features, **r.trace})
            for r in rows},
        "static_full": {
            r.workload: specialize(TABLE_III[r.app],
                                   profs[r.input_name]).name
            for r in rows},
        "static_partial": {
            r.workload: specialize_partial(TABLE_III[r.app],
                                           profs[r.input_name]).name
            for r in rows},
    }

    def seconds_of(r, name):
        return r.seconds[sl.project_config(name, avail)]

    def accuracy(choice, tolerance):
        ok = sum(seconds_of(r, choice[r.workload])
                 <= r.seconds[r.label] * (1.0 + tolerance) for r in rows)
        return ok / len(rows)

    def geomean_us(choice_fn):
        return _geomean(seconds_of(r, choice_fn(r)) * 1e6 for r in rows)

    acc = {}
    for pname, choice in policies.items():
        acc[pname] = accuracy(choice, 0.0)
        acc[f"{pname}_tol"] = accuracy(choice, tol)
    geo = {p: geomean_us(lambda r, c=c: c[r.workload])
           for p, c in policies.items()}
    geo["oracle"] = geomean_us(lambda r: r.label)
    always = {c: geomean_us(lambda r, c=c: c) for c in avail}
    best_always = min(always, key=always.get)
    speedup = always[best_always] / geo["learned"]

    per_workload = {
        r.workload: {
            "best": r.label,
            **{p: sl.project_config(c[r.workload], avail)
               for p, c in policies.items()},
        } for r in rows}

    result = {
        "smoke": bool(smoke),
        "card": matrix.get("card"),
        "pythonhashseed": os.environ.get("PYTHONHASHSEED"),
        "workload": {
            "matrix": matrix["workload"], "tol": tol,
            "max_depth": max_depth, "features": list(sl.FEATURES),
            "n_workloads": len(rows), "configs": avail,
        },
        "model": {
            "path": model_path,
            "version": sl.MODEL_VERSION,
            "classes": list(model.classes),
            "depth": model.to_json()["depth"],
            "n_leaves": model.to_json()["n_leaves"],
            "label_histogram": model.meta["label_histogram"],
        },
        "taxonomy": {name: {"volume_kb": p.volume_kb, "reuse": p.reuse,
                            "imbalance": p.imbalance,
                            "classes": p.volume_class + p.reuse_class
                            + p.imbalance_class}
                     for name, p in profs.items()},
        "accuracy": acc,
        "e2e": {
            "geomean_us": {**geo, "always": always},
            "best_always": {"config": best_always,
                            "geomean_us": always[best_always]},
            "speedup_vs_best_always": speedup,
        },
        "per_workload": per_workload,
        "gate": {
            "accuracy_ge_partial": acc["learned_tol"]
            >= acc["static_partial_tol"],
            "e2e_ge_best_always": speedup >= 1.0,
        },
    }
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
    print(f"specialize: model -> {model_path} "
          f"(depth={result['model']['depth']}, "
          f"leaves={result['model']['n_leaves']})", flush=True)
    for pname in policies:
        print(f"specialize {pname}: accuracy={acc[pname]:.3f} "
              f"(tol {tol:.0%}: {acc[pname + '_tol']:.3f}) "
              f"geomean={geo[pname]:.1f}us", flush=True)
    print(f"specialize_summary,{len(rows)},learned_acc="
          f"{acc['learned_tol']:.3f};partial_acc="
          f"{acc['static_partial_tol']:.3f};"
          f"speedup_vs_always_{best_always}={speedup:.2f}x", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--matrix", default=str(MATRIX),
                    help="matrix record to train and evaluate on")
    ap.add_argument("--model-out", default=str(MODEL_OUT))
    ap.add_argument("--smoke", action="store_true",
                    help="expect a --smoke matrix")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL)
    args = ap.parse_args(argv)
    run_specialize(out_path=args.out, matrix_path=args.matrix,
                   model_out=args.model_out, smoke=args.smoke,
                   tol=args.tol)


if __name__ == "__main__":
    main()
