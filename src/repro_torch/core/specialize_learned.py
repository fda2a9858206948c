"""Learned best-config specialization (paper Sec. IV, the predictive
half of the specialization contribution).

Counterpart of ``repro.core.specialize_learned``, function for function
and in the same file format, so a model file moves between the two
packages both ways.  ``core/model.py`` holds the paper's static trees;
this module learns the same mapping -- workload features to the best
(push/pull/dynamic x coherence x consistency) :class:`SystemConfig` --
from a measured matrix (``repro_torch.benchmarks.matrix``, on the card
``results/torch/BENCH_matrix.json``).  The scorer is a small CART
decision tree (gini) fit in numpy, saved as a versioned JSON model file
(:data:`DEFAULT_MODEL_PATH`).

The features are known at admission time, before the workload has run,
so one vector feeds training (from the matrix's ``inputs`` records) and
serving (from the live graph through
:func:`repro_torch.graph.datasets.degree_profile`): log2 |V|, log2 |E|,
log2 average degree, the out-degree coefficient of variation
(``degree_skew``), the :data:`~repro_torch.graph.datasets.DEGREE_PROFILES`
class one-hot, and the app's Table III one-hots.  The matrix's direction
and occupancy traces are label-side: they feed only the ablation model
(:func:`fit_matrix` with ``trace_features=True``).

:func:`resolve_config` serves the ``specialize=`` knob with the chain
**learned -> static partial tree -> caller config**: a missing, corrupt
or version-skewed model file falls back to the Sec. IV-B tree with a
structured :class:`SpecializeFallbackWarning`, and a program without
Table III properties keeps the caller's config.  Decisions are cached
per graph identity in :data:`~repro_torch.core.plan_cache.PLAN_CACHE`
(kind ``"specialized_config"``) and per
:func:`~repro_torch.kernels.autotune.degree_signature` in a process-wide
memo.  Profiling and features read the host graph's numpy arrays.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.config_space import SystemConfig
from repro_torch.core.model import specialize, specialize_partial
from repro_torch.core.plan_cache import PLAN_CACHE
from repro_torch.core.properties import TABLE_III, AlgorithmicProperties, \
    Locus, Traversal
from repro_torch.core.taxonomy import profile_graph

__all__ = [
    "DEFAULT_MODEL_PATH", "MODEL_FORMAT", "MODEL_VERSION",
    "FEATURES", "TRACE_FEATURES",
    "SpecializeFallbackWarning", "ModelFileError",
    "LearnedSpecializer", "WorkloadRecord",
    "features_from_graph", "features_from_input", "training_table",
    "fit_matrix", "load_model", "save_model",
    "project_config", "static_config_for", "resolve_config",
    "memo_stats", "clear_memo",
]

#: Where the serving model lives, relative to the working directory
#: (``repro_torch.benchmarks.specialize`` refreshes it from the card's
#: matrix); the reference's own model stays at
#: ``results/specialize_model.json``.
DEFAULT_MODEL_PATH = "results/torch/specialize_model.json"
MODEL_FORMAT = "repro-specialize-model"
MODEL_VERSION = 1

#: Admission-time feature vector, in serialized order.  Training and
#: serving must agree on this list; the model file pins its own copy
#: and :func:`load_model` rejects a mismatch.
FEATURES = (
    "log2_nodes", "log2_edges", "log2_avg_degree", "degree_skew",
    "profile_near_regular", "profile_social", "profile_web_crawl",
    "trav_dynamic",
    "ctrl_source", "ctrl_target", "ctrl_symmetric",
    "info_source", "info_target", "info_symmetric",
)

#: Trace-derived features (training-time ablation only — see module
#: docstring): fraction of pull iterations and of sparse-gathered
#: iterations in the matrix's first dynamic cell for the workload.
TRACE_FEATURES = ("dyn_pull_frac", "dyn_sparse_frac")

_PROFILES = ("near-regular", "social", "web-crawl")


class SpecializeFallbackWarning(UserWarning):
    """A specialization tier was unavailable and a lower tier served the
    decision.  The message carries a structured ``code=`` prefix
    (``model_missing`` / ``model_corrupt`` / ``no_properties`` /
    ``predict_failed``)."""


class ModelFileError(ValueError):
    """The model file exists but cannot serve predictions."""

    def __init__(self, code: str, detail: str):
        self.code = code
        super().__init__(f"{code}: {detail}")


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------
def _props_onehots(props: AlgorithmicProperties) -> Dict[str, float]:
    return {
        "trav_dynamic": 1.0 if props.traversal is Traversal.DYNAMIC else 0.0,
        "ctrl_source": 1.0 if props.control is Locus.SOURCE else 0.0,
        "ctrl_target": 1.0 if props.control is Locus.TARGET else 0.0,
        "ctrl_symmetric": 1.0 if props.control is Locus.SYMMETRIC else 0.0,
        "info_source": 1.0 if props.information is Locus.SOURCE else 0.0,
        "info_target": 1.0 if props.information is Locus.TARGET else 0.0,
        "info_symmetric": 1.0 if props.information is Locus.SYMMETRIC
        else 0.0,
    }


def _shape_features(n_nodes: int, n_edges: int, degree_skew: float,
                    profile: str) -> Dict[str, float]:
    n, m = max(int(n_nodes), 1), max(int(n_edges), 1)
    feats = {
        "log2_nodes": math.log2(n),
        "log2_edges": math.log2(m),
        "log2_avg_degree": math.log2(max(m / n, 1e-6)),
        "degree_skew": float(degree_skew),
    }
    for p in _PROFILES:
        feats[f"profile_{p.replace('-', '_')}"] = 1.0 if profile == p else 0.0
    return feats


def features_from_input(props: AlgorithmicProperties,
                        input_record: Dict[str, Any]) -> Dict[str, float]:
    """Feature dict from a matrix artifact's ``inputs[name]`` record."""
    return {**_shape_features(input_record["n_nodes"],
                              input_record["n_edges"],
                              input_record["degree_skew"],
                              input_record["profile"]),
            **_props_onehots(props)}


def features_from_graph(props: AlgorithmicProperties,
                        graph) -> Dict[str, float]:
    """Admission-time feature dict from a live graph (same vector the
    trainer derives from the matrix artifact)."""
    from repro_torch.graph.datasets import degree_profile
    prof = degree_profile(graph)
    return {**_shape_features(prof["n_nodes"], prof["n_edges"],
                              prof["degree_skew"], prof["profile"]),
            **_props_onehots(props)}


def _vector(feats: Dict[str, float], names: Sequence[str]) -> np.ndarray:
    return np.asarray([float(feats.get(n, 0.0)) for n in names], np.float64)


# ---------------------------------------------------------------------------
# pure-numpy CART (gini) — deterministic: first strictly-better split wins
# ---------------------------------------------------------------------------
def _gini(counts: np.ndarray) -> float:
    tot = counts.sum()
    if tot == 0:
        return 0.0
    p = counts / tot
    return float(1.0 - np.sum(p * p))


def _fit_tree(X: np.ndarray, y: np.ndarray, n_classes: int,
              max_depth: int, min_leaf: int, depth: int = 0) -> dict:
    counts = np.bincount(y, minlength=n_classes)
    leaf = {"counts": counts.tolist()}
    if (depth >= max_depth or counts.max() == y.size
            or y.size < 2 * min_leaf):
        return leaf
    parent = _gini(counts)
    best: Optional[Tuple[float, int, float]] = None  # (impurity, j, thr)
    for j in range(X.shape[1]):
        vals = np.unique(X[:, j])
        if vals.size < 2:
            continue
        for thr in (vals[:-1] + vals[1:]) / 2.0:
            mask = X[:, j] <= thr
            nl, nr = int(mask.sum()), int((~mask).sum())
            if nl < min_leaf or nr < min_leaf:
                continue
            imp = (nl * _gini(np.bincount(y[mask], minlength=n_classes))
                   + nr * _gini(np.bincount(y[~mask], minlength=n_classes))
                   ) / y.size
            if best is None or imp < best[0] - 1e-12:
                best = (imp, j, float(thr))
    if best is None or best[0] >= parent - 1e-12:
        return leaf
    _, j, thr = best
    mask = X[:, j] <= thr
    return {"feature": int(j), "threshold": thr,
            "left": _fit_tree(X[mask], y[mask], n_classes, max_depth,
                              min_leaf, depth + 1),
            "right": _fit_tree(X[~mask], y[~mask], n_classes, max_depth,
                               min_leaf, depth + 1)}


def _tree_predict(node: dict, x: np.ndarray) -> int:
    while "feature" in node:
        node = node["left"] if x[node["feature"]] <= node["threshold"] \
            else node["right"]
    return int(np.argmax(node["counts"]))  # ties -> lowest class index


def _tree_depth(node: dict) -> int:
    if "feature" not in node:
        return 0
    return 1 + max(_tree_depth(node["left"]), _tree_depth(node["right"]))


def _tree_leaves(node: dict) -> int:
    if "feature" not in node:
        return 1
    return _tree_leaves(node["left"]) + _tree_leaves(node["right"])


# ---------------------------------------------------------------------------
# the model object + (de)serialization
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LearnedSpecializer:
    """A trained best-config predictor: feature order, class (config
    name) vocabulary, and the fitted tree."""
    features: Tuple[str, ...]
    classes: Tuple[str, ...]
    tree: dict
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def predict_name(self, feats: Dict[str, float]) -> str:
        """Predicted config *name* for one feature dict."""
        return self.classes[_tree_predict(self.tree,
                                          _vector(feats, self.features))]

    def predict(self, props: AlgorithmicProperties, graph,
                n_chunks: int = 8) -> SystemConfig:
        """Predicted :class:`SystemConfig` for a live workload."""
        name = self.predict_name(features_from_graph(props, graph))
        return SystemConfig.from_name(name, n_chunks=n_chunks)

    def to_json(self) -> dict:
        return {"format": MODEL_FORMAT, "version": MODEL_VERSION,
                "features": list(self.features),
                "classes": list(self.classes),
                "tree": self.tree,
                "depth": _tree_depth(self.tree),
                "n_leaves": _tree_leaves(self.tree),
                "meta": self.meta}

    @classmethod
    def from_json(cls, data: Any) -> "LearnedSpecializer":
        if not isinstance(data, dict):
            raise ModelFileError("model_corrupt", "not a JSON object")
        if data.get("format") != MODEL_FORMAT:
            raise ModelFileError(
                "model_corrupt", f"format {data.get('format')!r} != "
                f"{MODEL_FORMAT!r}")
        if data.get("version") != MODEL_VERSION:
            raise ModelFileError(
                "model_version", f"model version {data.get('version')!r} "
                f"!= supported {MODEL_VERSION}")
        try:
            feats = tuple(str(f) for f in data["features"])
            classes = tuple(str(c) for c in data["classes"])
            tree = data["tree"]
            for c in classes:
                SystemConfig.from_name(c)  # vocabulary must be decodable
            if not isinstance(tree, dict) or not classes:
                raise KeyError("tree/classes")
        except (KeyError, TypeError, ValueError, IndexError) as exc:
            raise ModelFileError("model_corrupt",
                                 f"bad model payload ({exc!r})") from exc
        return cls(features=feats, classes=classes, tree=tree,
                   meta=data.get("meta", {}))


def save_model(model: LearnedSpecializer, path=DEFAULT_MODEL_PATH) -> str:
    """Serialize with the versioned header (atomic replace); returns
    the path written."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps(model.to_json(), indent=2, sort_keys=True))
    os.replace(tmp, p)
    return str(p)


def load_model(path=DEFAULT_MODEL_PATH) -> LearnedSpecializer:
    """Load + validate a model file.  Raises ``OSError`` when the file
    is absent/unreadable and :class:`ModelFileError` when present but
    unusable (corrupt JSON, wrong format/version, bad payload)."""
    text = Path(path).read_text()
    try:
        data = json.loads(text)
    except ValueError as exc:
        raise ModelFileError("model_corrupt",
                             f"invalid JSON in {path} ({exc})") from exc
    return LearnedSpecializer.from_json(data)


# ---------------------------------------------------------------------------
# training from the matrix artifact
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkloadRecord:
    """One training row distilled from a matrix cell."""
    workload: str           # "<input>/<app>"
    app: str
    input_name: str
    features: Dict[str, float]
    label: str              # measured-best config name
    seconds: Dict[str, float]  # config name -> best-of-repeats seconds
    trace: Dict[str, float]    # TRACE_FEATURES (0.0 when no dynamic cell)


def _trace_features(cell_configs: Dict[str, dict]) -> Dict[str, float]:
    for cname in sorted(cell_configs):
        if not cname.startswith("D"):
            continue
        cell = cell_configs[cname]
        dirs = cell.get("directions") or ""
        its = max(int(cell.get("iterations", 0)), 1)
        if dirs:
            return {"dyn_pull_frac": dirs.count("T") / len(dirs),
                    "dyn_sparse_frac": (cell.get("n_sparse") or 0) / its}
    return {"dyn_pull_frac": 0.0, "dyn_sparse_frac": 0.0}


def training_table(matrix: dict) -> List[WorkloadRecord]:
    """Distill a ``BENCH_matrix.json`` dict into training rows.

    Workloads whose app has no Table III properties are skipped (none
    of the registered apps hit this today).
    """
    rows: List[WorkloadRecord] = []
    inputs = matrix.get("inputs", {})
    for wl, cell in sorted(matrix.get("cells", {}).items()):
        input_name, app = wl.split("/", 1)
        props = TABLE_III.get(app)
        rec = inputs.get(input_name)
        if props is None or rec is None:
            continue
        secs = {c: float(v["seconds"])
                for c, v in cell["configs"].items()}
        rows.append(WorkloadRecord(
            workload=wl, app=app, input_name=input_name,
            features=features_from_input(props, rec),
            label=min(secs, key=secs.get),
            seconds=secs,
            trace=_trace_features(cell["configs"])))
    return rows


def fit_matrix(matrix: dict, max_depth: int = 6, min_leaf: int = 1,
               trace_features: bool = False) -> LearnedSpecializer:
    """Fit the decision-tree scorer against the measured-best cells.

    ``trace_features=True`` appends :data:`TRACE_FEATURES` to the
    vector — the ablation model ``repro_torch.benchmarks.specialize``
    reports as an upper bound; the serving model is always trained
    without them (admission time has no trace).
    """
    rows = training_table(matrix)
    if not rows:
        raise ValueError("matrix artifact has no trainable cells")
    names = FEATURES + (TRACE_FEATURES if trace_features else ())
    classes = tuple(sorted({r.label for r in rows}))
    cls_idx = {c: i for i, c in enumerate(classes)}
    X = np.stack([_vector({**r.features, **r.trace}, names) for r in rows])
    y = np.asarray([cls_idx[r.label] for r in rows], np.int64)
    tree = _fit_tree(X, y, len(classes), max_depth, min_leaf)
    model = LearnedSpecializer(features=names, classes=classes, tree=tree)
    correct = sum(model.predict_name({**r.features, **r.trace}) == r.label
                  for r in rows)
    wl = matrix.get("workload", {})
    trained_on = {
        "n_workloads": len(rows), "smoke": bool(matrix.get("smoke")),
        "configs": wl.get("configs"), "apps": wl.get("apps"),
        "graphs": wl.get("graphs"), "scale": wl.get("scale"),
    }
    if "card" in matrix:  # the port's matrices name the card they ran on
        trained_on["card"] = matrix["card"]
    model.meta = {
        "trained_on": trained_on,
        "trace_features": bool(trace_features),
        "training_accuracy": correct / len(rows),
        "label_histogram": {c: int(np.sum(y == i))
                            for i, c in enumerate(classes)},
        # label-side trace diagnostics: which workloads' dynamic cell
        # actually mixed directions / ran the sparse path
        "workload_traces": {r.workload: r.trace for r in rows},
    }
    return model


# ---------------------------------------------------------------------------
# static-model helpers shared by serving and evaluation
# ---------------------------------------------------------------------------
def project_config(name: str, available: Sequence[str]) -> str:
    """Project a config name onto an available vocabulary.

    Exact match wins; otherwise the same-direction config closest on
    (coherence, consistency); otherwise the first available name
    (sorted).  Evaluating the 18-cell static trees against a reduced
    (e.g. smoke, 3-config) matrix needs this — the tree may name a
    cell the table never measured.
    """
    avail = sorted(available)
    if name in avail:
        return name
    same_dir = [c for c in avail if c[0] == name[0]]
    if same_dir:
        return min(same_dir, key=lambda c: (c[1] != name[1],
                                            c[2] != name[2], c))
    return avail[0]


def static_config_for(props: AlgorithmicProperties, graph,
                      partial: bool = False) -> SystemConfig:
    """The static tree's choice for a live workload (profiles the graph
    through the Sec. III taxonomy, cached per graph in the plan
    cache)."""
    profile = PLAN_CACHE.get(graph, "graph_profile", (),
                             lambda: profile_graph(graph))
    return (specialize_partial if partial else specialize)(props, profile)


# ---------------------------------------------------------------------------
# serving-time resolution: learned -> static partial -> caller
# ---------------------------------------------------------------------------
_MODEL_CACHE: Dict[Tuple[str, int], LearnedSpecializer] = {}
#: (degree_signature, app, mode, model_tag) -> (config_name, source):
#: lets a *fresh* graph that quantizes like one already decided reuse
#: the decision without feature extraction (the plan cache above it is
#: keyed on graph identity, so it cannot serve this case).
_SIG_MEMO: Dict[tuple, Tuple[str, str]] = {}
_MEMO_LOCK = threading.Lock()
_MEMO_STATS = {"hits": 0, "misses": 0}


def memo_stats() -> Dict[str, int]:
    """Hit/miss counters of the signature-level decision memo."""
    with _MEMO_LOCK:
        return dict(_MEMO_STATS, entries=len(_SIG_MEMO))


def clear_memo() -> None:
    with _MEMO_LOCK:
        _SIG_MEMO.clear()
        _MEMO_STATS.update(hits=0, misses=0)
    _MODEL_CACHE.clear()


def _normalize_specialize(mode) -> str:
    if mode in (None, False, "off"):
        return "off"
    if mode in ("static", "learned"):
        return mode
    raise ValueError(f"unknown specialize mode {mode!r}; expected "
                     "'off', 'static' or 'learned' (or None/False)")


def _current_model(path) -> LearnedSpecializer:
    """Load the model file, cached on (path, mtime) so serving reloads
    automatically after a refresh without re-parsing per admission."""
    p = str(path)
    mtime = os.stat(p).st_mtime_ns
    key = (p, mtime)
    model = _MODEL_CACHE.get(key)
    if model is None:
        model = load_model(p)
        _MODEL_CACHE.clear()  # one live generation per path is plenty
        _MODEL_CACHE[key] = model
    return model


def _model_tag(path) -> tuple:
    try:
        return (str(path), os.stat(str(path)).st_mtime_ns)
    except OSError:
        return (str(path), None)


def _warn(code: str, detail: str) -> None:
    warnings.warn(f"code={code}: {detail}", SpecializeFallbackWarning,
                  stacklevel=3)


def _decide(mode: str, props: AlgorithmicProperties, graph,
            model_path) -> Tuple[str, str]:
    """(config_name, source) for one workload, applying the fallback
    chain.  Never raises: the last tier is unreachable only if the
    static partial tree itself throws, which degrades to the caller."""
    if mode == "static":
        return static_config_for(props, graph, partial=False).name, "static"
    try:
        model = _current_model(model_path)
        return (model.predict_name(features_from_graph(props, graph)),
                "learned")
    except OSError as exc:
        _warn("model_missing",
              f"no readable model at {model_path} ({exc}); falling back "
              "to the static partial tree")
    except ModelFileError as exc:
        _warn(exc.code, f"{exc}; falling back to the static partial tree")
    except Exception as exc:  # noqa: BLE001 — prediction must never crash
        _warn("predict_failed",
              f"learned prediction failed ({exc!r}); falling back to the "
              "static partial tree")
    return static_config_for(props, graph, partial=True).name, \
        "static_partial"


def resolve_config(program, graph, config: SystemConfig, specialize,
                   model_path=None) -> Tuple[SystemConfig, str]:
    """Resolve the config one workload should actually run under.

    ``specialize`` is the serving knob: ``"off"``/``None`` keeps the
    caller's ``config`` (source ``"caller"``); ``"static"`` applies the
    paper's full Fig. 4 tree; ``"learned"`` consults the trained model
    (``model_path``, default :data:`DEFAULT_MODEL_PATH` resolved at
    call time) with the structured fallback chain **learned -> static
    partial -> caller**.  Returns ``(config, source)`` where ``source``
    is ``"caller" | "static" | "static_partial" | "learned"``.

    Decisions are cached in :data:`PLAN_CACHE` under
    ``kind="specialized_config"`` per graph identity, and process-wide
    per degree signature (see :func:`memo_stats`), so repeat admission
    of a same-signature graph never re-extracts features.  The
    predicted config inherits the caller's ``n_chunks``.
    """
    mode = _normalize_specialize(specialize)
    if mode == "off":
        return config, "caller"
    props = getattr(program, "properties", None) \
        if getattr(program, "name", None) in TABLE_III else None
    if props is None:
        _warn("no_properties",
              f"program {getattr(program, 'name', program)!r} has no "
              "Table III properties; keeping the caller's config")
        return config, "caller"
    if model_path is None:
        model_path = DEFAULT_MODEL_PATH
    tag = _model_tag(model_path) if mode == "learned" else ()
    key = (props, mode, tag)

    def build() -> Tuple[str, str]:
        from repro_torch.kernels.autotune import degree_signature
        sig_key = (degree_signature(graph),) + key
        with _MEMO_LOCK:
            hit = _SIG_MEMO.get(sig_key)
            if hit is not None:
                _MEMO_STATS["hits"] += 1
                return hit
            _MEMO_STATS["misses"] += 1
        decision = _decide(mode, props, graph, model_path)
        with _MEMO_LOCK:
            _SIG_MEMO.setdefault(sig_key, decision)
        return decision

    name, source = PLAN_CACHE.get(graph, "specialized_config", key, build)
    return SystemConfig.from_name(name, n_chunks=config.n_chunks), source
