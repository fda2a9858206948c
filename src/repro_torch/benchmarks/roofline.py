"""Roofline analysis from the dry run's records (counterpart of
``benchmarks/roofline.py``), at the NVIDIA H100's peaks.

Three terms per (arch x shape x mesh), in seconds per step:

    compute    = FLOPs / (ranks x 989e12)       [H100 SXM, dense bf16]
    memory     = HBM bytes / (ranks x 3.35e12)  [H100 SXM, HBM3]
    collective = collective bytes / 50e9        [one 400 Gb/s NIC per GPU]

Each 16-wide axis of the production meshes spans two 8-GPU HGX nodes,
so a collective over it crosses the network: the collective term takes
one NIC's 50 GB/s, not NVLink's.  The card's published peaks are the
data sheet's at its full 700 W; these are analytic estimates, not
measurements.

FLOPs and bytes come from two sources, both reported:
- the dry run's ``cost.flops``: each rank's local ops as the port runs
  them (every layer counted; the attention of every chunk, as the plain
  ``blocked_attention`` visits them all);
- ``analytic_*``: closed-form per family (the standard MFU convention,
  the reference's arithmetic on the port's configs), used for the
  compute and memory terms.  ``model_flops`` is 6 N D (dense) or
  6 N_active D (MoE); its ratio to the analytic total shows how much of
  the counted compute is "useful".

The collective bytes are the dry run's per-rank result bytes.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs.registry import get_arch

#: NVIDIA H100 SXM, dense bf16 tensor-core peak (FLOP/s)
H100_BF16_FLOPS = 989e12
#: NVIDIA H100 SXM, HBM3 bandwidth (B/s)
H100_HBM_BW = 3.35e12
#: one 400 Gb/s NIC per H100 (B/s), the link of a collective over an
#: axis wider than one 8-GPU node
H100_NIC_BW = 50e9

DRYRUN_DIR = Path("results/torch/dryrun")
OUT = Path("results/torch/roofline.json")

__all__ = ["analyze", "analytic_cell", "to_markdown", "to_markdown_cells",
           "H100_BF16_FLOPS",
           "H100_HBM_BW", "H100_NIC_BW"]


# ---------------------------------------------------------------------------
# analytic FLOP / byte models (the reference's, roofline.py:38-141)
# ---------------------------------------------------------------------------
def _lm_terms(cfg, shape, moe=False):
    L, d, hq, hkv, dh = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                         cfg.n_kv_heads, cfg.d_head)
    n_total = cfg.n_params
    n_active = cfg.n_active_params if moe else n_total
    p_bytes = 2 * n_total                      # bf16
    opt_bytes = 8 * n_total                    # 2 x fp32 moments
    if shape == "train_4k":
        b, s = 256, 4096
        t = b * s
        flops = 6 * n_active * t
        win = cfg.window or s
        flops += 12 * L * b * hq * dh * s * min(s, win) * 0.5  # causal attn
        bytes_ = 3 * p_bytes + 2 * opt_bytes \
            + 12 * L * t * d                   # act r/w + remat reread, bf16
        return flops, bytes_, t
    if shape == "prefill_32k":
        b, s = 32, 32768
        t = b * s
        flops = 2 * n_active * t
        win = cfg.window or s
        flops += 4 * L * b * hq * dh * s * min(s, win) * 0.5
        bytes_ = p_bytes + 6 * L * t * d
        return flops, bytes_, t
    # decode shapes: one token per sequence
    b, s = (128, 32768) if shape == "decode_32k" else (1, 524288)
    win = cfg.window or s
    kv = min(s, win)
    flops = 2 * n_active * b + 4 * L * b * hq * dh * kv
    read_cache = 2 * L * b * hkv * kv * dh * 2      # bytes actually read
    bytes_ = p_bytes + read_cache
    return flops, bytes_, b


def _gnn_terms(name, dims):
    n, e = dims["n_nodes"], dims["n_edges"]
    if name == "meshgraphnet":
        h, L = 128, 15
        fl = 3 * L * (8 * e * h * h + 6 * n * h * h)
        by = 3 * L * (e * h * 4 * 3 + n * h * 4 * 3)
    elif name == "schnet":
        h, L, rbf = 64, 3, 300
        fl = 3 * L * (2 * e * (rbf * h + h * h) + 6 * n * h * h)
        by = 3 * L * (e * (rbf + h) * 4 + n * h * 4 * 3)
    elif name == "pna":
        h, L = 75, 4
        fl = 3 * L * (4 * e * h * h + 26 * n * h * h)
        by = 3 * L * (e * h * 4 * 2 + n * 13 * h * 4)
    else:  # equiformer-v2 (estimate; SH+Wigner+SO2+node linear)
        c, L, k = 128, 12, 49
        per_edge = 940 * c + 120 * c * c + 64 * k * 12   # rot+conv+SH
        per_node = 2 * k * c * c + 8 * c * c
        fl = 3 * L * (e * per_edge + n * per_node)
        by = 3 * L * (e * k * c * 4 + n * k * c * 4) // 4
    return fl, by, n


def _dlrm_terms(cfg, shape):
    d = cfg.embed_dim
    bot = [(13, 512), (512, 256), (256, 128)]
    nf = cfg.n_sparse + 1
    n_int = nf * (nf - 1) // 2 + d
    top = [(n_int, 1024), (1024, 1024), (1024, 512), (512, 256), (256, 1)]
    mlp_flops = 2 * (sum(a * b for a, b in bot) + sum(a * b for a, b in top))
    inter = 2 * nf * nf * d
    if shape == "train_batch":
        b = 65536
        fl = 3 * b * (mlp_flops + inter)
        by = b * cfg.n_sparse * d * 4 * 3 + b * (13 + n_int) * 4 * 3
        return fl, by, b
    if shape == "serve_p99":
        b = 512
    elif shape == "serve_bulk":
        b = 262144
    else:  # retrieval_cand
        nc = 1000448
        fl = 2 * nc * d + mlp_flops
        by = nc * d * 4
        return fl, by, 1
    fl = b * (mlp_flops + inter)
    by = b * cfg.n_sparse * d * 4 + b * (13 + n_int) * 4
    return fl, by, b


def analytic_cell(arch_name, shape):
    """(FLOPs, HBM bytes, model FLOPs) of one step of a cell, global."""
    arch = get_arch(arch_name)
    if arch.family in ("lm", "moe"):
        fl, by, unit = _lm_terms(arch.cfg, shape, moe=arch.family == "moe")
        n = arch.cfg.n_params
        n_act = getattr(arch.cfg, "n_active_params", n)
        model_flops = 6 * n_act * unit if shape.startswith("train") \
            else 2 * n_act * unit
        return fl, by, model_flops
    if arch.family == "gnn":
        from repro_torch.configs.base import GNN_SHAPES
        fl, by, _ = _gnn_terms(arch_name, GNN_SHAPES[shape])
        return fl, by, fl
    fl, by, _ = _dlrm_terms(arch.cfg, shape)
    return fl, by, fl


# ---------------------------------------------------------------------------
def analyze(dryrun_dir=DRYRUN_DIR, out=OUT, mesh=None):
    """One row per ``ok`` record of ``dryrun_dir`` (``mesh``: "single",
    "multi" or None for both), written to ``out`` (unless None)."""
    rows = []
    pattern = "*.json" if mesh is None else f"*__{mesh}.json"
    for path in sorted(Path(dryrun_dir).glob(pattern)):
        d = json.loads(path.read_text())
        if not d.get("ok"):
            continue
        ranks = d["n_devices"]
        arch, shape = d["arch"], d["shape"]
        fl, by, model_fl = analytic_cell(arch, shape)
        coll = d.get("collectives", {})
        coll_bytes = sum(v.get("bytes", 0) for v in coll.values()
                         if isinstance(v, dict))
        t_comp = fl / (ranks * H100_BF16_FLOPS)
        t_mem = by / (ranks * H100_HBM_BW)
        t_coll = coll_bytes / H100_NIC_BW        # already per-rank bytes
        terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
        dominant = max(terms, key=terms.get)
        bound = max(terms.values())
        rows.append({
            "arch": arch, "shape": shape, "mesh": d["mesh"],
            "chips": ranks,
            "analytic_flops": fl,
            "dryrun_flops_per_rank": d.get("cost", {}).get("flops", -1),
            "model_flops": model_fl,
            "useful_ratio": round(model_fl / fl, 3) if fl else None,
            "analytic_bytes": by,
            "collective_bytes_per_dev": coll_bytes,
            "collectives": coll,
            "t_compute_s": t_comp,
            "t_memory_s": t_mem,
            "t_collective_s": t_coll,
            "dominant": dominant,
            "roofline_bound_s": bound,
            "roofline_fraction": round(t_comp / bound, 4) if bound else None,
            "memory_per_dev_bytes": d.get("memory", {}).get("peak_bytes"),
            "dryrun_seconds": d.get("total_s"),
            "estimate": "analytic, at H100 data-sheet peaks; not measured",
        })
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(rows, indent=2))
    return rows


def to_markdown(rows):
    hdr = ("| arch | shape | mesh | t_compute | t_memory | t_collective | "
           "dominant | peak GB/rank | useful |\n"
           "|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]

    def fmt(s):
        return f"{s * 1e3:.2f}ms" if s >= 1e-3 else f"{s * 1e6:.0f}us"

    for r in rows:
        mem = r["memory_per_dev_bytes"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt(r['t_compute_s'])} | {fmt(r['t_memory_s'])} | "
            f"{fmt(r['t_collective_s'])} | **{r['dominant']}** | "
            f"{mem / 1e9:.2f} | {r['useful_ratio']} |")
    return "\n".join(lines)


def to_markdown_cells(rows):
    """One row per (arch, shape): each mesh's per-rank peak GB, its
    three terms, the dominant terms and the dry run's seconds for the
    cell, ``single / multi``."""
    by = {}
    for r in rows:
        by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    lines = ["| arch | shape | peak GB/rank | t_compute ms | t_memory ms "
             "| t_collective ms | dominant | dry run s |",
             "|---|---|---|---|---|---|---|---|"]

    def both(cell, key, scale, fmt):
        return " / ".join(fmt.format(cell[m][key] * scale) if m in cell
                          else "-" for m in ("16x16", "2x16x16"))

    for (arch, shape), cell in sorted(by.items()):
        lines.append(
            f"| {arch} | {shape} | "
            f"{both(cell, 'memory_per_dev_bytes', 1e-9, '{:.2f}')} | "
            f"{both(cell, 't_compute_s', 1e3, '{:.4g}')} | "
            f"{both(cell, 't_memory_s', 1e3, '{:.4g}')} | "
            f"{both(cell, 't_collective_s', 1e3, '{:.4g}')} | "
            + " / ".join(cell[m]["dominant"] if m in cell else "-"
                         for m in ("16x16", "2x16x16")) + " | "
            + both(cell, "dryrun_seconds", 1, "{:.1f}") + " |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", default=str(DRYRUN_DIR))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--cells", action="store_true",
                    help="one row per (arch, shape), both meshes in it")
    args = ap.parse_args(argv)
    rows = analyze(args.dryrun_dir, args.out, args.mesh)
    print(to_markdown_cells(rows) if args.cells else to_markdown(rows))


if __name__ == "__main__":
    main()
