#!/usr/bin/env python3
"""Time versions of K3 (the port's embedding bag) against each other on
one card, in turns, on the same inputs.

    python3 tools/k3_ab.py [--configs 1x256,8x128] [--out FILE] [DIR ...]

Each DIR holds an ``embedding_bag.cu``, for example an unpacked ``git
archive`` of another commit's ``src/repro_torch/kernels/embedding_bag/
csrc``.  The checkout's own source is timed as ``cur``.  Every version
is built into its own library (its ``ptxas`` report is printed) and
called through its C entry point:
- a version with the table-batched ``embag_tables_f32`` runs once per
  launch configuration of ``--configs`` (items per warp x threads per
  CTA) that it takes, all tables of a case in one launch;
- a version with only the single-table ``embag_f32`` pools the F tables
  of a case in F launches.
Cases, at the capped MLPerf DLRM's widths (D = 128, every table capped at
16,000,000 rows, random tables from a seeded generator): one table of
16,000,000 rows at B = 512 and B = 262,144 (P = 1, sum) and B = 65,536
(P = 8, mean); all 26 tables at the serve_p99 and serve_bulk batches of
``serving_batch`` (P = 1, sum).  Versions run in the order cur, DIR...,
DIR... reversed, cur.  Each time is ``chip_smoke.time_ms``'s: the
CUDA-event median of 15 launches, each after a 256 MB L2 flush.  Each
version is first held against the plain version: bit-equal at P = 1,
rtol = atol = 1e-5 at P = 8.  Needs CUDA, ``nvcc`` and about 50 GB of
device memory.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# chip_smoke puts src/ on sys.path
from chip_smoke import DLRM_MAX_ROWS, time_ms  # noqa: E402
from repro_torch.configs.dlrm_mlperf import (CFG, capped,  # noqa: E402
                                             serving_batch)
from repro_torch.kernels._build import build  # noqa: E402
from repro_torch.kernels.embedding_bag import (SOURCE,  # noqa: E402
                                               embedding_bags_ref)
from repro_torch.models.dlrm import init_dlrm  # noqa: E402

SINGLE = [(512, 1, "sum"), (262_144, 1, "sum"), (65_536, 8, "mean")]


def _bind(source: Path):
    """The library of ``source`` and whether it has the batched entry."""
    lib_path, report = build(source)
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(lib, "embag_tables_f32"):
        lib.embag_tables_f32.argtypes = [p, p, i, p, ll, ll, p, ll, ll, ll,
                                         i, i, i, i, i, p]
        return lib, True
    lib.embag_f32.argtypes = [p, p, p, ll, i, i, i, ll, i, p]
    return lib, False


def _call(lib, batched, tables, idx, out, mean, config) -> int:
    """Pool ``tables`` by ``idx`` [B, F, P] into ``out`` [B, F, D];
    returns the largest CUDA error code of the launches."""
    stream = torch.cuda.current_stream().cuda_stream
    bags, n, pool = idx.shape
    d = tables[0].shape[1]
    if batched:
        ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in tables])
        rows = (ctypes.c_longlong * n)(*[t.shape[0] for t in tables])
        errs = [lib.embag_tables_f32(
            ptrs, rows, n, idx.data_ptr(), idx.stride(0), idx.stride(1),
            out.data_ptr(), out.stride(0), out.stride(1), bags, pool, d,
            int(mean), config[0], config[1], stream)]
    else:  # one launch per table, each into its own contiguous output
        errs = [lib.embag_f32(t.data_ptr(), idx[:, f].data_ptr(),
                              out[f].data_ptr(), t.shape[0], d, bags, pool,
                              idx.stride(0), int(mean), stream)
                for f, t in enumerate(tables)]
    return max(errs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--configs", default="1x256",
                    help="items per warp x threads per CTA, comma-separated")
    ap.add_argument("--out", default=None, help="write the times as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    configs = [tuple(int(x) for x in c.split("x"))
               for c in args.configs.split(",")]
    versions = [("cur", SOURCE)] + [
        (Path(d).name, Path(d) / "embedding_bag.cu") for d in args.dirs]
    libs = {}
    for name, source in versions:
        print(f"build {name}: {source}", flush=True)
        libs[name] = _bind(source)
    order = ([name for name, _ in versions]
             + [name for name, _ in versions[1:]][::-1] + ["cur"])

    cfg = capped(CFG, DLRM_MAX_ROWS)
    tables = init_dlrm(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev).tables
    rng = np.random.default_rng(12)
    cases = []
    for bags, pool, mode in SINGLE:
        idx = rng.integers(0, tables[0].shape[0], (bags, 1, pool))
        cases.append((f"single R={tables[0].shape[0]} B={bags} P={pool} "
                      f"{mode}", tables[:1],
                      torch.from_numpy(idx.astype(np.int32)).to(dev), mode))
    for cell in ("serve_p99", "serve_bulk"):
        sparse = serving_batch(cfg, cell, 0, device=dev)["sparse"]
        cases.append((f"{len(tables)} tables {cell} B={sparse.shape[0]}",
                      tables, sparse, "sum"))

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    record = []
    for label, tabs, idx, mode in cases:
        want = embedding_bags_ref(tabs, idx, mode=mode)
        out = torch.empty_like(want)
        per_table = out.transpose(0, 1).contiguous()  # [F, B, D]
        print(f"case {label}", flush=True)
        for name in order:
            lib, batched = libs[name]
            for config in (configs if batched else [None]):
                dst = out if batched else per_table
                fn = lambda: _call(lib, batched, tabs, idx, dst,  # noqa: E731
                                   mode == "mean", config)
                dst.fill_(float("nan"))
                err = fn()
                torch.cuda.synchronize()
                if err == 1 and config:  # cudaErrorInvalidValue
                    print(f"  {name} {config}: not taken", flush=True)
                    continue
                if err:
                    raise RuntimeError(f"{name} {config}: CUDA error {err}")
                got = out if batched else per_table.transpose(0, 1)
                if idx.shape[2] == 1:
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} {config}: not "
                                             "bit-equal to plain")
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5)
                ms = time_ms(fn, flush)
                tag = (f"{config[0]}x{config[1]}" if config
                       else f"{len(tabs)} launches")
                print(f"  {name} {tag}: {ms:.4f} ms", flush=True)
                record.append(dict(case=label, version=name, config=tag,
                                   ms=ms))
        del want, out, per_table
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
