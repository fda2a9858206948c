#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

    python3 chip_smoke.py [--out results/torch/chip_smoke.json]
    python3 chip_smoke.py --sweep [--out ...]

``--sweep`` runs phases 1 and 2, then times K1/K2 on the AMZ stand-in
over a grid of chunk sizes (``CHUNK_E``) and threads per CTA, each
configuration checked against the plain version, and stops there: the
sweep that settles ``CHUNK_E``.  Without it:

Phases, in order, each printing its lines; any failure raises and the
script exits non-zero:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build: compile the three kernel libraries and the fused engine's
   IF-node library from this checkout's sources (one ``nvcc`` for
   sm_90a per source, all started together) and print each build's
   seconds and ``ptxas`` register lines.
3. kernels: call each kernel at its path's shapes and hold it against
   its plain PyTorch version on the same inputs; time the kernel, the
   plain version and one PyTorch library call computing the same
   function (CUDA events, median of 15 launches, L2 flushed before
   each by a write long enough to hide the host's issue time).
   - K1/K2 on the AMZ stand-in (Table II scale, fixed seed), the owned
     and the CSC edge order, D in {1, 8}, each through its reducer's
     chunk plan (whose figures are printed first): min/max and the int32
     sum bit-equal, the float32 sum to rtol=1e-5, atol=1e-6
     (shared-memory atomics add in a run-dependent order);
     ``scatter_reduce``, with its time over the kernel's
     (``library_over_ms``) and the bound's share of the kernel's time
     (``bound_share``).
   - K3 on a 16,000,000-row table, D=128: P=1 sum at B=512 and
     B=262,144 (bit-equal: a bag of one row is a copy), P=8 mean at
     B=65,536 (rtol=atol=1e-5); ``F.embedding_bag``.
   - K4 at starcoder2-7b widths (Hq=36, Hkv=4, D=128, B=1): bf16 causal
     Sq=Sk=4,096 and causal suffix Sq=512, Sk=4,096 (atol=1e-2 plus
     rtol=2**-7, one bf16 step of the output) on the tensor-core kernel,
     f32 full Sq=Sk=1,024 (atol=2e-3) on the CUDA-core kernel, each row
     naming its kernel with its registers and shared memory;
     ``F.scaled_dot_product_attention`` with ``enable_gqa=True``, its
     causal mask aligned to the end as K4's is (``causal_lower_right``),
     held to the same tolerance.
   Every row carries ``bound_share`` (the bound over the kernel's time)
   and ``library_over_ms`` (the library call's time over the kernel's).
4. graph path: with the K1/K2 counts set to 0, run every app of the
   registry through ``repro_torch.core.run`` with ``use_kernels=True``:
   BFS, SSSP, PR, CC, BC, MIS and CLR under SD1 (owned kernel) and DD1
   (both kernels, the sparse gather and the device-side direction
   choice), BFS, SSSP and PR under TG0 (pull kernel); MIS and CLR draw
   their priorities from a seeded ``torch.Generator``.  Each cell runs
   under the host engine and under the fused engine (a replayed CUDA
   graph with conditional IF nodes; its first run captures it), each
   once untimed and then 3 timed runs (the median is kept), with
   ``max_memory_allocated`` per engine; require each engine's runs to
   launch the cell's kernel, fused equal to host (bit for bit; PR to
   atol 1e-6 and BC to rtol 1e-5, atol 1e-6, iterations to +-1: K1's
   float atomics add in a run-dependent order), and one more fused run
   under ``torch.profiler`` to have executed K1/K2 inside the replays
   (its device ops name the kernel; the wrappers count host calls,
   that is captures, not replays).  Then check both engines' states
   against the numpy oracles (BFS and CC exact, SSSP rtol=1e-5, PR
   atol=1e-6, BC rtol=1e-4 plus 1e-5 of the largest score, MIS
   independent and maximal, CLR proper).  BFS, SSSP and PR also run
   with ``use_kernels=False`` (plain scatter reductions) for
   comparison.
4b. dispatch: ``repro_torch.benchmarks.dispatch`` at its pinned
   workload (R-MAT scale 10, BFS, 18 configs x both engines, best of
   10; writes ``results/torch/BENCH_dispatch.json``), then the sweep of
   guarded steps per graph, K in (1, 4, 8, 16, 32): the fused engine's
   µs per iteration on five configs of that workload and its seconds
   for PR TG0 and BFS DD1 on the AMZ stand-in.  Profiled runs (device
   busy time against the span) of SG0, SG1 and DD1 under both engines,
   and of SG0 fused at each K.
4c. autotune: with the K1/K2 counts set to 0, time every candidate
   plan of the owned and the pull order on the AMZ stand-in
   (``kernels/autotune.py:tune``: CUDA events, best of 5, one sum and
   one min per call, D = 1), each held against the plain versions on
   its own plan; ``autotune_plan(mode="measure")`` with the disk cache
   off; then BFS SD1 and PR TG0 with the kernels under ``autotune`` off,
   heuristic and measure (1 untimed + 3 timed runs each): BFS bit-equal
   across the modes, PR within atol 1e-6 (iterations +-1), and exactly
   one captured graph per distinct set of plans.
4d. batch: with the K1/K2 counts set to 0, ``run_batch`` on 64 R-MAT
   graphs of scale 14 (``rmat_batch(64, 14, 8, seed=7)``, weighted; one
   bucket, 2,097,152 packed vertices and 16,777,216 edge slots; packed
   once on the host, outside every timer) in every graph cell of phase
   4 with the kernels (1 untimed + 3 timed batches), against the
   sequential fused runs of every 8th graph: bit for bit, PR and BC to
   phase 4's tolerances (PR's iterations +-1); launches, polls, peak
   ``max_memory_allocated`` and ``memory_reserved``; BFS SD1 and PR SD1
   once more under the profiler, which must show K2 and K1 among their
   device ops (taken again, up to 5 times, while the tracer misses it).  One
   ``run_batch_slice`` roster (CLR SD1, 8 slots joining at different
   iterations, one parked, slices of 4) against the sequential runs.
   Then ``repro_torch.benchmarks.batch`` at its pinned workload (R-MAT
   scale 6, BFS, B in 1, 4, 16, 64, 18 configs, best of 5; writes
   ``results/torch/BENCH_batch.json``).
4e. resilience: with the K1/K2 counts set to 0, on the AMZ stand-in with
   the kernels: every graph cell of phase 4 under the plain fused engine
   and with ``checkpoint_every=32`` and the full sentinel battery (1
   untimed + 3 timed runs each): the checkpointed run must equal the
   plain one (exact apps bit for bit, state, iterations and traces; PR
   and BC to phase 4's tolerances) with ``outcome == "converged"``, no
   fault, ``engine == "fused"`` and one attempt; per cell its seconds
   against plain, segments, replays, host reads, and per boundary the
   host ms, the bytes read and the device ms of the sentinels, the
   certificate and the snapshot copies.  PR TG0 and CLR SD1 also at
   ``checkpoint_every=8``.  Seeded faults under ``RetryPolicy(6)``: nan
   on PR TG0 late in the run, stale on SSSP SD1 at the converged
   boundary (the certificate must catch it), bitflip on CC DD1,
   exception and overflow on BFS DD1, compile on BFS SD1 (must end on
   the host engine): each ends equal to the clean answer or
   ``faulted``, never wrong.  Kill -> resume on CLR SD1 through
   ``checkpoint_dir`` under ``build/`` with ``ProcessKillFault(
   point="after_segment")``: bit-identical, with the lost work and the
   resume seconds.  One profiled checkpointed run of PR SD1 and of BFS
   DD1 must show K1 and K2.  ``memory_reserved`` before and after.
   Then ``repro_torch.benchmarks.resilience`` (pinned R-MAT scale 10,
   PR, 18 configs, best of 10; writes
   ``results/torch/BENCH_resilience.json``).
5. DLRM serving: MLPerf DLRM (Criteo 1TB) at full width with every
   table capped at 16,000,000 rows (43.0 GB of float32 tables; the
   full 96.1 GB do not fit one 80 GB card), random weights from a
   seeded generator.  With the K3 count set to 0, serve each cell one
   untimed warm-up request (the first request of a shape pays the
   allocator's first ``cudaMalloc`` of its activations), then 8 timed
   serve_p99 requests (batch 512), 4 serve_bulk (262,144) and 4
   retrieval_cand (one query, 1,000,448 candidates); require one K3
   launch per serve_p99/serve_bulk forward (all 26 tables pooled into
   the interaction's input), none per retrieval_cand, and finite
   outputs of the expected shapes, logits bit-equal to the plain
   embedding bag's for one 512 batch, and the first 16 logits and 4,096
   scores within 1e-4 of a float64 numpy reference.  Each timed request
   is timed with CUDA events around it (device time, host gaps
   included) and with the host clock until the call returns (its issue
   time); the median and the slowest are printed.  Then, uncounted:
   - the table-batched K3 on the model's own 26 tables at B=512 and
     B=262,144, bit-equal to ``embedding_bags_ref``; timed against the
     plain version, 26 ``F.embedding_bag`` calls (the library time) and
     the per-table path (26 single-table launches and ``torch.stack``),
     each with its host issue time; its bound counts each table's
     distinct rows once; its launch variants (items per warp x threads
     per CTA), each bit-equal first, timed in the same run;
   - one more request per cell under ``torch.profiler``: the top 8
     device ops by time, the device's busy time and its idle share.
6. attention: with the K4 count set to 0, call ``attention`` at
   starcoder2-7b widths (bf16 causal, Sq=Sk=4,096); require a K4
   launch and agreement with the plain version (K4's bf16 tolerance).
7. print the kernel table as one JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

The full record also goes to ``--out``.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor
#: FLOP/s, bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: AMZ row of Table II: powerlaw arguments of the synthetic stand-in
#: (``graph/datasets.py``'s AMZ branch) at scale 1, with a fixed seed in
#: place of ``hash(name)`` so that every run sees the same graph
AMZ = dict(n=410236, n_edges=6713648 // 2, alpha=1.2, max_degree=2770,
           locality=0.21, degree_order="sorted", seed=20200224,
           weighted=True, block_size=256)
SOURCES = {
    "seg_sum": "src/repro_torch/kernels/segment_reduce/csrc/segment_reduce.cu",
    "seg_minmax":
        "src/repro_torch/kernels/segment_reduce/csrc/segment_reduce.cu",
    "embag": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"}
REPLACES = {"seg_sum": "src/repro/kernels/segment_reduce/kernel.py:102",
            "seg_minmax": "src/repro/kernels/segment_reduce/kernel.py:154",
            "embag": "src/repro/kernels/embedding_bag/kernel.py:55",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:68"}
CASES = [("seg_sum", torch.float32, "sum"),
         ("seg_sum", torch.int32, "sum"),
         ("seg_minmax", torch.float32, "min"),
         ("seg_minmax", torch.float32, "max"),
         ("seg_minmax", torch.int32, "min"),
         ("seg_minmax", torch.int32, "max")]
REPS = 15
#: graph cells: timed runs after one untimed run, the median is kept
TIMED_RUNS = 3
#: graph cells of the main path: (config, apps), all with the kernels
GRAPH_CELLS = [("SD1", ("BFS", "SSSP", "PR", "CC", "BC", "MIS", "CLR")),
               ("TG0", ("BFS", "SSSP", "PR")),
               ("DD1", ("BFS", "SSSP", "PR", "CC", "BC", "MIS", "CLR"))]
#: fused against host for the float apps (K1's float atomics)
FLOAT_APPS = {"PR": dict(rtol=0.0, atol=1e-6),
              "BC": dict(rtol=1e-5, atol=1e-6)}
#: MIS and CLR draw their priorities from a generator of this seed
PRIORITY_SEED = {"MIS": 16, "CLR": 17}
#: the dispatch benchmark's best-of repeats, and the guarded steps per
#: graph (K) of the sweep
DISPATCH_REPEATS = 10
SWEEP_STEPS = (1, 4, 8, 16, 32)
#: the sweep's grid: edges per chunk, threads per CTA
SWEEP_CHUNK_E = (2048, 4096, 8192, 16384)
SWEEP_THREADS = (256, 512)
#: The one reduction of the DLRM configuration: rows per table
DLRM_MAX_ROWS = 16_000_000
#: starcoder2-7b attention widths (``configs/starcoder2_7b.py:9-10``)
SC2_HQ, SC2_HKV, SC2_D = 36, 4, 128
#: K3 cases: (bags, indices per bag, mode)
EMBAG_CASES = [(512, 1, "sum"), (262_144, 1, "sum"), (65_536, 8, "mean")]
#: K4 cases: (Sq, Sk, causal, dtype)
ATTN_CASES = [(4096, 4096, True, torch.bfloat16),
              (512, 4096, True, torch.bfloat16),
              (1024, 1024, False, torch.float32)]
#: K4 against its plain version: f32 to the reference's kernel-test
#: tolerance; bf16 to one bf16 step of the output (rtol 2**-7) plus 1e-2,
#: well under the output's scale (about 0.026 at 4,096 keys)
ATTN_TOL = {torch.float32: dict(rtol=0.0, atol=2e-3),
            torch.bfloat16: dict(rtol=2**-7, atol=1e-2)}
#: DLRM serving: timed requests per cell, after one untimed warm-up each
DLRM_REQUESTS = {"serve_p99": 8, "serve_bulk": 4, "retrieval_cand": 4}
#: the table-batched K3's launch variants: (items per warp, threads per
#: CTA)
EMBAG_VARIANTS = [(g, t) for g in (1, 2, 4) for t in (128, 256)]
#: device ops printed per profiled request
PROFILE_TOP = 8
#: the autotune phase's cells (app, config), each under every mode, and
#: the sweep's best-of repeats
TUNE_CELLS = [("BFS", "SD1"), ("PR", "TG0")]
TUNE_MODES = ("off", "heuristic", "measure")
TUNE_REPEATS = 5
#: the serving-width batch: 64 R-MAT graphs of scale 14 (one bucket,
#: n_q = 32,768, m_q = 262,144), its cells, and every how many graphs
#: one is also run sequentially
BATCH_GRAPHS = dict(count=64, scale=14, edge_factor=8, seed=7)
BATCH_CELLS = GRAPH_CELLS
BATCH_SEQ_EVERY = 8
#: the batch cells run once more under the profiler, one per kernel, and
#: how many profiles of one are taken until one shows its kernel
BATCH_PROFILED = {("BFS", "SD1"): "seg_minmax", ("PR", "SD1"): "seg_sum"}
PROFILE_ATTEMPTS = 5
#: the run_batch_slice roster: app, config, slots, the iteration each
#: slot joins at, the parked slot and the slice length
SLICE_CELL = ("CLR", "SD1")
SLICE_JOINS = (0, 1, 2, 3, 5, 8, 0, 4)
SLICE_PARKED = 6
SLICE_LEN = 4
#: phase 4e: the segment length of every checkpointed cell, the cells
#: run again at a shorter one, the seeded faults (app, config, mode) under
#: RESILIENCE_RETRY attempts, the kill -> resume cell, and the cells run
#: once more under the profiler, one per kernel
RESILIENCE_K = 32
RESILIENCE_SHORT = [("PR", "TG0"), ("CLR", "SD1")]
RESILIENCE_SHORT_K = 8
RESILIENCE_RETRY = 6
FAULT_CASES = [("PR", "TG0", "nan"), ("SSSP", "SD1", "stale"),
               ("CC", "DD1", "bitflip"), ("BFS", "DD1", "exception"),
               ("BFS", "DD1", "overflow"), ("BFS", "SD1", "compile")]
KILL_CELL = ("CLR", "SD1")
RESILIENCE_PROFILED = {("PR", "SD1"): "seg_sum", ("BFS", "DD1"): "seg_minmax"}


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over REPS calls, L2 flushed before
    each (CUDA events around each call).  The flush (256 MB, about 80 us
    of device time) is still running while the host issues ``fn``, so
    the host's issue time is not counted unless it takes longer."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_phase() -> dict:
    """Build the three kernel libraries and the fused engine's IF-node
    library, one ``nvcc`` per source, all started together; returns each
    source's build seconds."""
    from repro_torch.core.capture import SOURCE as GRAPH_IF
    from repro_torch.kernels._build import build
    from repro_torch.kernels.embedding_bag import SOURCE as EMBAG
    from repro_torch.kernels.flash_attention import SOURCE as FLASH
    from repro_torch.kernels.segment_reduce import SOURCE as SEGMENT

    def timed(source):
        t0 = time.perf_counter()
        lib, report = build(source)
        return lib, report, time.perf_counter() - t0

    sources = (SEGMENT, EMBAG, FLASH, GRAPH_IF)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed, sources))
    seconds = {}
    for source, (lib, report, sec) in zip(sources, built):
        seconds[source.name] = sec
        log(f"build: {lib.name} in {sec:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    return seconds


def _row(name, kernel, got_err, ms, plain_ms, library_ms, moved, ops,
         ops_per_s, **extra) -> dict:
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    row = dict(name=name, kernel=kernel, route="cuda", source=SOURCES[kernel],
               replaces=REPLACES[kernel], launches=0, max_abs_err=got_err,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=library_ms, library_over_ms=(
                   None if library_ms is None else library_ms / ms),
               bound_share=bound_ms / ms, bytes=moved, ops=ops, **extra)
    log(f"kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms} bound_ms={bound_ms:.4f} "
        f"({row['bound_by']}) library_over_ms={row['library_over_ms']} "
        f"bound_share={row['bound_share']:.3f} max_abs_err={got_err}")
    return row


def embag_rows(dev, flush) -> list:
    """K3 at the DLRM serving shapes on one 16,000,000-row table."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import embag, embedding_bag_ref
    d = 128
    gen = torch.Generator(device=dev).manual_seed(12)
    table = torch.randn((DLRM_MAX_ROWS, d), generator=gen, device=dev)
    rng = np.random.default_rng(12)
    rows = []
    for bags, pool, mode in EMBAG_CASES:
        idx = torch.from_numpy(rng.integers(0, DLRM_MAX_ROWS, (bags, pool))
                               .astype(np.int32)).to(dev)
        idx_long = idx.long()  # the library takes int64 offsets-free bags
        kernel = lambda: embag(table, idx, mode=mode)
        plain = lambda: embedding_bag_ref(table, idx, mode=mode)
        library = lambda: F.embedding_bag(idx_long, table, mode=mode)
        got, want, lib_out = kernel(), plain(), library()
        torch.cuda.synchronize()
        if pool == 1:
            if not torch.equal(got, want):
                raise AssertionError(f"embag B={bags}: not bit-equal to "
                                     "plain")
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lib_out, want, rtol=1e-5, atol=1e-5)
        moved = bags * pool * d * 4 + bags * pool * 4 + bags * d * 4
        rows.append(_row(
            f"embag[f32,{mode},B={bags},P={pool},R={DLRM_MAX_ROWS},D={d}]",
            "embag", float((got - want).abs().max()), time_ms(kernel, flush),
            time_ms(plain, flush), time_ms(library, flush), moved,
            bags * pool * d, F32_OPS_PER_S, bags=bags, pool=pool,
            table_rows=DLRM_MAX_ROWS, d=d))
    return rows


def _visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs K4 must score: all of them, or under the causal
    mask aligned to the end, those with key <= row + Sk - Sq (a row that
    sees no key averages all Sk, as the TPU kernel's -1e30 rule does)."""
    if not causal:
        return sq * sk
    rows = np.arange(sq) + (sk - sq) + 1
    return int(np.where(rows > 0, np.minimum(rows, sk), sk).sum())


def _qkv(gen, dev, sq, sk, dtype):
    shapes = ((1, SC2_HQ, sq, SC2_D), (1, SC2_HKV, sk, SC2_D),
              (1, SC2_HKV, sk, SC2_D))
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in shapes]


def attention_rows(dev, flush) -> list:
    """K4 at starcoder2-7b widths."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     kernel_info)
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for sq, sk, causal, dtype in ATTN_CASES:
        info = kernel_info(dtype, SC2_D)
        log(f"flash_attention {str(dtype)[6:]} D={SC2_D}: {info['kernel']}, "
            f"{info['registers']} registers, {info['shared_bytes']} bytes "
            "of shared memory")
        q, k, v = _qkv(gen, dev, sq, sk, dtype)
        kernel = lambda: flash_attention(q, k, v, causal=causal)
        plain = lambda: flash_attention_plain(q, k, v, causal=causal)
        # Sq <= Sk here, so every row sees a key and the -1e30 rule is
        # moot: SDPA with the end-aligned mask computes the same function
        mask = causal_lower_right(sq, sk) if causal else None
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
        got, want, lib_out = kernel(), plain(), library()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention Sq={sq} Sk={sk}: "
                                 "non-finite output")
        torch.testing.assert_close(got.float(), want.float(),
                                   **ATTN_TOL[dtype])
        torch.testing.assert_close(lib_out.float(), want.float(),
                                   **ATTN_TOL[dtype])
        err = float((got.float() - want.float()).abs().max())
        library_err = float((lib_out.float() - want.float()).abs().max())
        library_ms = time_ms(library, flush)
        elt = q.element_size()
        moved = (2 * q.numel() + k.numel() + v.numel()) * elt
        ops = 4 * SC2_HQ * _visible_pairs(sq, sk, causal) * SC2_D
        rows.append(_row(
            f"flash_attention[{str(dtype)[6:]},"
            f"{'causal' if causal else 'full'},B=1,Hq={SC2_HQ},"
            f"Hkv={SC2_HKV},Sq={sq},Sk={sk},D={SC2_D}]",
            "flash_attention", err, time_ms(kernel, flush),
            time_ms(plain, flush), library_ms, moved, ops,
            BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S,
            library_max_abs_err=library_err, sq=sq, sk=sk, causal=causal,
            k4_kernel=info["kernel"], registers=info["registers"],
            shared_bytes=info["shared_bytes"]))
        del q, k, v, got, want, lib_out
    return rows


def _dlrm_float64(model, batch, n: int) -> np.ndarray:
    """Logits of the first ``n`` samples in float64 numpy: an independent
    reference for the serving path (rows gathered by plain indexing)."""
    def mlp(stack, x, final_act):
        for i, lp in enumerate(stack.layers):
            x = x @ lp.w.double().cpu().numpy() + lp.b.double().cpu().numpy()
            if i < len(stack.layers) - 1 or final_act:
                x = np.maximum(x, 0.0)
        return x
    dense = batch["dense"][:n].double().cpu().numpy()
    sparse = batch["sparse"][:n, :, 0].long()
    bottom = mlp(model.bot, dense, True)
    embs = np.stack([model.tables[f][sparse[:, f]].double().cpu().numpy()
                     for f in range(sparse.shape[1])], axis=1)
    z = np.concatenate([bottom[:, None, :], embs], axis=1)
    gram = np.einsum("bfd,bgd->bfg", z, z)
    iu, ju = np.triu_indices(z.shape[1], k=1)
    x = np.concatenate([bottom, gram[:, iu, ju]], axis=1)
    return mlp(model.top, x, False)[:, 0]


def dlrm_phase(dev) -> tuple:
    """Serve the capped MLPerf DLRM; returns (record, K3 launches)."""
    from repro_torch.configs.dlrm_mlperf import (CFG, RETRIEVAL_CANDIDATES,
                                                 SERVE_CELLS, capped,
                                                 retrieval_step, serve_step,
                                                 serving_batch)
    from repro_torch.kernels.embedding_bag import embag
    from repro_torch.models.dlrm import init_dlrm
    cfg = capped(CFG, DLRM_MAX_ROWS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_dlrm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    table_bytes = sum(t.numel() * t.element_size() for t in model.tables)
    n_rows = sum(t.shape[0] for t in model.tables)
    log(f"dlrm: {cfg.name} tables {len(model.tables)} x {cfg.embed_dim}, "
        f"{n_rows} rows, {table_bytes} bytes, init "
        f"{time.perf_counter() - t0:.2f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)}")
    # (cell, step, timed): one untimed warm-up request per cell first
    requests, step = [], 0
    for cell, n in DLRM_REQUESTS.items():
        requests += [(cell, step + i, i > 0) for i in range(n + 1)]
        step += n + 1
    batches = {(cell, step): serving_batch(cfg, cell, step, device=dev)
               for cell, step, _ in requests}
    first = {cell: (cell, step + 1) for cell, step, timed in requests
             if not timed}
    outs, times, issue = {}, {}, {}
    embag.launches = 0
    for cell, step, timed in requests:
        batch = batches[cell, step]
        before = embag.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        if cell == "retrieval_cand":
            out = retrieval_step(cfg, model, batch, device=dev)
        else:
            out = serve_step(cfg, model, batch, device=dev)
        issue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        launched = embag.launches - before
        want_launches = 0 if cell == "retrieval_cand" else 1
        if launched != want_launches:
            raise AssertionError(f"{cell} request {step}: {launched} K3 "
                                 f"launches, expected {want_launches}")
        n_out = (RETRIEVAL_CANDIDATES if cell == "retrieval_cand"
                 else SERVE_CELLS[cell])
        if tuple(out.shape) != (n_out,) or not torch.isfinite(out).all():
            raise AssertionError(f"{cell} request {step}: bad output "
                                 f"{tuple(out.shape)}")
        outs[cell, step] = out
        if timed:
            times.setdefault(cell, []).append(start.elapsed_time(end))
            issue.setdefault(cell, []).append(issue_ms)
    launches = embag.launches
    log(f"dlrm launches: {json.dumps({'embag': launches})}")

    # comparisons, not counted: the plain embedding bag on the card, and
    # float64 numpy on the first samples
    p99 = first["serve_p99"]
    plain = serve_step(cfg, model, batches[p99], impl="plain", device=dev)
    if not torch.equal(plain, outs[p99]):
        raise AssertionError("serve_p99: kernel logits are not bit-equal "
                             "to the plain embedding bag's")
    ref = _dlrm_float64(model, batches[p99], 16)
    np.testing.assert_allclose(outs[p99][:16].cpu().numpy(), ref,
                               rtol=1e-4, atol=1e-4)
    retrieval = first["retrieval_cand"]
    cand = batches[retrieval]
    bottom = model.bot.layers
    x = cand["dense"].double().cpu().numpy()
    for i, lp in enumerate(bottom):
        x = np.maximum(x @ lp.w.double().cpu().numpy()
                       + lp.b.double().cpu().numpy(), 0.0)
    scores = cand["cand"][:4096].double().cpu().numpy() @ x[0]
    np.testing.assert_allclose(outs[retrieval][:4096].cpu().numpy(),
                               scores, rtol=1e-4, atol=1e-4)

    record = dict(config=cfg.name, max_rows=DLRM_MAX_ROWS, table_rows=n_rows,
                  table_bytes=table_bytes,
                  max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                  embag_launches=launches, cells={})
    for cell, ms in times.items():
        med = statistics.median(ms)
        per = SERVE_CELLS[cell] if cell != "retrieval_cand" else \
            RETRIEVAL_CANDIDATES
        host = statistics.median(issue[cell])
        record["cells"][cell] = dict(requests=len(ms), warmup_requests=1,
                                     ms=ms, median_ms=med, max_ms=max(ms),
                                     samples_per_s=per / med * 1e3,
                                     host_issue_ms=issue[cell],
                                     median_host_issue_ms=host)
        log(f"serve {cell}: requests={len(ms)} after 1 warm-up "
            f"median_ms={med:.4f} max_ms={max(ms):.4f} "
            f"median_host_issue_ms={host:.4f} "
            f"{'candidates' if cell == 'retrieval_cand' else 'samples'}"
            f"_per_s={per / med * 1e3:.1f}")
    log(f"dlrm: max_memory_allocated {record['max_memory_allocated']}")
    del outs, plain
    rows = embag_tables_rows(model, dev, {
        cell: batches[first[cell]]["sparse"]
        for cell in ("serve_p99", "serve_bulk")})
    record["profiles"] = {}
    for cell in DLRM_REQUESTS:
        batch = batches[first[cell]]
        if cell == "retrieval_cand":
            request = lambda: retrieval_step(cfg, model, batch, device=dev)
        else:
            request = lambda: serve_step(cfg, model, batch, device=dev)
        record["profiles"][cell] = profile_request(cell, request)
    del model, batches
    return record, launches, rows


def _host_ms(fn) -> float:
    """Median host time to issue ``fn`` (no synchronise inside), over
    REPS calls each after the card has drained."""
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def embag_tables_rows(model, dev, sparse: dict) -> list:
    """The table-batched K3 on the model's 26 tables at each serving
    cell's indices, against its plain version, the library and the
    per-table path, with its launch variants."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import (embag, embag_tables,
                                                   embedding_bags_ref)
    tables = model.tables
    d = tables[0].shape[1]
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rows = []
    for cell, idx in sparse.items():
        bags, n_tables, pool = idx.shape
        out = torch.empty((bags, n_tables, d), device=dev)
        want = embedding_bags_ref(tables, idx)
        kernel = lambda: embag_tables(tables, idx, out=out)
        plain = lambda: embedding_bags_ref(tables, idx, out=want)
        idx_long = [idx[:, f].long().contiguous() for f in range(n_tables)]
        library = lambda: [F.embedding_bag(i, t, mode="sum")
                           for i, t in zip(idx_long, tables)]
        per_table = lambda: torch.stack(
            [embag(t, idx[:, f]) for f, t in enumerate(tables)], dim=1)
        kernel()
        got_lib, got_per_table = library(), per_table()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"embag_tables {cell}: not bit-equal to "
                                 "embedding_bags_ref")
        if not torch.equal(got_per_table, want):
            raise AssertionError(f"embag_tables {cell}: not bit-equal to "
                                 "the per-table launches")
        torch.testing.assert_close(torch.stack(got_lib, dim=1), want,
                                   rtol=1e-5, atol=1e-5)
        del got_lib, got_per_table
        variants = []
        for items, threads in EMBAG_VARIANTS:
            fn = lambda: embag_tables(tables, idx, out=out,
                                      launch=(items, threads))
            out.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"embag_tables {cell} items={items} "
                                     f"threads={threads}: not bit-equal")
            variants.append(dict(items_per_warp=items, threads=threads,
                                 ms=time_ms(fn, flush)))
            log(f"variant embag_tables {cell} items_per_warp={items} "
                f"threads={threads}: ms={variants[-1]['ms']:.4f}")
        # each input read once: the distinct rows of each table, the
        # indices; the output written once
        distinct = [int(torch.unique(idx[:, f]).numel())
                    for f in range(n_tables)]
        at_most = [min(bags * pool, t.shape[0]) for t in tables]
        small = (bags * n_tables * pool * 4) + bags * n_tables * d * 4
        moved = sum(distinct) * d * 4 + small
        rows.append(_row(
            f"embag_tables[f32,sum,{cell},B={bags},P={pool},F={n_tables},"
            f"D={d}]", "embag", float((out - want).abs().max()),
            time_ms(kernel, flush), time_ms(plain, flush),
            time_ms(library, flush), moved, bags * n_tables * pool * d,
            F32_OPS_PER_S, host_issue_ms=_host_ms(kernel),
            per_table_ms=time_ms(per_table, flush),
            per_table_host_issue_ms=_host_ms(per_table),
            bags=bags, pool=pool, tables=n_tables, d=d,
            distinct_rows=sum(distinct),
            bytes_at_most=sum(at_most) * d * 4 + small,
            bound_ms_at_most=(sum(at_most) * d * 4 + small)
            / HBM_BYTES_PER_S * 1e3, variants=variants))
        log(f"  per_table_ms={rows[-1]['per_table_ms']:.4f} "
            f"per_table_host_issue_ms="
            f"{rows[-1]['per_table_host_issue_ms']:.4f} "
            f"host_issue_ms={rows[-1]['host_issue_ms']:.4f}")
        del out, want, idx_long
    return rows


def profile_request(cell: str, request, attempts: int = 3) -> dict:
    """One untimed request under ``torch.profiler``: the device ops with
    the most time (kernels, copies, fills), the device's busy time, and
    its idle share between the first op's start and the last op's end.
    A profile that recorded no device op at all (the tracer missed the
    request) is taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if ops:
            break
        log(f"profile {cell}: no device op recorded (attempt "
            f"{attempt + 1} of {attempts})")
    if not ops:
        return dict(wall_ms=wall_ms, ops=0)
    by_name = {}
    for e in ops:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    span = (max(e.time_range.end for e in ops)
            - min(e.time_range.start for e in ops)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    counts = {name: n for name, (_, n) in by_name.items()}
    log(f"profile {cell}: wall_ms={wall_ms:.4f} device_busy_ms={busy:.4f} "
        f"device_span_ms={span:.4f} idle_share={1 - busy / span:.3f} "
        f"device_ops={len(ops)}")
    for name, (ms, n) in top:
        log(f"  {ms:.4f} ms {n}x {name[:100]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_span_ms=span,
                idle_share=1 - busy / span, ops=len(ops),
                top=[dict(name=name, ms=ms, count=n)
                     for name, (ms, n) in top], counts=counts)


def attention_path(dev) -> tuple:
    """The public ``attention`` at starcoder2-7b widths; returns (record,
    K4 launches)."""
    from repro_torch.kernels.flash_attention import (attention,
                                                     flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v = _qkv(gen, dev, 4096, 4096, torch.bfloat16)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = attention(q, k, v, causal=True, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_attention.launches
    log(f"attention launches: {json.dumps({'flash_attention': launches})}")
    if launches < 1:
        raise AssertionError("attention launched no K4 kernel")
    want = flash_attention_plain(q, k, v, causal=True)
    err = float((out.float() - want.float()).abs().max())
    if out.shape != q.shape or not torch.isfinite(out).all():
        raise AssertionError(f"attention: bad output {tuple(out.shape)}")
    torch.testing.assert_close(out.float(), want.float(),
                               **ATTN_TOL[torch.bfloat16])
    log(f"attention: ok seconds={seconds:.4f} max_abs_err={err}")
    return dict(seconds=seconds, max_abs_err=err, launches=launches), launches


def free_device_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def plan_figures(red) -> dict:
    """The chunk plan of a reducer: chunks, blocks split, the largest
    chunk, and the largest block's share of the edges."""
    bp = red.block_ptr.cpu().numpy().astype(np.int64)
    counts = np.diff(bp)
    split = int((counts > red.chunks.chunk_e).sum())
    return dict(chunk_e=red.chunks.chunk_e, chunks=red.chunks.n_chunks,
                blocks=len(counts), blocks_split=split,
                largest_chunk=red.chunks.longest,
                largest_block=int(counts.max()),
                largest_block_share=float(counts.max() / max(1, bp[-1])))


def _segment_cases(red, dev, rng, chunks=None):
    """K1/K2 at the reducer's shapes, D in {1, 8}: yields (label, d, name,
    dtype, kind, kernel, plain, library, vals) for every case."""
    from repro_torch.kernels.segment_reduce import (identity, seg_minmax,
                                                    seg_minmax_plain,
                                                    seg_sum, seg_sum_plain)
    ids, bp = red.segment_ids, red.block_ptr
    e, v, bs = ids.shape[0], red.num_segments, red.block_size
    chunks = red.chunks if chunks is None else chunks
    ids_long = ids.long()
    for d in (1, 8):
        f32 = torch.from_numpy(
            rng.uniform(1.0, 16.0, (e, d)).astype(np.float32)).to(dev)
        i32 = torch.from_numpy(
            rng.integers(0, 64, (e, d)).astype(np.int32)).to(dev)
        index = ids_long[:, None].expand(e, d)
        for name, dtype, kind in CASES:
            vals = f32 if dtype == torch.float32 else i32
            kw = dict(block_size=bs, num_segments=v, tile_e=red.tile_e,
                      chunks=chunks)
            if name == "seg_sum":
                kernel = functools.partial(seg_sum, vals, ids, bp, **kw)
                plain = functools.partial(seg_sum_plain, vals, ids, bp, **kw)
            else:
                kw["is_min"] = kind == "min"
                kernel = functools.partial(seg_minmax, vals, ids, bp, **kw)
                plain = functools.partial(seg_minmax_plain, vals, ids, bp,
                                          **kw)
            base = torch.full((v, d), identity(kind, dtype), dtype=dtype,
                              device=dev)
            reduce = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
            library = functools.partial(base.scatter_reduce, 0, index, vals,
                                        reduce, include_self=True)
            yield d, name, dtype, kind, kernel, plain, library, vals


def _agree(got, want, name, dtype, kind, what) -> float:
    """Hold a K1/K2 result against the plain one; returns the largest
    difference (equal entries, the +-inf of empty rows too, count 0)."""
    err = float(torch.where(got == want, 0.0,
                            (got.double() - want.double()).abs()).max())
    if kind == "sum" and dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    elif not torch.equal(got, want):
        raise AssertionError(f"{name} {dtype} {kind} {what}: not bit-equal "
                             "to plain")
    return err


def kernel_phase(graph, dev, flush) -> list:
    from repro_torch.kernels.autotune import build_reducer
    rng = np.random.default_rng(7)
    rows = []
    for order, label in (("owned", "owned"), ("pull", "csc")):
        red = build_reducer(graph, order, device=dev)
        figures = plan_figures(red)
        log(f"plan {label}: {json.dumps(figures)}")
        e, v, bs = red.segment_ids.shape[0], red.num_segments, red.block_size
        for (d, name, dtype, kind, kernel, plain, library,
             vals) in _segment_cases(red, dev, rng):
            got, want, lib_out = kernel(), plain(), library()
            torch.cuda.synchronize()
            err = _agree(got, want, name, dtype, kind, f"{label} D={d}")
            exact = kind != "sum" or dtype == torch.int32
            if exact and not torch.equal(lib_out, want):
                raise AssertionError("scatter_reduce disagrees")
            elt = vals.element_size()
            moved = (vals.numel() * elt + e * 4 + (red.block_ptr.numel()
                                                   + red.chunks.table.numel())
                     * 4 + v * d * elt)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = vals.numel() / F32_OPS_PER_S * 1e3
            ms, library_ms = time_ms(kernel, flush), time_ms(library, flush)
            row = dict(
                name=f"{name}[{str(dtype)[6:]},{kind},{label},D={d}]",
                kernel=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=0, max_abs_err=err,
                ms=ms, plain_ms=time_ms(plain, flush),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, library_over_ms=library_ms / ms,
                bound_share=max(bytes_ms, ops_ms) / ms,
                edges=e, segments=v, block_size=bs, d=d, bytes=moved,
                threads=red.tile_e, **figures)
            rows.append(row)
            log(f"kernel {row['name']}: ms={ms:.4f} "
                f"plain_ms={row['plain_ms']:.4f} "
                f"library_ms={library_ms:.4f} "
                f"bound_ms={row['bound_ms']:.4f} "
                f"library_over_ms={row['library_over_ms']:.2f} "
                f"bound_share={row['bound_share']:.3f} max_abs_err={err}")
    return rows


def sweep_phase(graph, dev, flush) -> list:
    """K1/K2 over chunk sizes x threads per CTA on the AMZ stand-in, each
    configuration held against the plain version first."""
    from repro_torch.kernels.autotune import build_reducer
    from repro_torch.kernels.segment_reduce import ChunkPlan
    records = []
    for order, label in (("owned", "owned"), ("pull", "csc")):
        red = build_reducer(graph, order, device=dev)
        bp = red.block_ptr.cpu().numpy()
        for (d, name, dtype, kind, kernel, plain, library,
             _) in _segment_cases(red, dev, np.random.default_rng(7)):
            want = plain()
            library_ms = time_ms(library, flush)
            case = f"{name}[{str(dtype)[6:]},{kind},{label},D={d}]"
            for chunk_e in SWEEP_CHUNK_E:
                chunks = ChunkPlan.build(bp, chunk_e, dev)
                for threads in SWEEP_THREADS:
                    fn = functools.partial(kernel, chunks=chunks,
                                           tile_e=threads)
                    got = fn()
                    torch.cuda.synchronize()
                    _agree(got, want, name, dtype, kind,
                           f"{label} D={d} chunk_e={chunk_e} "
                           f"threads={threads}")
                    records.append(dict(case=case, chunk_e=chunk_e,
                                        threads=threads,
                                        ms=time_ms(fn, flush),
                                        library_ms=library_ms))
    by_config = {}
    for r in records:
        by_config.setdefault((r["chunk_e"], r["threads"]), []).append(r)
    for (chunk_e, threads), rs in sorted(by_config.items()):
        ms = np.array([r["ms"] for r in rs])
        over = np.array([r["ms"] / r["library_ms"] for r in rs])
        log(f"sweep chunk_e={chunk_e} threads={threads}: geomean_ms="
            f"{float(np.exp(np.log(ms).mean())):.4f} max_ms={ms.max():.4f} "
            f"worst_ms_over_library={over.max():.3f} "
            f"slower_than_library={int((over >= 1).sum())}/{len(rs)}")
    return records


def _engine_runs(program, graph, cfg, dev, engine, kernels,
                 seed=None, **kw) -> tuple:
    """One untimed run of a cell under ``engine``, then TIMED_RUNS timed
    ones (the fused engine captures in the first); a program with
    random priorities draws them from a fresh generator seeded ``seed``
    each run; ``kw`` goes to ``run``.  Returns the last result, the
    timed seconds, and ``max_memory_allocated`` and ``memory_reserved``
    over the runs."""
    from repro_torch.core import SystemConfig, run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    seconds = []
    for i in range(TIMED_RUNS + 1):
        key = None if seed is None else torch.Generator().manual_seed(seed)
        res = run(program, graph, SystemConfig.from_name(cfg), key=key,
                  use_kernels=kernels, engine=engine, device=dev, **kw)
        if i:
            seconds.append(res.seconds)
    return (res, seconds, torch.cuda.max_memory_allocated(dev),
            torch.cuda.memory_reserved(dev))


def _same_run(app, cfg, fused, host) -> None:
    """Fused against host: bit for bit for the exact apps; PR and BC to
    their tolerances (K1's float atomics add in a run-dependent order),
    iterations to +-1."""
    what = f"{app} {cfg}"
    if app in FLOAT_APPS:
        if abs(fused.iterations - host.iterations) > 1:
            raise AssertionError(f"{what}: fused {fused.iterations} "
                                 f"iterations, host {host.iterations}")
        key = "rank" if app == "PR" else "delta"
        torch.testing.assert_close(fused.state[key], host.state[key],
                                   **FLOAT_APPS[app], msg=what)
        return
    if (fused.iterations != host.iterations
            or fused.direction_trace != host.direction_trace
            or fused.occupancy_trace != host.occupancy_trace):
        raise AssertionError(f"{what}: fused and host runs differ in "
                             "iterations or traces")
    for key, want in host.state.items():
        if not torch.equal(fused.state[key], want):
            raise AssertionError(f"{what}: fused {key!r} differs from host")


def _oracle_check(app, graph, res, program, oracles) -> None:
    """The numpy oracles: BFS and CC exact, SSSP rtol 1e-5, PR atol
    1e-6, BC rtol 1e-4 plus 1e-5 of the largest score, MIS independent
    and maximal, CLR proper."""
    from repro_torch.algorithms import reference as ref
    got = res.extract(program).cpu().numpy()
    if got.shape != (graph.n_nodes,):
        raise AssertionError(f"{app}: result of shape {got.shape}")
    if app == "MIS":
        if not ref.is_maximal_independent_set(graph, got):
            raise AssertionError("MIS: not a maximal independent set")
        return
    if app == "CLR":
        if not ref.is_proper_coloring(graph, got):
            raise AssertionError("CLR: not a proper coloring")
        return
    if not np.isfinite(got).any():
        raise AssertionError(f"{app}: no finite value")
    want = oracles[app]
    if app in ("BFS", "CC"):
        np.testing.assert_array_equal(got, want)
    elif app == "SSSP":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    elif app == "PR":
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def _device_launches(prof_record: dict) -> dict:
    """K1 and K2 launches among a profiled run's device ops."""
    counts = {"seg_sum": 0, "seg_minmax": 0}
    for name, n in prof_record.get("counts", {}).items():
        if "seg_reduce_kernel" in name:
            counts["seg_minmax" if "MinMax" in name else "seg_sum"] += n
    return counts


def main_path(graph, dev) -> tuple:
    """Every app of the registry through ``run`` with the kernels, under
    both engines; the K1/K2 counts are set to 0 first and read last."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.algorithms import reference as ref
    from repro_torch.core import SystemConfig, run
    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    kernels = {"seg_sum": seg_sum, "seg_minmax": seg_minmax}
    seg_sum.launches = 0
    seg_minmax.launches = 0
    cells = []
    for cfg, apps in GRAPH_CELLS:
        for app in apps:
            kname = "seg_sum" if app in FLOAT_APPS else "seg_minmax"
            kernel = kernels[kname]
            program, seed = REGISTRY[app](), PRIORITY_SEED.get(app)
            before = kernel.launches
            host, host_s, host_peak, host_res = _engine_runs(
                program, graph, cfg, dev, "host", True, seed)
            mid = kernel.launches
            fused, fused_s, fused_peak, fused_res = _engine_runs(
                program, graph, cfg, dev, "fused", True, seed)
            if mid == before or kernel.launches == mid:
                raise AssertionError(f"{app} {cfg}: an engine launched no "
                                     f"{kname}")
            _same_run(app, cfg, fused, host)
            key = None if seed is None else \
                torch.Generator().manual_seed(seed)
            prof = profile_request(
                f"{app} {cfg} fused", lambda: run(
                    program, graph, SystemConfig.from_name(cfg), key=key,
                    use_kernels=True, device=dev))
            device = _device_launches(prof)
            if device[kname] <= 0:
                raise AssertionError(f"{app} {cfg}: the profiled fused run "
                                     f"executed no {kname} kernel")
            cells.append(dict(
                app=app, config=cfg, kernel=kname, program=program,
                fused=fused, host=host, fused_seconds=fused_s,
                host_seconds=host_s, wrapper_launches=kernel.launches - before,
                device_launches=device[kname], profile=prof, memory=dict(
                    host_max_allocated=host_peak, host_reserved=host_res,
                    fused_max_allocated=fused_peak,
                    fused_reserved=fused_res)))
    launches = {"seg_sum": seg_sum.launches,
                "seg_minmax": seg_minmax.launches}
    log(f"main path launches: {json.dumps(launches)}")
    device_launches = {k: sum(c["device_launches"] for c in cells
                              if c["kernel"] == k) for k in kernels}
    log(f"main path device launches (one profiled fused run per cell): "
        f"{json.dumps(device_launches)}")

    # BFS, SSSP and PR with the plain scatter reductions, for comparison
    plain_seconds = {}
    for c in cells:
        if c["app"] in ("BFS", "SSSP", "PR"):
            plain, seconds, _, _ = _engine_runs(
                REGISTRY[c["app"]](), graph, c["config"], dev, "fused", False)
            if plain.iterations != c["fused"].iterations \
                    and c["app"] != "PR":
                raise AssertionError(f"{c['app']} {c['config']}: iterations "
                                     "differ between kernel and plain "
                                     "reductions")
            plain_seconds[c["app"], c["config"]] = seconds

    t0 = time.perf_counter()
    oracles = {"BFS": ref.bfs_np(graph), "SSSP": ref.sssp_np(graph),
               "PR": ref.pagerank_np(graph), "CC": ref.cc_np(graph),
               "BC": ref.bc_np(graph)}
    log(f"oracles: {time.perf_counter() - t0:.1f} s")
    record = []
    for c in cells:
        app, cfg, fused, host = c["app"], c["config"], c["fused"], c["host"]
        for res in (fused, host):
            if not res.converged:
                raise AssertionError(f"{app} {cfg}: {res.engine} engine did "
                                     "not converge")
            _oracle_check(app, graph, res, c["program"], oracles)
        med = statistics.median(c["fused_seconds"])
        host_med = statistics.median(c["host_seconds"])
        plain = plain_seconds.get((app, cfg))
        entry = dict(
            app=app, config=cfg, iterations=fused.iterations,
            host_iterations=host.iterations, seconds=med,
            seconds_runs=c["fused_seconds"], host_seconds=host_med,
            host_seconds_runs=c["host_seconds"],
            fused_speedup=host_med / med,
            dispatches=fused.dispatches, host_syncs=fused.host_syncs,
            host_dispatches=host.dispatches,
            host_host_syncs=host.host_syncs,
            direction_trace=fused.direction_trace,
            sparse_iterations=fused.sparse_iterations,
            kernel=c["kernel"], kernel_launches=c["wrapper_launches"],
            device_launches=c["device_launches"], memory=c["memory"],
            profile=c["profile"],
            seconds_without_kernels=(None if plain is None
                                     else statistics.median(plain)),
            seconds_without_kernels_runs=plain)
        record.append(entry)
        log(f"run {app} {cfg}: ok iterations={fused.iterations} "
            f"fused_s={med:.4f} host_s={host_med:.4f} "
            f"speedup={entry['fused_speedup']:.2f} "
            f"fused_us_per_iteration={med * 1e6 / fused.iterations:.1f} "
            f"host_us_per_iteration={host_med * 1e6 / host.iterations:.1f} "
            f"(medians of {TIMED_RUNS} after 1 untimed) "
            f"dispatches={fused.dispatches} host_syncs={fused.host_syncs} "
            f"host_engine_syncs={host.host_syncs} "
            f"{c['kernel']}_launches={c['wrapper_launches']} "
            f"device_launches={c['device_launches']} "
            f"fused_max_allocated={c['memory']['fused_max_allocated']} "
            f"host_max_allocated={c['memory']['host_max_allocated']} "
            f"seconds_without_kernels={entry['seconds_without_kernels']} "
            f"sparse_iterations={fused.sparse_iterations} "
            f"direction_trace={fused.direction_trace}")
    return record, launches, device_launches


def dispatch_phase(graph, dev) -> dict:
    """The dispatch benchmark at its pinned workload, then the sweep of
    guarded steps per graph (K) on it and on the AMZ stand-in."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.benchmarks.dispatch import run_dispatch
    from repro_torch.core import SystemConfig, capture, run
    from repro_torch.graph import rmat_graph
    record = dict(benchmark=run_dispatch(repeats=DISPATCH_REPEATS,
                                         device=dev))
    for cfg, cell in record["benchmark"]["configs"].items():
        log(f"dispatch {cfg}: host_us_per_iteration="
            f"{cell['host']['us_per_iteration']:.1f} fused_us_per_iteration="
            f"{cell['fused']['us_per_iteration']:.1f} "
            f"speedup={cell['fused_speedup']:.2f} iterations="
            f"{cell['fused']['iterations']} dispatches="
            f"{cell['fused']['dispatches']}/{cell['host']['dispatches']} "
            f"host_syncs={cell['fused']['host_syncs']}/"
            f"{cell['host']['host_syncs']}")
    rmat = rmat_graph(scale=10, edge_factor=8, seed=7)

    def profiled(label, cfg, engine):
        """One run of a captured (or, for the host, warmed) cell under
        the profiler: device busy time against the span."""
        program = REGISTRY["BFS"]()
        config = SystemConfig.from_name(cfg)
        run(program, rmat, config, engine=engine, device=dev)
        return profile_request(label, lambda: run(
            program, rmat, config, engine=engine, device=dev))

    record["profiles"] = {f"{cfg} {engine}": profiled(
        f"dispatch {cfg} {engine}", cfg, engine)
        for cfg in ("SG0", "SG1", "DD1") for engine in ("host", "fused")}
    chosen, sweep = capture.STEPS_PER_LAUNCH, []
    try:
        for k in SWEEP_STEPS:
            capture.STEPS_PER_LAUNCH = k
            row = dict(steps=k)
            us = []
            for cfg in ("SG0", "SD1", "TG0", "DG0", "DD1"):
                res, seconds, _, _ = _engine_runs(REGISTRY["BFS"](), rmat,
                                                  cfg, dev, "fused", False)
                us.append(min(seconds) * 1e6 / res.iterations)
            row["dispatch_geomean_us_per_iteration"] = float(
                np.exp(np.log(us).mean()))
            prof = profiled(f"dispatch SG0 fused K={k}", "SG0", "fused")
            row["dispatch_SG0_device_busy_ms"] = prof.get("device_busy_ms")
            row["dispatch_SG0_device_ops"] = prof["ops"]
            for app, cfg in (("PR", "TG0"), ("BFS", "DD1")):
                res, seconds, peak, _ = _engine_runs(
                    REGISTRY[app](), graph, cfg, dev, "fused", True)
                row[f"amz_{app}_{cfg}_seconds"] = statistics.median(seconds)
                row[f"amz_{app}_{cfg}_dispatches"] = res.dispatches
                row[f"amz_{app}_{cfg}_max_allocated"] = peak
            sweep.append(row)
            log(f"steps sweep K={k}: {json.dumps(row)}")
    finally:
        capture.STEPS_PER_LAUNCH = chosen
    record["steps_sweep"] = sweep
    return record


def _seg_counts() -> dict:
    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    return {"seg_sum": seg_sum.launches, "seg_minmax": seg_minmax.launches}


def _zero_seg_counts() -> None:
    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    seg_sum.launches = seg_minmax.launches = 0


def autotune_phase(graph, dev) -> tuple:
    """The tuner on the AMZ stand-in: every candidate of the owned and
    the pull order timed (CUDA events, best of TUNE_REPEATS, one sum and
    one min per call, D = 1) and held against the plain versions on its
    own plan, ``autotune_plan(mode="measure")`` with the disk cache off,
    then BFS SD1 and PR TG0 with the kernels under every autotune mode:
    BFS bit-equal across modes, PR within atol 1e-6, and one captured
    graph per distinct set of plans.  The K1/K2 counts are set to 0
    first and read last."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.core import PLAN_CACHE, SystemConfig, run
    from repro_torch.core.executor import EdgeContext
    from repro_torch.kernels import autotune as at
    _zero_seg_counts()
    rng = np.random.default_rng(3)
    record = dict(orders={}, runs=[])
    for order in ("owned", "pull"):
        res = at.tune(graph, order=order, repeats=TUNE_REPEATS, device=dev)
        cands = []
        for plan, seconds in res.measurements:
            red = at.build_reducer(graph, order, plan, device=dev)
            for (d, name, dtype, kind, kernel, plain, _,
                 _) in _segment_cases(red, dev, rng):
                if d == 1 and dtype == torch.float32 and kind in ("sum",
                                                                  "min"):
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    _agree(got, want, name, dtype, kind,
                           f"{order} {plan.astuple()}")
            cands.append(dict(plan=list(plan.astuple()), ms=seconds * 1e3,
                              block_size=red.block_size,
                              chunks=red.chunks.n_chunks))
            log(f"autotune {order} candidate tile_e={plan.tile_e} "
                f"block_mult={plan.block_mult} block_div={plan.block_div}: "
                f"ms={seconds * 1e3:.4f} block_size={red.block_size} "
                f"chunks={red.chunks.n_chunks} (checked against plain)")
            del red
        chosen = at.autotune_plan(graph, order=order, mode="measure",
                                  cache_path=None, device=dev)
        record["orders"][order] = dict(
            candidates=cands, winner=list(res.plan.astuple()),
            default_ms=res.default_seconds * 1e3,
            winner_ms=res.plan_seconds * 1e3,
            best_ms=res.best_seconds * 1e3,
            margin=res.speedup_vs_default,
            autotune_plan=list(chosen.astuple()),
            heuristic=list(at.suggest_plan(at.degree_features(graph),
                                           order).astuple()))
        log(f"autotune {order}: winner {res.plan.astuple()} "
            f"{res.plan_seconds * 1e3:.4f} ms, default "
            f"{res.default_seconds * 1e3:.4f} ms, margin over the default "
            f"{res.speedup_vs_default:.3f}x; autotune_plan chose "
            f"{chosen.astuple()}")
    for app, cfg in TUNE_CELLS:
        program, config = REGISTRY[app](), SystemConfig.from_name(cfg)
        before = PLAN_CACHE.kind_stats("exec_fn")["entries"]
        runs, sigs = {}, set()
        for mode in TUNE_MODES:
            ctx = EdgeContext.create(graph, config, use_kernels=True,
                                     autotune=mode, device=dev)
            sigs.add(ctx.plan_signature)
            seconds = []
            for i in range(TIMED_RUNS + 1):
                res = run(program, graph, config, use_kernels=True,
                          autotune=mode, device=dev)
                if i:
                    seconds.append(res.seconds)
            runs[mode] = res
            entry = dict(app=app, config=cfg, mode=mode,
                         plans=[list(p) if p else None
                                for p in ctx.plan_signature],
                         seconds=statistics.median(seconds),
                         seconds_runs=seconds, iterations=res.iterations)
            record["runs"].append(entry)
            log(f"autotune run {app} {cfg} autotune={mode}: "
                f"fused_ms={entry['seconds'] * 1e3:.4f} (median of "
                f"{TIMED_RUNS}) iterations={res.iterations} "
                f"plans={entry['plans']}")
        captured = PLAN_CACHE.kind_stats("exec_fn")["entries"] - before
        log(f"autotune {app} {cfg}: {captured} captured graphs for "
            f"{len(sigs)} distinct plan sets")
        if captured != len(sigs):
            raise AssertionError(f"{app} {cfg}: {captured} captured graphs "
                                 f"for {len(sigs)} plan sets")
        base = runs["off"]
        for mode, res in runs.items():
            if app == "PR":
                if abs(res.iterations - base.iterations) > 1:
                    raise AssertionError(f"PR autotune={mode}: iterations")
                torch.testing.assert_close(res.state["rank"],
                                           base.state["rank"], rtol=0,
                                           atol=1e-6)
            elif (res.iterations != base.iterations
                  or res.direction_trace != base.direction_trace
                  or not all(torch.equal(res.state[k], v)
                             for k, v in base.state.items())):
                raise AssertionError(f"{app} autotune={mode} differs from "
                                     "autotune=off")
    launches = _seg_counts()
    log(f"autotune path launches: {json.dumps(launches)}")
    if min(launches.values()) <= 0:
        raise AssertionError("autotune path: a K1/K2 wrapper never launched")
    return record, launches


def _batch_same(app, cfg, got, want) -> None:
    """A batched result against the sequential fused run of its graph:
    bit for bit, PR and BC to FLOAT_APPS (K1's float atomics), PR's
    iterations to +-1."""
    what = f"batch {app} {cfg}"
    if app == "PR":
        if abs(got.iterations - want.iterations) > 1:
            raise AssertionError(f"{what}: {got.iterations} iterations, "
                                 f"sequential {want.iterations}")
        n = min(got.iterations, want.iterations)
        if got.direction_trace[:n] != want.direction_trace[:n]:
            raise AssertionError(f"{what}: traces differ")
    elif (got.iterations != want.iterations
          or got.direction_trace != want.direction_trace
          or got.occupancy_trace != want.occupancy_trace):
        raise AssertionError(f"{what}: iterations or traces differ "
                             f"({got.iterations} vs {want.iterations})")
    for key, v in want.state.items():
        if app in FLOAT_APPS and v.dtype == torch.float32:
            torch.testing.assert_close(got.state[key], v, **FLOAT_APPS[app],
                                       msg=what)
        elif not torch.equal(got.state[key], v):
            raise AssertionError(f"{what}: {key!r} differs")


def _slice_roster(graphs, dev) -> dict:
    """One ``run_batch_slice`` roster: slot i joins at iteration
    SLICE_JOINS[i] (its state advanced by a sequential run), slot
    SLICE_PARKED stays parked, slices of SLICE_LEN until every slot has
    stopped; each live slot against its sequential run."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.core import (BatchedEdgeContext, SystemConfig,
                                  get_graph_batch, run, run_batch_slice)
    app, cfg = SLICE_CELL
    program, config = REGISTRY[app](), SystemConfig.from_name(cfg)
    batch = get_graph_batch(graphs)
    bctx = BatchedEdgeContext.create(batch, config, use_kernels=True,
                                     device=dev)
    states, prefix = [], []
    for g, j in zip(graphs, SLICE_JOINS):
        if j:
            r = run(program, g, config, max_iters=j, use_kernels=True,
                    device=dev)
            states.append(r.state)
            prefix.append(r.direction_trace)
        else:
            states.append({k: torch.as_tensor(v).to(dev)
                           for k, v in program.init(g).items()})
            prefix.append("")
    state = batch.pack_state(states, pad=program.state_pad)
    b = len(graphs)
    it_b = np.asarray(SLICE_JOINS, np.int32)
    parked = np.arange(b) == SLICE_PARKED
    conv = np.zeros(b, bool)
    limit_b = np.full(b, program.max_iters, np.int32)
    slices, launches, seconds = 0, 0, 0.0
    while not (parked | conv | (it_b >= limit_b)).all():
        out = run_batch_slice(program, batch, bctx, state, it_b,
                              parked | conv, limit_b, SLICE_LEN)
        slices, launches = slices + 1, launches + out.dispatches
        seconds += out.seconds
        for i in range(b):
            prefix[i] += "".join("T" if d else "S" for d in
                                 out.dir_cols[i, :out.advanced[i]])
        state, it_b, conv = out.state, out.it_b, conv | out.converged_b
    per = batch.unpack_state(state)
    for i, g in enumerate(graphs):
        if i == SLICE_PARKED:
            if it_b[i] != SLICE_JOINS[i]:
                raise AssertionError("slice roster: the parked slot moved")
            continue
        want = run(program, g, config, use_kernels=True, device=dev)
        if (int(it_b[i]), bool(conv[i]), prefix[i]) != (
                want.iterations, True, want.direction_trace):
            raise AssertionError(f"slice roster slot {i}: {int(it_b[i])} "
                                 f"iterations, sequential {want.iterations}")
        for key, v in want.state.items():
            if not torch.equal(per[i][key], v):
                raise AssertionError(f"slice roster slot {i}: {key!r}")
    log(f"batch slices {app} {cfg}: ok slots={b} joins={list(SLICE_JOINS)} "
        f"parked={SLICE_PARKED} slice_len={SLICE_LEN} slices={slices} "
        f"launches={launches} seconds={seconds:.4f} "
        f"iterations={it_b.tolist()}")
    return dict(app=app, config=cfg, slices=slices, launches=launches,
                seconds=seconds, iterations=it_b.tolist())


def batch_phase(dev) -> tuple:
    """``run_batch`` at serving width (64 R-MAT graphs of scale 14 in one
    bucket, 16,777,216 packed edge slots) on every graph cell, with the
    kernels, against sequential fused runs of every BATCH_SEQ_EVERY-th
    graph; one profiled batch per cell kernel; one slice roster; then
    the pinned batch benchmark.  The K1/K2 counts are set to 0 first and
    read before the benchmark."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.benchmarks.batch import run_batch_bench
    from repro_torch.core import (SystemConfig, bucket_key, get_graph_batch,
                                  run, run_batch)
    from repro_torch.graph import rmat_batch
    _zero_seg_counts()
    t0 = time.perf_counter()
    graphs = rmat_batch(weighted=True, **BATCH_GRAPHS)
    gen_s = time.perf_counter() - t0
    keys = {bucket_key(g) for g in graphs}
    if len(keys) != 1:
        raise AssertionError(f"batch: {len(keys)} buckets, expected one")
    t0 = time.perf_counter()
    batch = get_graph_batch(graphs)
    pack_s = time.perf_counter() - t0
    log(f"batch: {len(graphs)} graphs bucket={keys.pop()} "
        f"edges per graph {min(g.n_edges for g in graphs)}.."
        f"{max(g.n_edges for g in graphs)}, packed V={batch.packed.n_nodes} "
        f"E={batch.packed.n_edges}; generated in {gen_s:.1f} s, packed on "
        f"the host in {pack_s:.1f} s (cached, outside every timer)")
    sample = graphs[::BATCH_SEQ_EVERY]
    cells, device_launches = [], {"seg_sum": 0, "seg_minmax": 0}
    for cfg, apps in BATCH_CELLS:
        for app in apps:
            program, config = REGISTRY[app](), SystemConfig.from_name(cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            seconds = []
            for i in range(TIMED_RUNS + 1):
                got = run_batch(program, graphs, config, use_kernels=True,
                                device=dev)
                if i:
                    seconds.append(sum(r.seconds for r in got))
            peak = torch.cuda.max_memory_allocated(dev)
            reserved = torch.cuda.memory_reserved(dev)
            kname = BATCH_PROFILED.get((app, cfg))
            prof, dl = None, None
            # the tracer records a varying part of a replay's kernels
            # (in one run none of K2's in one cell), so a profile
            # without the kernel is taken again
            for attempt in range(PROFILE_ATTEMPTS if kname else 0):
                prof = profile_request(
                    f"batch {app} {cfg}", lambda: run_batch(
                        program, graphs, config, use_kernels=True,
                        device=dev))
                dl = _device_launches(prof)
                if dl[kname] > 0:
                    break
            if kname and dl[kname] <= 0:
                raise AssertionError(f"batch {app} {cfg}: the profiled "
                                     f"replays executed no {kname}")
            if dl:
                for k, n in dl.items():
                    device_launches[k] += n
            seq = []
            for j, g in enumerate(sample):
                run(program, g, config, use_kernels=True, device=dev)
                want = run(program, g, config, use_kernels=True, device=dev)
                _batch_same(app, cfg, got[j * BATCH_SEQ_EVERY], want)
                seq.append(want.seconds)
            med = statistics.median(seconds)
            seq_ms = statistics.mean(seq) * 1e3
            entry = dict(
                app=app, config=cfg, batch_ms=med * 1e3,
                batch_ms_runs=[x * 1e3 for x in seconds],
                ms_per_graph=med * 1e3 / len(graphs),
                seq_ms_per_graph=seq_ms,
                speedup=seq_ms / (med * 1e3 / len(graphs)),
                iterations=max(r.iterations for r in got),
                launches=got[0].dispatches, polls=got[0].host_syncs,
                max_memory_allocated=peak, memory_reserved=reserved,
                device_launches=dl, profile=prof)
            cells.append(entry)
            log(f"batch {app} {cfg}: ok batch_ms={entry['batch_ms']:.4f} "
                f"ms_per_graph={entry['ms_per_graph']:.4f} "
                f"seq_ms_per_graph={seq_ms:.4f} "
                f"speedup={entry['speedup']:.2f} "
                f"iterations={entry['iterations']} "
                f"launches={entry['launches']} polls={entry['polls']} "
                f"max_memory_allocated={peak} memory_reserved={reserved} "
                f"device_launches={json.dumps(dl)} "
                f"(median of {TIMED_RUNS} after 1 untimed; "
                f"{len(sample)} graphs held against sequential runs)")
    roster = _slice_roster(tuple(sample), dev)
    launches = _seg_counts()
    log(f"batch path launches: {json.dumps(launches)}; device launches "
        f"(profiled batches): {json.dumps(device_launches)}")
    if min(launches.values()) <= 0:
        raise AssertionError("batch path: a K1/K2 wrapper never launched")
    del batch, graphs, sample
    from repro_torch.core import PLAN_CACHE
    PLAN_CACHE.clear()
    free_device_memory()
    t0 = time.perf_counter()
    bench = run_batch_bench(device=dev)
    log(f"batch benchmark: {time.perf_counter() - t0:.1f} s, "
        f"geomean speedup by B "
        f"{json.dumps(bench['summary']['geomean_speedup_by_batch_size'])}")
    # where a pinned-workload batch spends its time, against one graph
    from repro_torch.benchmarks.batch import PINNED_WORKLOAD
    pinned = rmat_batch(64, **PINNED_WORKLOAD)
    program, config = REGISTRY["BFS"](), SystemConfig.from_name("SG0")
    run_batch(program, pinned, config, device=dev)
    run(program, pinned[0], config, device=dev)
    profiles = {
        "batch B=64 SG0": profile_request(
            "pinned batch B=64 SG0",
            lambda: run_batch(program, pinned, config, device=dev)),
        "sequential SG0": profile_request(
            "pinned sequential SG0",
            lambda: run(program, pinned[0], config, device=dev))}
    return dict(cells=cells, slices=roster, benchmark=bench,
                pinned_profiles=profiles, pack_seconds=pack_s), \
        launches, device_launches


class _Clock:
    """Seconds per phase of the run, logged as each phase ends."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.seconds = {}

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.last
        self.last = now
        log(f"phase {phase}: {self.seconds[phase]:.1f} s "
            f"({now - self.t0:.1f} s so far)")


def _clean_checkpointed(app, cfg, res, plain) -> None:
    """A clean checkpointed run: converged on its first attempt on the
    fused engine with no fault, and equal to the plain fused run."""
    what = f"{app} {cfg} checkpointed"
    if (res.outcome, res.fault, res.engine, res.attempts) != \
            ("converged", None, "fused", 1):
        raise AssertionError(f"{what}: outcome={res.outcome} "
                             f"engine={res.engine} attempts={res.attempts} "
                             f"fault={res.fault}")
    _same_run(app, cfg, res, plain)


def _same_answer(app, cfg, got, want) -> None:
    """A recovered run's answer against the clean run's: the state without
    the per-iteration frontier scalars (a degraded or overflowing run
    records other directions and occupancies); PR to atol 1e-6."""
    from repro_torch.core import FRONTIER_DIR_KEY, FRONTIER_OCC_KEY
    if app in FLOAT_APPS:
        _same_run(app, cfg, got, want)
        return
    for key, v in want.state.items():
        if key not in (FRONTIER_DIR_KEY, FRONTIER_OCC_KEY) and \
                not torch.equal(got.state[key].to(v.device), v):
            raise AssertionError(f"{app} {cfg}: recovered {key!r} differs "
                                 "from the clean run")


def _boundary_figures(res) -> dict:
    """Per-boundary figures of a checkpointed run's accounting."""
    acct = res.resilience
    n = max(acct["segments"], 1)
    return dict(segments=acct["segments"], replays=res.dispatches,
                host_reads=res.host_syncs,
                boundary_ms=acct["boundary_seconds"] * 1e3 / n,
                bytes_per_boundary=acct["snapshot_bytes"] / n,
                sentinel_ms=acct["sentinel_ms"],
                certificate_ms=acct["certificate_ms"],
                snapshot_ms=acct["snapshot_ms"])


def resilience_phase(graph, dev) -> tuple:
    """Checkpointed runs on the AMZ stand-in with the kernels: every
    graph cell at RESILIENCE_K against the plain fused run (1 untimed + 3
    timed each), two cells at RESILIENCE_SHORT_K, the seeded faults,
    kill -> resume, one profiled checkpointed run per kernel, then the
    resilience benchmark.  The K1/K2 counts are set to 0 first and read
    before the benchmark."""
    import shutil
    from repro_torch.algorithms import REGISTRY
    from repro_torch.benchmarks.resilience import run_resilience_bench
    from repro_torch.core import RetryPolicy, SystemConfig, run
    from repro_torch.core.durability import CheckpointStore
    from repro_torch.testing import (ProcessKillFault, SimulatedProcessDeath,
                                     make_fault)
    _zero_seg_counts()
    torch.cuda.synchronize()
    reserved = [torch.cuda.memory_reserved(dev)]
    record = dict(cells=[], short=[], faults=[])
    plains, programs = {}, {}
    for cfg, apps in GRAPH_CELLS:
        for app in apps:
            program, seed = REGISTRY[app](), PRIORITY_SEED.get(app)
            plain, plain_s, _, _ = _engine_runs(program, graph, cfg, dev,
                                                "fused", True, seed)
            res, ckpt_s, _, _ = _engine_runs(
                program, graph, cfg, dev, "fused", True, seed,
                checkpoint_every=RESILIENCE_K)
            _clean_checkpointed(app, cfg, res, plain)
            plains[app, cfg], programs[app, cfg] = plain, program
            med, plain_med = statistics.median(ckpt_s), \
                statistics.median(plain_s)
            entry = dict(app=app, config=cfg, iterations=res.iterations,
                         seconds=med, seconds_runs=ckpt_s,
                         plain_seconds=plain_med, plain_seconds_runs=plain_s,
                         ratio=med / plain_med,
                         plain_replays=plain.dispatches,
                         **_boundary_figures(res))
            record["cells"].append(entry)
            log(f"resilience {app} {cfg} K={RESILIENCE_K}: ok "
                f"iterations={res.iterations} ckpt_ms={med * 1e3:.4f} "
                f"plain_ms={plain_med * 1e3:.4f} ratio={entry['ratio']:.3f} "
                f"(medians of {TIMED_RUNS}) segments={entry['segments']} "
                f"replays={entry['replays']}/{plain.dispatches} "
                f"host_reads={entry['host_reads']} " + " ".join(
                    f"{k}={entry[k]}" for k in (
                        "boundary_ms", "bytes_per_boundary", "sentinel_ms",
                        "certificate_ms", "snapshot_ms")))
    for app, cfg in RESILIENCE_SHORT:
        res, seconds, _, _ = _engine_runs(
            programs[app, cfg], graph, cfg, dev, "fused", True,
            PRIORITY_SEED.get(app), checkpoint_every=RESILIENCE_SHORT_K)
        _clean_checkpointed(app, cfg, res, plains[app, cfg])
        entry = dict(app=app, config=cfg, k=RESILIENCE_SHORT_K,
                     seconds=statistics.median(seconds), seconds_runs=seconds,
                     **_boundary_figures(res))
        record["short"].append(entry)
        log(f"resilience {app} {cfg} K={RESILIENCE_SHORT_K}: ok "
            f"{json.dumps(entry)}")

    for app, cfg, mode in FAULT_CASES:
        clean, seed = plains[app, cfg], PRIORITY_SEED.get(app)
        late = {"nan": dict(at_iteration=max(1, clean.iterations - 8)),
                # the done-boundary: a revert nothing heals afterwards
                "stale": dict(at_iteration=clean.iterations)}
        injector = make_fault(mode, **late.get(mode, {}))
        key = None if seed is None else torch.Generator().manual_seed(seed)
        t0 = time.perf_counter()
        res = run(REGISTRY[app](), graph, SystemConfig.from_name(cfg),
                  key=key, use_kernels=True, device=dev,
                  checkpoint_every=RESILIENCE_K,
                  retry=RetryPolicy(max_attempts=RESILIENCE_RETRY),
                  fault_injector=injector)
        seconds = time.perf_counter() - t0
        history = (res.fault or {}).get("history", [])
        what = f"fault {mode} on {app} {cfg}"
        if res.outcome == "converged":
            _same_answer(app, cfg, res, clean)
        elif res.outcome != "faulted" or res.converged or not history:
            raise AssertionError(f"{what}: outcome {res.outcome}, "
                                 f"history {history}")
        trips = [s for h in history for s in h.get("sentinels", ())]
        if mode == "stale" and "certificate" not in trips:
            raise AssertionError(f"{what}: the certificate did not catch it")
        if mode == "compile" and (res.engine != "host" or not any(
                h.get("engine") == "fused" for h in history)):
            raise AssertionError(f"{what}: ended on {res.engine}, history "
                                 f"{history}")
        if mode in ("nan", "bitflip", "exception") and not history:
            raise AssertionError(f"{what}: nothing was caught")
        entry = dict(app=app, config=cfg, mode=mode, outcome=res.outcome,
                     engine=res.engine, attempts=res.attempts,
                     iterations=res.iterations, seconds=seconds,
                     history=[{k: h.get(k) for k in (
                         "kind", "sentinels", "segment", "attempt",
                         "engine")} for h in history])
        record["faults"].append(entry)
        log(f"resilience {what}: ok {json.dumps(entry)}")

    # kill -> resume: the resumed run on a fresh program object (as in a
    # new process: its graph is captured again)
    app, cfg = KILL_CELL
    seed, clean = PRIORITY_SEED.get(app), plains[KILL_CELL]
    kill_dir = ROOT / "build" / "resilience_kill"
    shutil.rmtree(kill_dir, ignore_errors=True)

    def durable(**kw):
        key = None if seed is None else torch.Generator().manual_seed(seed)
        return run(REGISTRY[app](), graph, SystemConfig.from_name(cfg),
                   key=key, use_kernels=True, device=dev,
                   checkpoint_every=RESILIENCE_K,
                   checkpoint_dir=str(kill_dir), **kw)

    kill_at = clean.iterations - RESILIENCE_K
    killed_at = min(-(-kill_at // RESILIENCE_K) * RESILIENCE_K,
                    clean.iterations)
    try:
        durable(fault_injector=ProcessKillFault(at_iteration=kill_at,
                                                point="after_segment"))
        raise AssertionError("kill: the run was not killed")
    except SimulatedProcessDeath:
        pass
    on_disk, disk_faults = CheckpointStore(kill_dir).load_latest()
    t0 = time.perf_counter()
    resumed = durable()
    resume_s = time.perf_counter() - t0
    _same_run(app, cfg, resumed, clean)
    if resumed.fault is not None or disk_faults or not resumed.converged:
        raise AssertionError(f"kill: resumed with {resumed.fault}, "
                             f"{disk_faults}")
    lost = killed_at - on_disk.it
    record["kill"] = dict(
        app=app, config=cfg, k=RESILIENCE_K, iterations=clean.iterations,
        killed_at=killed_at, resumed_from=on_disk.it, lost_iterations=lost,
        lost_work_ratio=lost / clean.iterations, resume_seconds=resume_s,
        resumed_run_seconds=resumed.seconds,
        resumed_segments=resumed.resilience["segments"],
        generations=len(CheckpointStore(kill_dir)))
    log(f"resilience kill -> resume {app} {cfg}: ok (bit-identical) "
        f"{json.dumps(record['kill'])}")
    shutil.rmtree(kill_dir, ignore_errors=True)

    device_launches = {"seg_sum": 0, "seg_minmax": 0}
    record["profiles"] = {}
    for (app, cfg), kname in RESILIENCE_PROFILED.items():
        seed = PRIORITY_SEED.get(app)
        prof = profile_request(
            f"resilience {app} {cfg} K={RESILIENCE_K}", lambda: run(
                programs[app, cfg], graph, SystemConfig.from_name(cfg),
                key=None if seed is None
                else torch.Generator().manual_seed(seed),
                use_kernels=True, device=dev,
                checkpoint_every=RESILIENCE_K))
        found = _device_launches(prof)
        if found[kname] <= 0:
            raise AssertionError(f"resilience {app} {cfg}: the profiled "
                                 f"checkpointed run executed no {kname}")
        for k, n in found.items():
            device_launches[k] += n
        record["profiles"][f"{app} {cfg}"] = prof
    launches = _seg_counts()
    log(f"resilience path launches: {json.dumps(launches)}; device "
        f"launches (profiled runs): {json.dumps(device_launches)}")
    if min(launches.values()) <= 0:
        raise AssertionError("resilience path: a K1/K2 wrapper never "
                             "launched")
    torch.cuda.synchronize()
    reserved.append(torch.cuda.memory_reserved(dev))
    record["memory_reserved"] = dict(before=reserved[0], after=reserved[1])
    log(f"resilience memory_reserved: {reserved[0]} before, {reserved[1]} "
        f"after the phase's captured graphs")
    record["benchmark"] = run_resilience_bench(device=dev)
    for cfg_name, cell in record["benchmark"]["configs"].items():
        log(f"resilience bench {cfg_name}: {json.dumps(cell)}")
    log(f"resilience bench recovery: "
        f"{json.dumps(record['benchmark']['recovery'])}")
    return record, launches, device_launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results" / "torch" /
                                         "chip_smoke.json"))
    ap.add_argument("--sweep", action="store_true",
                    help="time K1/K2 over chunk sizes and threads per CTA, "
                         "and stop")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    build_s = build_phase()

    from repro_torch.graph import powerlaw_graph
    t0 = time.perf_counter()
    graph = powerlaw_graph(**AMZ)
    log(f"graph: AMZ stand-in V={graph.n_nodes} E={graph.n_edges} "
        f"block_size={graph.block_size} in "
        f"{time.perf_counter() - t0:.1f} s")

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    last = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    if args.sweep:
        records = sweep_phase(graph, dev, flush)
        out.write_text(json.dumps(dict(card=card, build_seconds=build_s,
                                       sweep=records), indent=1))
        log(last)
        return 0

    clock = _Clock()
    # 3. kernels against their plain versions
    rows = kernel_phase(graph, dev, flush)
    rows += embag_rows(dev, flush)
    free_device_memory()
    rows += attention_rows(dev, flush)
    del flush
    free_device_memory()

    clock.lap("3 kernels")
    # 4. the graph path, then the dispatch benchmark and the K sweep
    runs, launches, device_launches = main_path(graph, dev)
    clock.lap("4 graph path")
    dispatch = dispatch_phase(graph, dev)
    clock.lap("4b dispatch")
    from repro_torch.core import PLAN_CACHE
    PLAN_CACHE.clear()  # the captured graphs and their pools
    free_device_memory()

    # 4c. the tuner, 4d. batched execution
    tuned, tune_launches = autotune_phase(graph, dev)
    clock.lap("4c autotune")
    PLAN_CACHE.clear()
    free_device_memory()
    batched, batch_launches, batch_device = batch_phase(dev)
    clock.lap("4d batch")
    PLAN_CACHE.clear()
    free_device_memory()

    # 4e. checkpointed runs, faults, kill -> resume
    resilient, res_launches, res_device = resilience_phase(graph, dev)
    clock.lap("4e resilience")
    del graph
    PLAN_CACHE.clear()
    free_device_memory()

    # 5. DLRM serving
    dlrm, launches["embag"], k3_rows = dlrm_phase(dev)
    clock.lap("5 dlrm")
    rows += k3_rows
    free_device_memory()

    # 6. the attention entry point
    attn, launches["flash_attention"] = attention_path(dev)
    clock.lap("6 attention")
    free_device_memory()
    for row in rows:
        row["launches"] = launches[row["kernel"]]
        if row["kernel"] in device_launches:
            row["device_launches"] = device_launches[row["kernel"]]
            # the later paths, each counted from 0 on its own
            row["autotune_launches"] = tune_launches[row["kernel"]]
            row["batch_launches"] = batch_launches[row["kernel"]]
            row["batch_device_launches"] = batch_device[row["kernel"]]
            row["resilience_launches"] = res_launches[row["kernel"]]
            row["resilience_device_launches"] = res_device[row["kernel"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: no launch on its path")

    out.write_text(json.dumps(dict(card=card, build_seconds=build_s,
                                   kernels=rows, runs=runs,
                                   dispatch=dispatch, autotune=tuned,
                                   autotune_launches=tune_launches,
                                   batch=batched,
                                   batch_launches=batch_launches,
                                   batch_device_launches=batch_device,
                                   resilience=resilient,
                                   resilience_launches=res_launches,
                                   resilience_device_launches=res_device,
                                   dlrm=dlrm, attention=attn,
                                   phase_seconds=clock.seconds), indent=1))
    # 7. the kernel table, then the last line
    log(json.dumps({"kernels": rows}))
    log(last)
    return 0


if __name__ == "__main__":
    sys.exit(main())
