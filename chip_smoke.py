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
2. build: compile the three kernel libraries from this checkout's
   sources (one ``nvcc`` for sm_90a per source, all started together)
   and print each build's seconds and ``ptxas`` register lines.
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
4. graph path: with the K1/K2 counts set to 0, run BFS, SSSP and
   PageRank through ``repro_torch.core.run`` with ``use_kernels=True``
   under SD1 (owned kernel), TG0 (pull kernel) and DD1 (both kernels
   plus the sparse gather), each cell once untimed and then 3 timed
   runs (the median is kept: single host-clock runs vary); require each
   run to launch its kernel; then check the states against the numpy
   oracles (BFS exact, SSSP rtol=1e-5, PR atol=1e-6).  The same cells
   run the same way with ``use_kernels=False`` (plain scatter
   reductions) for comparison.
5. DLRM serving: MLPerf DLRM (Criteo 1TB) at full width with every
   table capped at 16,000,000 rows (43.0 GB of float32 tables; the
   full 96.1 GB do not fit one 80 GB card), random weights from a
   seeded generator.  With the K3 count set to 0, serve each cell one
   untimed warm-up request (the first request of a shape pays the
   allocator's first ``cudaMalloc`` of its activations), then 8 timed
   serve_p99 requests (batch 512), 4 serve_bulk (262,144) and 4
   retrieval_cand (one query, 1,000,448 candidates); require 26 K3
   launches per forward and finite outputs of the expected shapes,
   logits bit-equal to the plain embedding bag's for one 512 batch, and
   the first 16 logits and 4,096 scores within 1e-4 of a float64 numpy
   reference.  Each timed request is timed with CUDA events around it
   (device time, host gaps included) and with the host clock until the
   call returns (its issue time); the median and the slowest are
   printed.
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
    """Build the three kernel libraries, one ``nvcc`` per source, all
    started together; returns each source's build seconds."""
    from repro_torch.kernels._build import build
    from repro_torch.kernels.embedding_bag import SOURCE as EMBAG
    from repro_torch.kernels.flash_attention import SOURCE as FLASH
    from repro_torch.kernels.segment_reduce import SOURCE as SEGMENT

    def timed(source):
        t0 = time.perf_counter()
        lib, report = build(source)
        return lib, report, time.perf_counter() - t0

    sources = (SEGMENT, EMBAG, FLASH)
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
        want_launches = 0 if cell == "retrieval_cand" else cfg.n_sparse
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
    del model, batches, outs, plain
    return record, launches


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


def _timed_runs(factory, graph, cfg, dev, kernel=None) -> tuple:
    """One untimed run of a cell, then TIMED_RUNS timed ones, through
    ``kernel`` (each run must launch it) or, without one, through the
    plain reductions; returns the last result and the timed seconds."""
    from repro_torch.core import SystemConfig, run
    seconds = []
    for i in range(TIMED_RUNS + 1):
        before = kernel.launches if kernel else 0
        res = run(factory(), graph, SystemConfig.from_name(cfg),
                  use_kernels=kernel is not None, device=dev)
        if kernel and kernel.launches == before:
            raise AssertionError(f"{cfg} run {i} launched no "
                                 f"{kernel.__name__} kernel")
        if i:
            seconds.append(res.seconds)
    return res, seconds


def main_path(graph, dev) -> tuple:
    from repro_torch.algorithms import bfs, pagerank, sssp
    from repro_torch.algorithms.reference import (bfs_np, pagerank_np,
                                                  sssp_np)
    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    apps = {"BFS": (bfs, seg_minmax), "SSSP": (sssp, seg_minmax),
            "PR": (pagerank, seg_sum)}
    seg_sum.launches = 0
    seg_minmax.launches = 0
    results = []
    for cfg in ("SD1", "TG0", "DD1"):
        for app, (factory, kernel) in apps.items():
            before = kernel.launches
            res, seconds = _timed_runs(factory, graph, cfg, dev, kernel)
            launched = kernel.launches - before
            if not res.converged:
                raise AssertionError(f"{app} under {cfg} did not converge")
            results.append((app, cfg, res, seconds, kernel.__name__,
                            launched))
    launches = {"seg_sum": seg_sum.launches,
                "seg_minmax": seg_minmax.launches}
    log(f"main path launches: {json.dumps(launches)}")
    # the same cells with the plain scatter reductions, for comparison
    plain_seconds = {}
    for app, cfg, res, _, _, _ in results:
        plain, seconds = _timed_runs(apps[app][0], graph, cfg, dev)
        if plain.iterations != res.iterations and app != "PR":
            raise AssertionError(f"{app} {cfg}: iterations differ between "
                                 "kernel and plain reductions")
        plain_seconds[app, cfg] = seconds

    t0 = time.perf_counter()
    oracle = {"BFS": bfs_np(graph), "SSSP": sssp_np(graph),
              "PR": pagerank_np(graph)}
    log(f"oracles: {time.perf_counter() - t0:.1f} s")
    record = []
    for app, cfg, res, seconds, kname, launched in results:
        got = res.extract(apps[app][0]()).cpu().numpy()
        if not np.isfinite(got).any() or got.shape != oracle[app].shape:
            raise AssertionError(f"{app} {cfg}: bad result shape/values")
        if app == "BFS":
            np.testing.assert_array_equal(got, oracle[app])
        elif app == "SSSP":
            np.testing.assert_allclose(got, oracle[app], rtol=1e-5)
        else:
            np.testing.assert_allclose(got, oracle[app], atol=1e-6)
        med = statistics.median(seconds)
        plain_med = statistics.median(plain_seconds[app, cfg])
        entry = dict(app=app, config=cfg, iterations=res.iterations,
                     seconds=med, seconds_runs=seconds,
                     host_syncs=res.host_syncs,
                     host_syncs_per_iteration=res.host_syncs / res.iterations,
                     direction_trace=res.direction_trace,
                     sparse_iterations=res.sparse_iterations,
                     kernel=kname, kernel_launches=launched,
                     seconds_without_kernels=plain_med,
                     seconds_without_kernels_runs=plain_seconds[app, cfg])
        record.append(entry)
        log(f"run {app} {cfg}: ok iterations={res.iterations} "
            f"seconds={med:.4f} seconds_without_kernels={plain_med:.4f} "
            f"(median of {TIMED_RUNS} after 1 untimed) "
            f"host_syncs={res.host_syncs} "
            f"{kname}_launches={launched} "
            f"sparse_iterations={res.sparse_iterations} "
            f"direction_trace={res.direction_trace}")
    return record, launches


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

    # 3. kernels against their plain versions
    rows = kernel_phase(graph, dev, flush)
    rows += embag_rows(dev, flush)
    free_device_memory()
    rows += attention_rows(dev, flush)
    del flush
    free_device_memory()

    # 4. the graph path
    runs, launches = main_path(graph, dev)
    del graph
    free_device_memory()

    # 5. DLRM serving
    dlrm, launches["embag"] = dlrm_phase(dev)
    free_device_memory()

    # 6. the attention entry point
    attn, launches["flash_attention"] = attention_path(dev)
    free_device_memory()
    for row in rows:
        row["launches"] = launches[row["kernel"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: no launch on its path")

    out.write_text(json.dumps(dict(card=card, build_seconds=build_s,
                                   kernels=rows, runs=runs, dlrm=dlrm,
                                   attention=attn), indent=1))
    # 7. the kernel table, then the last line
    log(json.dumps({"kernels": rows}))
    log(last)
    return 0


if __name__ == "__main__":
    sys.exit(main())
