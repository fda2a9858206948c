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
     f32 full Sq=Sk=1,024 (atol=2e-3) on the CUDA-core kernel, and with
     the sliding window: bf16 causal Sq=Sk=8,192, window 4,096
     (starcoder2-7b's), against ``layers.blocked_attention`` (the plain
     version on the LM path: the one-pass plain version would hold tens
     of GB there), and f32 causal Sq=Sk=1,024, window 256; each row
     naming its kernel with its registers and shared memory;
     ``F.scaled_dot_product_attention`` with ``enable_gqa=True``, its
     causal mask aligned to the end as K4's is (``causal_lower_right``;
     the window as an explicit boolean mask, the SDPA backend it takes
     read from a profiled call's device ops), held to the same
     tolerance.  The bound counts the pairs the mask leaves visible.
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
4b. dispatch: ``python -m repro_torch.benchmarks.dispatch`` in a
   subprocess at its pinned workload (R-MAT scale 10, BFS, 18 configs x
   both engines, best of 10; writes ``results/torch/BENCH_dispatch.json``,
   log ``dispatch.log`` beside ``--out``), then the sweep of
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
4f. specialization: ``python -m repro_torch.benchmarks.matrix --scale
   1`` in a subprocess with ``PYTHONHASHSEED=0`` (every registered app on
   the six Table II stand-ins at Table II's own sizes, 18 configs each,
   K1/K2 on, ``autotune="measure"``, best of 3; writes
   ``results/torch/BENCH_matrix.json``; every cell must converge and the
   matrix must have launched K1 and K2), then ``python -m
   repro_torch.benchmarks.specialize`` in the same kind of subprocess
   (trains the model into ``results/torch/specialize_model.json``,
   evaluates every policy, writes ``results/torch/BENCH_specialize.json``;
   its gate must hold); both exiting 0, their output in ``matrix.log``
   and ``specialize.log`` beside ``--out``.  Then, with the K1/K2 counts
   set to 0, every app on the AMZ stand-in with ``specialize="static"``
   and ``"learned"`` (kernels on; a fallback warning fails the run):
   ``config_source`` as asked, the result equal to a plain ``run`` under
   the resolved config (phase 4's tolerances), the numpy oracle, and one
   profiled run with a K1/K2 device op wherever the resolved config
   reduces through a kernel order (``SD*``, ``T*``, ``D*``).  Last,
   ``run_batch(..., specialize="learned")`` on four stand-ins of
   different shapes, each result against its graph's sequential run
   under its own resolved config.
4g. gateway: the streaming gateway (``repro_torch.launch.serve``) with
   the kernels.  The sequential fused runs come first (each graph of
   each lane twice: the second, with its state's copy to the host, is a
   serial server's service time), then the K1/K2 counts are set to 0.
   (a) ``GraphGateway(max_batch=16, slice_len=8)`` over
   ``rmat_batch(16, 14, 8, seed=7)`` (weighted; one bucket, 524,288
   packed vertices and 4,194,304 edge slots) with three lanes, BFS SD1,
   SSSP SD1 and PR TG0: one warm-up wave of every graph in every lane,
   ``reset_stats()``, then 192 requests (64 per lane, cycling the
   graphs) from 16 closed-loop client threads; every result equal to
   its sequential run (exact apps bit for bit in state, iterations and
   traces; PR to atol 1e-6, iterations +-1), every ticket converged, no
   quarantine, no slice retried, no roster rebuilt after the warm-up;
   p50/p99 ms, requests/s against the serial server's, occupancy,
   slices, replays, host ms per slice (its replays and certificates
   apart) and certificate ms per retirement.
   One scheduling round (a slice of 16 in each lane) under the profiler
   must show K1 and K2 (taken again up to 5 times, from the third on
   with new program objects, whose lanes capture inside the profile);
   its idle share.
   (b) churn: 48 R-MAT-14 graphs through one BFS SD1 lane of 16: roster
   rebuilds, captured graphs added, ``memory_reserved`` before and
   after, every 8th result against its sequential run.  (c) the AMZ
   stand-in at ``max_batch=4``: 4 requests each of BFS SD1 and PR TG0,
   a cold wave (it builds the rosters) and a warm one.
   (d) on the (a) pool: ``SliceNaNFault`` on one SSSP ticket (only it
   faulted), ``SliceExceptionFault(times=1)`` (retried, all equal), a
   persistent ``SliceExceptionFault`` on one BFS ticket (only it
   faulted), packed-only faults that open the breaker, degrade to solo
   and close it, ``GatewayKillFault(after_slices=2)`` with its journal
   under ``build/`` and a fresh scheduler's ``recover`` (bit-identical),
   and a hopeless deadline shed with ``OverloadError``.  (e)
   ``python -m repro_torch.benchmarks.serve`` in a subprocess at its
   pinned workload (log ``serve.log``) and
   ``repro_torch.benchmarks.chaos``, writing
   ``results/torch/BENCH_serve.json`` and ``BENCH_chaos.json``.
4h. the paper's harnesses, the autotune benchmark and the perf gate, each
   ``python -m repro_torch.benchmarks.<name>`` in a subprocess with
   ``PYTHONHASHSEED=0`` (output in ``<name>.log`` beside ``--out``):
   ``table2`` (section (a) equal to the reference's, pinned here in
   ``TABLE2_PINNED``), ``fig5 --scale 1`` (every app on the six Table II
   stand-ins at Table II's own sizes, the reference's configs per app,
   best of 3 on the fused engine; every cell converged, every ``D*``
   cell with a direction trace), ``table5 --scale 1`` ((a) must read
   36/36; (b) prints the deployed hits and mean gap), ``fig6``,
   ``autotune`` at its pinned workloads (BFS in all 18 configs with
   K1/K2 under ``autotune="off"`` and ``"measure"``: its K1/K2 wrapper
   calls, counted from 0 in its own process, must both be > 0, every
   ``measure`` state must equal its ``off`` state bit for bit, and both
   must equal a run of the plain version, ``use_kernels=False``, on the
   card bit for bit),
   writing ``results/torch/{table2,fig5,table5,fig6}.json`` and
   ``BENCH_autotune.json``; last, ``repro_torch.benchmarks.compare``
   over every ``results/torch/BENCH_*.json`` this run wrote against
   ``results/torch/baselines/`` (per-metric medians of three card
   runs), which must exit 0.
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
7. LM serving (``repro_torch.launch.lm_demo``): (a) starcoder2-7b at its
   full config (32 layers, 7.17 B bf16 parameters drawn on the card from
   ``torch.Generator`` seed 0), with the K4 count set to 0, served by
   ``lm_demo.serve`` at batch 4, an 8,192-token prompt and 16 generated
   tokens, after serve's untimed prefill and decode step at the same
   shapes: require 32 K4 launches in the timed prefill (one per layer,
   with the window of 4,096), 64 in the call, and finite logits; print
   prefill ms, decode ms per token and peak memory, and log the process
   state the earlier phases leave (sync-debug mode, live threads, the
   objects the garbage collector tracks, its passes during the call).
   (b) The served prefill's last-token logits (B=4, S=8,192, K4)
   against a prefill of the same prompt with ``blocked_attention``:
   within ``LM_LOGIT_TOL``, the same argmax.  (c) Decode of token 6,000 (past
   the window) against ``prefill(tokens[:6000])``'s cache, against
   ``prefill(tokens[:6001])``'s last logits, to the same tolerance.
   One profiled prefill and one profiled decode step at (a)'s shapes
   (top device ops, idle share, K4's device ms).  (d) command-r-35b at
   full width and 4 of its 40 layers (the depth is the only cut;
   parallel block, SwiGLU, no bias, rope theta 8e6, K4 without a
   window), counted from 0: prefill at B=1, S=2,048 and 8 decode steps
   with 4 K4 launches in the timed prefill (8 in the call), then the
   served prefill against ``blocked_attention`` as in (b).
8. training (no kernel runs here: K3 and K4 have no
   backward, and both packages train through the plain embedding bag
   and ``blocked_attention``).  (a) DLRM-MLPerf's train_batch at full
   widths with every table capped at 4,000,000 rows (24,063,992 rows:
   49.3 GB of params, grads and f32 moments; seed 0), B = 65,536
   ``dlrm_batch`` of (seed, step), dense AdamW at lr 1e-3 through
   ``train_loop``: one untimed step, then 4 timed; ms/step (median),
   samples/s, peak ``max_memory_allocated``, the bytes bound of the
   grads, the clip and AdamW (9 f32 copies of the parameters at 3.35
   TB/s); every leaf changed, finite losses and grad norms, no K3 call;
   one profiled step (busy share, top ops, no K3 op); the largest
   table's gradient nonzero on exactly the rows the batch looked up.
   (b) starcoder2-7b at full width and 8 of its 32 layers (bf16 from
   seed 0), train_4k's 4,096 tokens, B = 4 as 4 microbatches of 1
   accumulated in f32, remat on, one untimed and 3 timed steps on one
   repeated batch: the loss must fall; ms/step, tokens/s, the model
   FLOPs share of 989 TFLOP/s (6 N tokens plus 12 L H dh per visible
   pair), peak memory, one profiled step (no K4 op, no K4 call).  (c)
   the reduced DLRM (f32) and starcoder2-7b (bf16 as configured, and
   f32): 3 steps on the card against 3 on the CPU from the same
   parameters (``TRAIN_TOL``), and a DLRM run killed after 4 steps,
   resumed through ``checkpoint_dir`` under ``build/``, against an
   uninterrupted one.
9. the MoE LMs (``repro_torch.models.moe``).  (a) qwen3-moe-235b-a22b
   and grok-1-314b at full width, their depth cut to 8 of 94 and 4 of
   64 layers (about 41 GB of bf16 weights each, seed 0), with the K4
   count set to 0, served by ``lm_demo.serve`` at B=4, a 4,096-token
   prompt and 16 tokens after its untimed prefill and decode step:
   require one K4 launch per layer in the timed prefill (two per layer
   in the call; Hq/Hkv 64/4 and 48/8, no window), finite logits; print
   prefill ms, decode ms per token, the share of (token, expert)
   assignments the timed prefill dropped at capacity and peak memory.
   (b) The served prefill's last-token logits against a prefill of the
   same prompt with ``blocked_attention``: within ``MOE_LOGIT_TOL``, the
   same argmax, and the share of (token, layer) whose experts differ
   between the two.  (c) One profiled prefill split by its
   ``record_function`` ranges: attention, routing, dispatch, the
   grouped GEMM, combine.  (d) qwen3-moe at full width and 1 layer,
   4 x 4,096 tokens, remat, 1 untimed + 3 timed steps of
   ``lm_train_step(forward=moe_train_forward)`` on one repeated batch:
   the loss must fall; ms/step, tokens/s, MFU of 989 TFLOP/s from the
   active parameters (6 N_active tokens plus the attention), peak
   memory beside the reckoned bytes, one profiled step (no K4).  (e)
   Both reduced MoEs in f32 and bf16, card against CPU from the same
   parameters: prefill (routing and ``keep`` equal in f32), 4 decode
   steps (f32 1e-4 with the argmax, bf16 ``LM_LOGIT_TOL``) and 3 train
   steps at ``TRAIN_TOL`` (bf16: ``MOE_BF16_TRAIN_TOL``).  K4 is also timed in phase 3 at both
   prefill shapes (B=4, S=4,096, bf16 causal) against
   ``blocked_attention`` and SDPA.
10. the GNNs (``repro_torch.models.gnn``), all training through
   ``aggregate``: PNA and MeshGraphNet at full config on
   ``full_graph_sm`` (a ``powerlaw_graph`` of 3,072 nodes asked for
   half the shape's 10,752 edges: 12,928 once symmetrized, d_feat 1,433)
   and
   ``minibatch_lg`` (the GraphSAGE tree of 1,024 seeds sampled 10 then
   15 deep from a ``powerlaw_graph`` of 164,864 nodes: 164,864 nodes,
   163,840 edges, d_feat 602), SchNet and EquiformerV2 on 128 molecules
   (3,840 atoms, 16,384 edges); 1 untimed + 3 timed steps on one repeated
   batch, AdamW at lr 1e-3: ms/step, peak memory, whether the loss fell,
   one profiled step's idle share.  ``ogb_products`` is reckoned, not
   run.  PNA at ``minibatch_lg`` under each of the six coherence x
   consistency configs from the same parameters: ms/step and the
   largest loss difference from SG0.  EquiformerV2's rotation
   invariance on the card (the reference's test, 5e-3), and the four
   reduced GNNs' 3 steps card against CPU at ``TRAIN_TOL`` (EquiformerV2,
   whose edge tensors are bf16, at its bf16 row).
11. the sharding pieces (``torch.distributed`` on the card): (a) an
   NCCL group of one rank and ``make_local_mesh()``'s 1 x 1 mesh;
   starcoder2-7b at full width and ``SHARD_LM_LAYERS`` layers, its
   parameters DTensors placed by ``lm_param_sharding`` (dp ``data``, tp
   and sp ``model``), prefilled on B=1 x 4,096 tokens under
   ``use_mesh`` with K4 inside ``local_map`` (one launch per layer,
   counted from 0) against the unsharded prefill of the same weights
   (bit-equal expected; else ``LM_LOGIT_TOL``, named), and the host ms
   the DTensor path adds per layer; (b) qwen3-moe-235b-a22b at full
   width and 1 layer, B=4 x 1,024 with 4 dispatch groups, so that the
   ``local_map`` routing, dispatch and combine run, against the
   unsharded prefill at the same groups: routing and ``keep`` equal,
   logits within ``MOE_LOGIT_TOL``; (c) one starcoder2-7b train step at
   ``SHARD_TRAIN_LAYERS`` layers through DTensor parameters and AdamW
   against the unsharded step at the bf16 ``TRAIN_TOL``; (d)
   ``CompressedReducer.reduce`` over the card's gradients with an NCCL
   all-reduce mean, wire and residual bit-equal to the same round on
   the CPU, then ``ElasticMesh.build()`` and ``reshard``, and a DTensor
   checkpoint saved and restored with ``shardings=``, bit-equal; (e)
   the dry run (``python -m repro_torch.launch.dryrun``, one process per
   cell, all started together) on ``SHARD_DRYRUN_CELLS`` with each LM's
   depth cut to ``SHARD_DRYRUN_LAYERS`` layers: each must end ``ok``;
   per-rank peak GB, FLOPs and collective GB beside the committed
   uncut records of ``results/torch/dryrun``; (f) the roofline row of
   ``benchmarks/run.py`` over those records and over the committed
   ones, at the H100's peaks.
12. the last names (after phase 11, so that nothing here touches what
   phase 4h read): (a) ``graph_stats`` of the AMZ stand-in on the card,
   equal to numpy on the host copy; (b) ``frontier_density`` of every
   frontier (BFS level) of a BFS SD1 run on it, a float32 bit-equal to
   numpy's float32 of the same counts; (c) after ``STATS.reset()``, SSSP
   TG0 (K2's min over the CSC order) and PR SD0 (K1's owned sum), each
   once on the host engine and once fused with the kernels and the
   K1/K2 counts from 0: each run's share of ``STATS.dispatches`` equal
   to its ``RunResult.dispatches`` (the host engine's iterations, the
   fused engine's replays), the total equal to their sum, both kernels
   launched, the states equal to plain fused runs' (SSSP exact, PR to
   atol 1e-6); (d) ``gathered_segment_reduce`` on the card against
   ``gathered_segment_reduce_ref`` (sum, min, max; float32 and int32;
   ids out of range dropped): exact but for the float32 sum
   (``GATHER_SUM_TOL``); (e) ``python -m repro_torch.benchmarks.run
   --batch-only --batch-smoke`` and ``--resilience-only
   --resilience-smoke`` with ``--out-dir build/last_names_smoke``: both
   records ``smoke``, every batched state equal to its sequential run,
   every checkpointed PR run within tolerance, and the tracked
   ``results/torch/BENCH_batch.json`` and ``BENCH_resilience.json``
   unchanged by the phase; (f) ``examples/lm_demo_torch.py --steps 20``
   on the card: finite losses, one K4 launch per layer in its prefill,
   the decoded ids and ms per token.  (e) and (f) run in their own
   processes, one after another, after (a)-(d) (logs
   ``batch_smoke.log``, ``resilience_smoke.log``, ``lm_demo_torch.log``
   beside ``--out``).
13. print the kernel table as one JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

The full record also goes to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
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
#: the guarded steps per graph (K) of the sweep
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
#: K4 cases: (Sq, Sk, causal, dtype, window, plain version); the
#: windowed rows take starcoder2-7b's own window
#: (``configs/starcoder2_7b.py:12``) at its prefill length, and a quarter
#: of Sk on the f32 kernel.  The plain version at 8,192^2 is the LM
#: path's ``blocked_attention``: ``flash_attention_plain``'s score matrix
#: there would hold tens of GB
ATTN_CASES = [
    (4096, 4096, True, torch.bfloat16, None, "flash_attention_plain"),
    (512, 4096, True, torch.bfloat16, None, "flash_attention_plain"),
    (1024, 1024, False, torch.float32, None, "flash_attention_plain"),
    (8192, 8192, True, torch.bfloat16, 4096, "blocked_attention"),
    (1024, 1024, True, torch.float32, 256, "flash_attention_plain")]
#: K4 against its plain version: f32 to the reference's kernel-test
#: tolerance; bf16 to one bf16 step of the output (rtol 2**-7) plus 1e-2,
#: well under the output's scale (about 0.026 at 4,096 keys)
ATTN_TOL = {torch.float32: dict(rtol=0.0, atol=2e-3),
            torch.bfloat16: dict(rtol=2**-7, atol=1e-2)}
#: phase 7: starcoder2-7b served through lm_demo (weights from
#: ``torch.Generator`` seed LM_SEED on the card), K4 against its plain
#: version on the served prompt, decode at LM_DECODE_AT (past the
#: window) against prefill, and command-r-35b at full width and
#: LM_CR_LAYERS of its 40 layers (the depth is the only cut)
LM_SEED = 0
LM_SERVE = dict(batch=4, prompt_len=8192, gen=16)
LM_DECODE_AT = 6000
LM_CR_LAYERS = 4
LM_CR_SERVE = dict(batch=1, prompt_len=2048, gen=8)
#: two bf16 runs' last-token logits (K4 against blocked_attention,
#: decode against prefill): their largest difference was 0.073 on
#: logits of up to 8.4 (NVIDIA H100 80GB HBM3, 700.00 W; bf16 rounds p
#: and every activation at other places in the two runs, over 32 layers)
LM_LOGIT_TOL = 0.15
#: Phase 8, training.  DLRM-MLPerf's train_batch: full widths, every
#: table capped at TRAIN_DLRM_MAX_ROWS (params, grads and the two f32
#: moments of dense AdamW over 24,063,992 rows: 49.3 GB; 16 M rows would
#: need 172 GB), B = dlrm_mlperf.TRAIN_CELLS["train_batch"] (65,536),
#: 1 untimed + TRAIN_DLRM_TIMED steps
TRAIN_SEED = 0
TRAIN_DLRM_MAX_ROWS = 4_000_000
TRAIN_DLRM_TIMED = 4
#: starcoder2-7b at full width and TRAIN_LM_LAYERS of its 32 layers (bf16
#: params and grads, f32 moments and accumulators: 23.6 GB; 32 layers
#: would need 86 GB), train_4k's sequence, TRAIN_LM_BATCH sequences as
#: TRAIN_LM_MICRO microbatches, remat on, 1 untimed + TRAIN_LM_TIMED
#: steps on one repeated batch
TRAIN_LM_LAYERS = 8
TRAIN_LM_SEQ = 4096
TRAIN_LM_BATCH = 4
TRAIN_LM_MICRO = 4
TRAIN_LM_TIMED = 3
#: H100 SXM dense bf16 peak, from NVIDIA's H100 datasheet
BF16_FLOPS_PER_S = 989e12
#: (c): reduced configs, steps on the card against steps on the CPU, and
#: a run killed after TRAIN_KILL_AT steps resumed from its checkpoint.
#: Tolerances, f32: loss and grad norm rtol 1e-5, parameters rtol 1e-5
#: and atol 1e-4, a third of one step at the LM cell's lr of 3e-4 (AdamW
#: divides a gradient by its root mean square, so where a gradient is
#: near 0 a last-bit difference of the two devices' sums moves the
#: update by up to lr; largest seen 3.4e-5, on the reduced starcoder2-7b
#: in f32, NVIDIA H100 80GB HBM3, 700.00 W); bf16: loss atol 1e-3, grad
#: norm rtol 2e-3, parameters atol 4e-3 (one or two bf16 steps, the CPU
#: tests' bound against the reference; seen 1.5e-3).  That atol is more
#: than 3 steps move a weight, so the parameters' movement from their
#: start is held too, as a share of its norm: f32 1e-3 (seen 1.2e-4),
#: bf16 0.1 (seen 0.035; a bf16 update at half the lr shows 0.77 on the
#: CPU, a skipped one 1.0); and every leaf the CPU moved, the card moved
TRAIN_CHECK_STEPS = 3
TRAIN_RESUME_STEPS = 6
TRAIN_KILL_AT = 4
TRAIN_TOL = {torch.float32: dict(loss=dict(rtol=1e-5, atol=0.0),
                                 grad_norm=dict(rtol=1e-5, atol=0.0),
                                 params=dict(rtol=1e-5, atol=1e-4),
                                 movement=1e-3),
             torch.bfloat16: dict(loss=dict(rtol=0.0, atol=1e-3),
                                  grad_norm=dict(rtol=2e-3, atol=0.0),
                                  params=dict(rtol=0.0, atol=4e-3),
                                  movement=0.1)}
#: Phase 9, the MoE LMs, each at full width with its depth cut to
#: MOE_LAYERS (about 41 GB of bf16 weights each: qwen3-moe 4.98 GB a layer
#: and a 1.24 GB embedding, grok-1 9.84 GB a layer and 1.61 GB), weights
#: from seed MOE_SEED, served through lm_demo at MOE_SERVE; the served
#: prefill against blocked_attention within MOE_LOGIT_TOL (the dense LMs'
#: bound), the same argmax
MOE_SEED = 0
MOE_LAYERS = {"qwen3-moe-235b-a22b": 8, "grok-1-314b": 4}
MOE_SERVE = dict(batch=4, prompt_len=4096, gen=16)
MOE_LOGIT_TOL = LM_LOGIT_TOL
#: K4 at the MoE prefill shapes (B, S of MOE_SERVE): (arch, Hq, Hkv), D
MOE_ATTN = [("qwen3-moe-235b-a22b", 64, 4), ("grok-1-314b", 48, 8)]
MOE_D = 128
#: qwen3-moe trained at full width and MOE_TRAIN_LAYERS of its 94 layers
#: (bf16 params and grads, f32 moments and accumulators: ~56 GB before
#: activations at one layer; grok-1 would need ~82 GB at one layer and is
#: not trained), B x S tokens as MOE_TRAIN_MICRO microbatches (phase 8's
#: split), remat on, 1 untimed + MOE_TRAIN_TIMED steps on one repeated
#: batch
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_MICRO = 4, 4096, 4
MOE_TRAIN_TIMED = 3
#: Phase 10, the GNNs: each model at its full config on the GNN_SHAPES
#: that fit one card (ogb_products is reckoned, not run), 1 untimed +
#: GNN_TIMED steps on one repeated batch, AdamW at lr 1e-3; PNA at
#: minibatch_lg under each of aggregate's six configs; molecules of
#: MOLECULE atoms and directed edges each
GNN_SEED = 0
GNN_MODELS = ("pna", "meshgraphnet", "schnet", "equiformer-v2")
GNN_CELLS = [("pna", "full_graph_sm"), ("pna", "minibatch_lg"),
             ("meshgraphnet", "full_graph_sm"),
             ("meshgraphnet", "minibatch_lg"), ("schnet", "molecule"),
             ("equiformer-v2", "molecule")]
GNN_CONFIG_CELL = ("pna", "minibatch_lg")
#: minibatch_lg's sampled tree: seeds and per-hop fan-outs (the shape's
#: 1,024 x (1 + 10 + 150) nodes)
MINIBATCH_SEEDS, MINIBATCH_FANOUTS = 1024, (10, 15)
GNN_TIMED = 3
MOLECULE = dict(atoms=30, edges=128)
#: Phase 9 (e), the reduced MoEs' bf16 train steps card against CPU:
#: TRAIN_TOL's bf16 row but the grad norm at rtol 1e-2 (seen 3.1e-3 on
#: grok-1's, NVIDIA H100 80GB HBM3, 700.00 W: the combine's bf16
#: scatter-add rounds in the card's atomic order, and the router's top-k
#: of bf16 activations can pick another expert for a near tie)
MOE_BF16_TRAIN_TOL = dict(TRAIN_TOL[torch.bfloat16],
                          grad_norm=dict(rtol=1e-2, atol=0.0))
#: Phase 11, the sharding pieces: starcoder2-7b's sharded prefill at
#: full width and SHARD_LM_LAYERS layers on B x S tokens; qwen3-moe at
#: full width and 1 layer on SHARD_MOE; a starcoder2-7b train step at
#: SHARD_TRAIN_LAYERS layers on SHARD_TRAIN tokens in its microbatches
SHARD_SEED = 0
SHARD_LM_LAYERS = 4
SHARD_LM = dict(batch=1, seq=4096)
SHARD_LM_TIMED = 3
SHARD_MOE = dict(batch=4, seq=1024, groups=4)
SHARD_TRAIN_LAYERS = 2
SHARD_TRAIN = dict(batch=4, seq=1024, micro=2)
#: the dry run's cells on the card (arch, shape, mesh), each LM cut to
#: SHARD_DRYRUN_LAYERS layers (the committed sweep runs them uncut on a
#: host CPU: a full-depth LM train cell takes minutes to trace)
SHARD_DRYRUN_CELLS = [("grok-1-314b", "train_4k", "single"),
                      ("qwen3-moe-235b-a22b", "train_4k", "single"),
                      ("starcoder2-7b", "train_4k", "single"),
                      ("command-r-plus-104b", "prefill_32k", "single"),
                      ("dlrm-mlperf", "train_batch", "single"),
                      ("pna", "ogb_products", "single"),
                      ("grok-1-314b", "train_4k", "multi")]
SHARD_DRYRUN_LAYERS = 2
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
#: phase 4f: the matrix's scale (Table II's own sizes), the hash seed of
#: both benchmark subprocesses (``paper_graph`` seeds with ``hash(name)``),
#: their time limit, the specialize modes of the in-process runs, and
#: the batched specialized runs' stand-ins, scale and apps
MATRIX_SCALE = 1
HASH_SEED = "0"
BENCH_TIMEOUT_S = 900
SPECIALIZE_MODES = ("static", "learned")
SPEC_BATCH_GRAPHS = ("DCT", "OLS", "RAJ", "WNG")
SPEC_BATCH_SCALE = 16
SPEC_BATCH_APPS = ("BFS", "SSSP", "PR")
#: phase 4g: the steady stream's pool (one bucket: n_q 32,768, m_q
#: 262,144), its lanes (all with the kernels), requests per lane, client
#: threads, roster size and slice length; the churn pool (BFS SD1); the
#: AMZ stand-in's roster and requests per cell
GATEWAY_GRAPHS = dict(count=16, scale=14, edge_factor=8, seed=7)
GATEWAY_LANES = [("BFS", "SD1"), ("SSSP", "SD1"), ("PR", "TG0")]
GATEWAY_PER_LANE = 64
GATEWAY_CLIENTS = 16
GATEWAY_MAX_BATCH = 16
GATEWAY_SLICE_LEN = 8
GATEWAY_CHURN_GRAPHS = dict(count=48, scale=14, edge_factor=8, seed=11)
GATEWAY_AMZ_BATCH = 4
GATEWAY_AMZ_CELLS = [("BFS", "SD1"), ("PR", "TG0")]
GATEWAY_AMZ_REQUESTS = 4

# phase 12, the last names
#: the STATS cells: K2's min over the CSC pull order, K1's owned sum
LAST_STATS_CELLS = [("SSSP", "TG0"), ("PR", "SD0")]
#: the BFS run whose frontiers ``frontier_density`` reads
LAST_BFS_CONFIG = "SD1"
#: ``gathered_segment_reduce`` on the card: slots, segments (16 slots a
#: segment), ids drawn from [-2, segments + 2): the out-of-range ones
#: are dropped
GATHER_CASE = dict(n=65_536, segments=4_096, seed=12)
#: the float32 sum of ~16 N(0, 1) values a segment, added by the card's
#: atomics in a run-dependent order against numpy's one slot at a time:
#: each partial sum rounds by at most 2**-24 of its size (< 8 here), so
#: the two differ by a few 1e-6; min, max and int32 are exact
GATHER_SUM_TOL = dict(rtol=1e-5, atol=1e-5)
LM_DEMO_STEPS = 20

#: phase 4h: Fig. 5 at Table II's own sizes, and section (a) of Table II
#: as the reference's ``benchmarks/table2.py`` computes it from the
#: published statistics (published; computed from published)
FIG5_SCALE = 1
TABLE2_PINNED = {
    "AMZ": ((1855.178, "H", 0.16, "M", 0.0, "L"), (1855.178, "H", 0.1578, "M")),
    "DCT": ((60.078, "M", 0.359, "M", 0.083, "M"), (60.085, "M", 0.3593, "M")),
    "EML": ((287.272, "H", 0.053, "L", 1.0, "H"), (287.272, "H", 0.0529, "L")),
    "OLS": ((200.898, "M", 0.445, "H", 0.0, "L"), (200.898, "M", 0.4452, "H")),
    "RAJ": ((47.869, "L", 0.594, "H", 0.617, "H"), (47.869, "L", 0.5941, "H")),
    "WNG": ((79.458, "M", 0.0051, "L", 0.0, "L"), (79.198, "M", 0.0051, "L")),
}


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


def _visible_pairs(sq: int, sk: int, causal: bool, window=None) -> int:
    """(query, key) pairs K4 must score: all of them, or under the causal
    mask aligned to the end, those with key <= row + Sk - Sq (a row that
    sees no key averages all Sk, as the TPU kernel's -1e30 rule does),
    and with a window also key > row + Sk - Sq - window."""
    if not causal:
        return sq * sk
    rows = np.arange(sq) + (sk - sq) + 1          # keys 0 .. row visible
    seen = np.minimum(rows, sk)
    if window is not None:
        seen = np.minimum(seen, window)
    return int(np.where(rows > 0, seen, sk).sum())


def _qkv(gen, dev, sq, sk, dtype):
    shapes = ((1, SC2_HQ, sq, SC2_D), (1, SC2_HKV, sk, SC2_D),
              (1, SC2_HKV, sk, SC2_D))
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in shapes]


def _window_mask(sq: int, sk: int, window: int, dev) -> torch.Tensor:
    """SDPA's boolean mask (True = attend) of K4's causal window."""
    rows = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=dev)[None, :]
    return (cols <= rows) & (cols > rows - window)


def attention_rows(dev, flush) -> list:
    """K4 at starcoder2-7b widths."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     kernel_info)
    from repro_torch.models.layers import blocked_attention
    plains = dict(flash_attention_plain=flash_attention_plain,
                  blocked_attention=blocked_attention)
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for sq, sk, causal, dtype, window, plain_name in ATTN_CASES:
        info = kernel_info(dtype, SC2_D)
        log(f"flash_attention {str(dtype)[6:]} D={SC2_D}: {info['kernel']}, "
            f"{info['registers']} registers, {info['shared_bytes']} bytes "
            "of shared memory")
        q, k, v = _qkv(gen, dev, sq, sk, dtype)
        kernel = lambda: flash_attention(q, k, v, causal=causal,
                                         window=window)
        plain = lambda: plains[plain_name](q, k, v, causal=causal,
                                           window=window)
        # Sq <= Sk here, so every row sees a key and the -1e30 rule is
        # moot: SDPA with the end-aligned mask (and the window as an
        # explicit boolean mask) computes the same function
        if window is not None:
            mask = _window_mask(sq, sk, window, dev)
        else:
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
        # which SDPA backend took the call with the window's mask: its
        # device ops' names
        library_ops = None if window is None else [
            op["name"] for op in profile_request(
                f"sdpa Sq={sq} window={window}", library)["top"]]
        elt = q.element_size()
        moved = (2 * q.numel() + k.numel() + v.numel()) * elt
        pairs = _visible_pairs(sq, sk, causal, window)
        ops = 4 * SC2_HQ * pairs * SC2_D
        mask_name = ("causal" if causal else "full") + (
            f",window={window}" if window is not None else "")
        rows.append(_row(
            f"flash_attention[{str(dtype)[6:]},{mask_name},B=1,"
            f"Hq={SC2_HQ},Hkv={SC2_HKV},Sq={sq},Sk={sk},D={SC2_D}]",
            "flash_attention", err, time_ms(kernel, flush),
            time_ms(plain, flush), library_ms, moved, ops,
            BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S,
            library_max_abs_err=library_err, sq=sq, sk=sk, causal=causal,
            window=window, visible_pairs=pairs, plain=plain_name,
            library_ops=library_ops, k4_kernel=info["kernel"],
            registers=info["registers"], shared_bytes=info["shared_bytes"]))
        del q, k, v, got, want, lib_out, mask
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
                     for name, (ms, n) in top], counts=counts,
                ms_by_name={name: ms for name, (ms, _) in by_name.items()})


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


def _lm_check(what: str, got: torch.Tensor, want: torch.Tensor,
              tol: float) -> dict:
    """Last-token logits of two runs of one LM: finite, within ``tol``
    of each other, the same argmax per row; the figures are logged
    before any check can raise."""
    err = float((got - want).abs().max())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    top2 = want.topk(2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    log(f"lm {what}: max_abs_err={err} tol={tol} argmax_equal={same} "
        f"top1-top2 gap={gap:.4f} max|logit|={float(want.abs().max()):.3f}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"lm {what}: non-finite logits")
    if err > tol or not same:
        raise AssertionError(f"lm {what}: logits differ by {err} "
                             f"(tol {tol}), argmax equal {same}")
    return dict(max_abs_err=err, argmax_equal=same, top_gap=gap)


def _process_state() -> dict:
    """What the earlier phases leave in the process that can slow a
    host-bound loop: the sync-debug mode, the live Python threads and
    all of the process's threads, the objects the garbage collector
    tracks, and the host's load average."""
    return dict(sync_debug_mode=torch.cuda.get_sync_debug_mode(),
                threads=sorted(t.name for t in threading.enumerate()),
                os_threads=len(os.listdir("/proc/self/task")),
                gc_objects=len(gc.get_objects()),
                load_avg=os.getloadavg())


@contextlib.contextmanager
def _gc_pauses():
    """The garbage collector's passes inside the block: their number
    and their total ms on the host clock."""
    pauses, started = dict(collections=0, ms=0.0), []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses["collections"] += 1
            pauses["ms"] += (time.perf_counter() - started.pop()) * 1e3

    gc.callbacks.append(on_gc)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(on_gc)


def lm_phase(dev) -> tuple:
    """Phase 7: dense-LM serving at published widths.  Returns (record,
    K4 launches of starcoder2-7b's serving run, of command-r-35b's)."""
    import dataclasses as dc
    from repro_torch.configs import command_r_35b, starcoder2_7b
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.lm_demo import serve
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    record = {}

    # (a) starcoder2-7b at its full config, served through lm_demo
    cfg = starcoder2_7b.CFG
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(dev).manual_seed(LM_SEED), dev)
    torch.cuda.synchronize()
    log(f"lm {cfg.name}: {cfg.n_layers} layers, {cfg.n_params} parameters, "
        f"{sum(t.numel() * t.element_size() for t in params.parameters())} "
        f"bytes, drawn in {time.perf_counter() - t0:.1f} s")
    record["process"] = _process_state()
    flash_attention.launches = 0
    with _gc_pauses() as pauses:
        served = serve(cfg, params, device=dev, **LM_SERVE)
    sc2_launches = flash_attention.launches
    record["process"]["gc_during_serve"] = pauses
    log(f"lm process: {json.dumps(record['process'])}")
    log(f"lm launches: {json.dumps({'flash_attention': sc2_launches})}")
    # serve's untimed warm-up prefill and its timed one: one launch per
    # layer each
    if (served["k4_launches"] != cfg.n_layers
            or sc2_launches != 2 * cfg.n_layers):
        raise AssertionError(f"lm {cfg.name}: {served['k4_launches']} K4 "
                             f"launches in its timed prefill and "
                             f"{sc2_launches} in all, {cfg.n_layers} "
                             "layers")
    if not torch.isfinite(served["last_logits"]).all():
        raise AssertionError(f"lm {cfg.name}: non-finite logits")
    record[cfg.name] = {k: served[k] for k in (
        "batch", "prompt_len", "gen", "prefill_ms", "decode_ms_per_token",
        "k4_launches", "peak_bytes")}
    record[cfg.name]["token_ids"] = served["token_ids"][:, :8].tolist()
    got = served["prefill_logits"]
    del served
    free_device_memory()

    # (b) the served prefill (K4) against its plain version on the same
    # prompt, at the served batch
    b, s = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    prompt = lm_batch(0, b, s, cfg.vocab)["tokens"]
    want, _ = prefill(cfg, params, prompt, impl="plain", device=dev)
    record["k4_vs_plain"] = _lm_check(
        f"{cfg.name} served prefill K4 vs blocked_attention B={b} S={s}",
        got, want, LM_LOGIT_TOL)
    # (c) decode past the window against prefill
    t = LM_DECODE_AT
    toks = torch.from_numpy(lm_batch(1, 1, t + 1, cfg.vocab)
                            ["tokens"]).to(dev)
    _, (kc, vc) = prefill(cfg, params, toks[:, :t], device=dev)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, t + 1, cfg.d_head)
    k_cache = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    v_cache = torch.zeros_like(k_cache)
    k_cache[:, :, :, :t], v_cache[:, :, :, :t] = kc, vc
    del kc, vc
    lg, _ = decode_step(cfg, params, toks[:, t:t + 1], (k_cache, v_cache), t,
                        device=dev)
    full, _ = prefill(cfg, params, toks[:, :t + 1], device=dev)
    record["decode_vs_prefill"] = _lm_check(
        f"{cfg.name} decode at t={t} vs prefill", lg[:, 0], full,
        LM_LOGIT_TOL)
    del got, want, lg, full, k_cache, v_cache
    free_device_memory()

    # one profiled prefill and one profiled decode step at (a)'s shapes
    cache = {}
    record["profile_prefill"] = profile_request(
        "lm prefill", lambda: cache.setdefault(
            "kv", prefill(cfg, params, prompt, device=dev)[1]))
    kc, vc = cache.pop("kv")
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s + 1, cfg.d_head)
    k_cache = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    v_cache = torch.zeros_like(k_cache)
    k_cache[:, :, :, :s], v_cache[:, :, :, :s] = kc, vc
    del kc, vc
    tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    record["profile_decode"] = profile_request(
        "lm decode step", lambda: decode_step(
            cfg, params, tok, (k_cache, v_cache), s, device=dev))
    for key in ("profile_prefill", "profile_decode"):
        k4 = sum(ms for name, ms in record[key]["ms_by_name"].items()
                 if "flash_fwd" in name)
        record[key]["k4_ms"] = k4
        log(f"lm {key}: K4 {k4:.4f} ms of {record[key]['device_busy_ms']:.4f}"
            " ms busy")
    del params, k_cache, v_cache, tok
    free_device_memory()

    # (d) command-r-35b at full width, its depth cut to LM_CR_LAYERS
    cr = dc.replace(command_r_35b.CFG, n_layers=LM_CR_LAYERS)
    log(f"lm {cr.name}: full width, {cr.n_layers} of "
        f"{command_r_35b.CFG.n_layers} layers (reduced: depth only), "
        f"{cr.n_params} parameters")
    params = init_lm(cr, torch.Generator(dev).manual_seed(LM_SEED), dev)
    flash_attention.launches = 0
    served = serve(cr, params, device=dev, **LM_CR_SERVE)
    cr_launches = flash_attention.launches
    log(f"lm launches: {json.dumps({'flash_attention': cr_launches})}")
    if (served["k4_launches"] != cr.n_layers
            or cr_launches != 2 * cr.n_layers):
        raise AssertionError(f"lm {cr.name}: {served['k4_launches']} K4 "
                             f"launches in its timed prefill and "
                             f"{cr_launches} in all, {cr.n_layers} layers")
    if not torch.isfinite(served["last_logits"]).all():
        raise AssertionError(f"lm {cr.name}: non-finite logits")
    record[cr.name] = {k: served[k] for k in (
        "batch", "prompt_len", "gen", "prefill_ms", "decode_ms_per_token",
        "k4_launches", "peak_bytes")}
    record[cr.name]["layers"] = f"{cr.n_layers} of {command_r_35b.CFG.n_layers}"
    b, s = LM_CR_SERVE["batch"], LM_CR_SERVE["prompt_len"]
    got = served["prefill_logits"]
    want, _ = prefill(cr, params, lm_batch(0, b, s, cr.vocab)["tokens"],
                      impl="plain", device=dev)
    record["cr_k4_vs_plain"] = _lm_check(
        f"{cr.name} served prefill K4 vs blocked_attention B={b} S={s}",
        got, want, LM_LOGIT_TOL)
    del params, served, got, want
    free_device_memory()
    return record, sc2_launches, cr_launches


def _leaf_samples(params) -> dict:
    """Up to 2**20 evenly strided elements of every parameter, copied."""
    out = {}
    for name, p in params.named_parameters():
        flat = p.detach().reshape(-1)
        out[name] = flat[::max(1, flat.numel() >> 20)].clone()
    return out


def _unchanged(params, before: dict) -> list:
    now = _leaf_samples(params)
    return [n for n, t in before.items() if torch.equal(t, now[n])]


def _timed_rows(hist: list, timed: int, what: str) -> dict:
    """The median seconds of the last ``timed`` rows of a history, after
    checking every row's loss and grad norm are finite."""
    for row in hist:
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise AssertionError(f"train {what}: non-finite metrics {row}")
    secs = [r["seconds"] for r in hist[-timed:]]
    log(f"train {what}: losses {[round(r['loss'], 6) for r in hist]} "
        f"grad_norms {[round(r['grad_norm'], 6) for r in hist]} "
        f"seconds {[round(r['seconds'], 6) for r in hist]}")
    return dict(ms=statistics.median(secs) * 1e3, step_ms=[s * 1e3 for s in
                                                          secs],
                losses=[r["loss"] for r in hist],
                grad_norms=[r["grad_norm"] for r in hist])


def _kernel_ops(prof: dict) -> dict:
    """K3's and K4's device ops in a profiled step (must be none)."""
    names = prof.get("counts", {})
    return {name: n for name, n in names.items()
            if "embag" in name or "flash_fwd" in name}


def _movement(got_params, want_params, start) -> dict:
    """Each run's movement from the parameters ``start`` it began at
    (after - start, in f32): ``rel``, the norm of the two movements'
    difference over the norm of ``want``'s, over all leaves; the count
    of leaves ``want`` moved; and those of them ``got`` left as they
    were."""
    diff2 = want2 = 0.0
    moved, missing = 0, []
    for (n, a), (_, b), (_, s0) in zip(got_params.named_parameters(),
                                       want_params.named_parameters(),
                                       start.named_parameters()):
        s0 = s0.detach().double().cpu()
        da = a.detach().double().cpu() - s0
        db = b.detach().double().cpu() - s0
        diff2 += float(((da - db) ** 2).sum())
        want2 += float((db ** 2).sum())
        if db.any():
            moved += 1
            if not da.any():
                missing.append(n)
    return dict(rel=(diff2 / want2) ** 0.5 if want2 else float("inf"),
                leaves_moved=moved, not_moved=missing)


def _same_training(what, got_hist, want_hist, got_params, want_params,
                   dtype, start, tol=None) -> dict:
    """Two runs of the same steps from the parameters ``start``: losses,
    grad norms, parameters and the parameters' movement from ``start``
    within ``tol`` (default TRAIN_TOL of ``dtype``), and every leaf that
    ``want`` moved moved in ``got`` too; figures logged before any
    check."""
    tol = tol or TRAIN_TOL[dtype]
    errs = dict(loss=max(abs(a["loss"] - b["loss"])
                         for a, b in zip(got_hist, want_hist)),
                grad_norm=max(abs(a["grad_norm"] - b["grad_norm"])
                              for a, b in zip(got_hist, want_hist)))
    worst = 0.0
    for (n, a), (_, b) in zip(got_params.named_parameters(),
                              want_params.named_parameters()):
        worst = max(worst, float((a.detach().float().cpu()
                                  - b.detach().float().cpu()).abs().max()))
    errs["params"] = worst
    move = _movement(got_params, want_params, start)
    errs["movement"] = move["rel"]
    bitwise = all(torch.equal(a.detach().cpu(), b.detach().cpu())
                  for a, b in zip(got_params.parameters(),
                                  want_params.parameters()))
    log(f"train {what}: max_abs_err {json.dumps(errs)} bit_identical="
        f"{bitwise} steps={len(got_hist)} leaves_moved="
        f"{move['leaves_moved']} not_moved={move['not_moved']}")
    if len(got_hist) != len(want_hist):
        raise AssertionError(f"train {what}: {len(got_hist)} steps against "
                             f"{len(want_hist)}")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got_hist],
                                   [r[key] for r in want_hist], **tol[key],
                                   err_msg=f"train {what}: {key}")
    for (n, a), (_, b) in zip(got_params.named_parameters(),
                              want_params.named_parameters()):
        torch.testing.assert_close(a.detach().float().cpu(),
                                   b.detach().float().cpu(),
                                   **tol["params"], msg=f"train {what}: {n}")
    if not move["leaves_moved"] or move["not_moved"]:
        raise AssertionError(f"train {what}: {move['leaves_moved']} leaves "
                             f"moved, of them not moved in the run checked: "
                             f"{move['not_moved']}")
    if not move["rel"] <= tol["movement"]:
        raise AssertionError(f"train {what}: the parameters' movement "
                             f"differs by {move['rel']} of its norm, limit "
                             f"{tol['movement']}")
    return dict(max_abs_err=errs, bit_identical=bitwise,
                leaves_moved=move["leaves_moved"])


def _dlrm_train(dev) -> dict:
    """(a) DLRM-MLPerf's train_batch at full widths, tables capped."""
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.base import dlrm_train_step, trainable
    from repro_torch.kernels.embedding_bag import embag
    from repro_torch.models.dlrm import dlrm_loss, init_dlrm
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoopConfig, train_loop
    cfg = dlrm_mlperf.capped(dlrm_mlperf.CFG, TRAIN_DLRM_MAX_ROWS)
    b = dlrm_mlperf.TRAIN_CELLS["train_batch"]
    params = init_dlrm(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED), dev)
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats(dev)  # the peak keeps what is held
    n = sum(p.numel() for p in params.parameters())
    log(f"train {cfg.name}: {n} parameters, {len(params.tables)} tables of "
        f"up to {max(t.shape[0] for t in params.tables)} rows, "
        f"{4 * n * 4} bytes of params, grads and moments, B={b}")
    before = _leaf_samples(params)
    step = dlrm_train_step(cfg, device=dev)
    embag.launches = 0
    _, _, hist = train_loop(
        step, params,
        lambda s: dlrm_mlperf.training_batch(cfg, s, batch=b,
                                             seed=TRAIN_SEED, device=dev),
        TrainLoopConfig(total_steps=1 + TRAIN_DLRM_TIMED), opt_state=opt)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    rec = _timed_rows(hist, TRAIN_DLRM_TIMED, cfg.name)
    # the gradients, the clip and AdamW read and write 9 f32 copies of
    # the parameters: grads written, read by the norm and by the update;
    # p, m, v read and written
    moved = 9 * 4 * n
    rec.update(n_params=n, batch=b, peak_bytes=peak,
               samples_per_s=b / (rec["ms"] / 1e3), bound_bytes=moved,
               bound_ms=moved / HBM_BYTES_PER_S * 1e3,
               k3_launches=embag.launches)
    log(f"train {cfg.name}: ms/step={rec['ms']:.4f} samples/s="
        f"{rec['samples_per_s']:.1f} peak={peak / 1e9:.3f} GB "
        f"bound_ms={rec['bound_ms']:.4f} (bytes: {moved} of grads, clip and "
        f"AdamW at {HBM_BYTES_PER_S / 1e12} TB/s) "
        f"bound_share={rec['bound_ms'] / rec['ms']:.3f} "
        f"K3 launches={embag.launches}")
    stale = _unchanged(params, before)
    if stale:
        raise AssertionError(f"train {cfg.name}: leaves unchanged {stale}")
    batch = dlrm_mlperf.training_batch(cfg, 1 + TRAIN_DLRM_TIMED, batch=b,
                                       seed=TRAIN_SEED, device=dev)
    rec["profile"] = profile_request(
        f"train {cfg.name} step", lambda: step(params, opt, batch))
    k3_ops = _kernel_ops(rec["profile"])
    if embag.launches or k3_ops:
        raise AssertionError(f"train {cfg.name}: K3 launched in training "
                             f"({embag.launches} calls, ops {k3_ops})")
    # the largest table's gradient: nonzero on exactly the rows looked up
    leaves = trainable(params)
    big = max(range(cfg.n_sparse), key=lambda f: params.tables[f].shape[0])
    table = leaves[f"table_{big}"]
    (grad,) = torch.autograd.grad(
        dlrm_loss(cfg, params, batch, impl="plain", device=dev), [table])
    nonzero = (grad != 0).any(dim=1)
    looked_up = torch.zeros_like(nonzero)
    looked_up[batch["sparse"][:, big].reshape(-1).long()] = True
    rows = int(looked_up.sum())
    if not torch.equal(nonzero, looked_up):
        raise AssertionError(
            f"train {cfg.name}: table {big}'s gradient is nonzero on "
            f"{int(nonzero.sum())} rows, {rows} were looked up, "
            f"{int((nonzero != looked_up).sum())} differ")
    log(f"train {cfg.name}: table {big} ({table.shape[0]} rows) gradient "
        f"nonzero on exactly the {rows} rows looked up; every leaf changed")
    rec.update(grad_rows=rows, grad_table=big)
    del params, opt, grad, leaves, table, batch, step
    free_device_memory()
    return rec


def _lm_train(dev) -> dict:
    """(b) starcoder2-7b at full width and TRAIN_LM_LAYERS layers."""
    import dataclasses as dc
    from repro_torch.configs import starcoder2_7b
    from repro_torch.configs.base import lm_train_step
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoopConfig, train_loop
    cfg = dc.replace(starcoder2_7b.CFG, n_layers=TRAIN_LM_LAYERS)
    b, s, mb = TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_MICRO
    params = init_lm(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED), dev)
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats(dev)
    n = cfg.n_params
    log(f"train {cfg.name}: full width, {cfg.n_layers} of "
        f"{starcoder2_7b.CFG.n_layers} layers (depth the only cut), {n} "
        f"parameters, B={b} as {mb} microbatches, S={s}, remat={cfg.remat}")
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(0, b, s, cfg.vocab).items()}
    step = lm_train_step(cfg, b, s, microbatches=mb, device=dev)
    flash_attention.launches = 0
    _, _, hist = train_loop(step, params, lambda i: batch,
                            TrainLoopConfig(total_steps=1 + TRAIN_LM_TIMED),
                            opt_state=opt)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    rec = _timed_rows(hist, TRAIN_LM_TIMED, cfg.name)
    tokens = b * s
    # model FLOPs: 6 N per token (N counts the tied embedding once, for
    # the logits), plus the attention's 12 H dh per visible (query, key)
    # pair and layer (4 forward, 8 backward); remat's recompute not counted
    window = cfg.window or s
    pairs = b * sum(min(i + 1, window) for i in range(s))
    flops = 6 * n * tokens + 12 * cfg.n_layers * cfg.n_heads * cfg.d_head \
        * pairs
    rec.update(n_params=n, tokens=tokens, peak_bytes=peak,
               tokens_per_s=tokens / (rec["ms"] / 1e3), model_flops=flops,
               mfu=flops / (rec["ms"] / 1e3) / BF16_FLOPS_PER_S,
               k4_launches=flash_attention.launches)
    log(f"train {cfg.name}: ms/step={rec['ms']:.4f} tokens/s="
        f"{rec['tokens_per_s']:.1f} model_flops={flops:.6e} (6*N*tokens + "
        f"12*L*H*dh*visible pairs) mfu={rec['mfu']:.4f} of "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s peak={peak / 1e9:.3f} GB "
        f"K4 launches={flash_attention.launches}")
    # the cell's AdamW (lr 3e-4, no warm-up) moves every weight by about
    # lr in its first step, which at this width raises the loss; on one
    # repeated batch it must then fall over the timed steps
    timed = rec["losses"][-TRAIN_LM_TIMED:]
    if not timed[-1] < timed[0]:
        raise AssertionError(f"train {cfg.name}: the loss did not fall over "
                             f"the timed steps on one repeated batch: "
                             f"{rec['losses']}")
    rec["profile"] = profile_request(f"train {cfg.name} step",
                                     lambda: step(params, opt, batch))
    k4_ops = _kernel_ops(rec["profile"])
    if flash_attention.launches or k4_ops:
        raise AssertionError(f"train {cfg.name}: K4 launched in training "
                             f"({flash_attention.launches} calls, ops "
                             f"{k4_ops})")
    del params, opt, batch, step
    free_device_memory()
    return rec


def _reduced_runs(dev) -> dict:
    """(c) the reduced configs: TRAIN_CHECK_STEPS steps on the card
    against the same steps on the CPU, from the same parameters; then a
    DLRM run killed after TRAIN_KILL_AT steps, resumed from its
    checkpoint, against an uninterrupted run."""
    import copy
    import dataclasses as dc
    import shutil
    from repro_torch.configs import dlrm_mlperf, starcoder2_7b
    from repro_torch.configs.base import dlrm_train_step, lm_train_step
    from repro_torch.data.synthetic import dlrm_batch, lm_batch
    from repro_torch.models.dlrm import init_dlrm
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import TrainLoopConfig, latest_step, train_loop
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    dl_cfg = dlrm_mlperf.REDUCED
    lm_cfg = starcoder2_7b.REDUCED
    cases = [
        ("dlrm-reduced f32", lambda: init_dlrm(dl_cfg, gen, cpu),
         lambda d: dlrm_train_step(dl_cfg, device=d),
         lambda s: dlrm_batch(s, 256, dl_cfg.vocab_sizes)),
        ("starcoder2-reduced bf16", lambda: init_lm(lm_cfg, gen, cpu),
         lambda d: lm_train_step(lm_cfg, 4, 64, microbatches=2, device=d),
         lambda s: lm_batch(s, 4, 64, lm_cfg.vocab)),
        ("starcoder2-reduced f32", lambda: init_lm(
            dc.replace(lm_cfg, param_dtype="float32"), gen, cpu),
         lambda d: lm_train_step(dc.replace(lm_cfg, param_dtype="float32"),
                                 4, 64, microbatches=2, device=d),
         lambda s: lm_batch(s, 4, 64, lm_cfg.vocab)),
    ]
    out = {}
    for what, init, make_step, arrays in cases:
        first = init()
        dtype = next(first.parameters()).dtype
        runs = []
        for d in (dev, cpu):
            params = copy.deepcopy(first).to(d)
            _, _, hist = train_loop(
                make_step(d), params,
                lambda s, d=d: {k: torch.from_numpy(v).to(d)
                                for k, v in arrays(s).items()},
                TrainLoopConfig(total_steps=TRAIN_CHECK_STEPS))
            runs.append((hist, params))
        (card_hist, card), (cpu_hist, on_cpu) = runs
        out[what] = _same_training(f"{what} card vs CPU", card_hist,
                                   cpu_hist, card, on_cpu, dtype, first)

    # kill -> resume through checkpoint_dir, on the card
    ckpt = ROOT / "build" / "train_checkpoints"
    what, init, make_step, arrays = cases[0]
    first = init()

    def batches(s):
        return {k: torch.from_numpy(v).to(dev) for k, v in arrays(s).items()}

    class Killed(BaseException):
        pass

    step = make_step(dev)

    def dying(p, o, b):
        if int(o["step"]) == TRAIN_KILL_AT:
            raise Killed
        return step(p, o, b)

    whole = copy.deepcopy(first).to(dev)
    _, _, whole_hist = train_loop(step, whole, batches, TrainLoopConfig(
        total_steps=TRAIN_RESUME_STEPS))
    shutil.rmtree(ckpt, ignore_errors=True)
    loop = TrainLoopConfig(total_steps=TRAIN_RESUME_STEPS,
                           checkpoint_every=TRAIN_KILL_AT // 2,
                           checkpoint_dir=str(ckpt))
    try:
        train_loop(dying, copy.deepcopy(first).to(dev), batches, loop)
        raise AssertionError("train kill: the run was not killed")
    except Killed:
        pass
    saved = latest_step(ckpt)
    t0 = time.perf_counter()
    resumed = copy.deepcopy(first).to(dev)
    _, _, tail = train_loop(step, resumed, batches, loop)
    resume_s = time.perf_counter() - t0
    if saved != TRAIN_KILL_AT - 1 or tail[0]["step"] != saved + 1:
        raise AssertionError(f"train kill: checkpoint at {saved}, resumed "
                             f"at {tail[0]['step']}")
    out["kill_resume"] = _same_training(
        f"{what} killed after step {TRAIN_KILL_AT - 1}, resumed", tail,
        whole_hist[saved + 1:], resumed, whole, torch.float32, first)
    out["kill_resume"].update(checkpoint_step=saved, resume_seconds=resume_s)
    shutil.rmtree(ckpt, ignore_errors=True)
    return out


def train_phase(dev) -> dict:
    """Phase 8: training on the card.  Returns the record."""
    record = dict(dlrm=_dlrm_train(dev), lm=_lm_train(dev),
                  reduced=_reduced_runs(dev))
    free_device_memory()
    return record


# ---------------------------------------------------------------------------
# 9. the MoE LMs; 10. the GNNs
# ---------------------------------------------------------------------------
def moe_attention_rows(dev, flush) -> list:
    """K4 at the MoE prefill shapes (B, S of MOE_SERVE; each arch's head
    groups), against ``blocked_attention`` (the plain version on the LM
    path) and SDPA with ``enable_gqa``."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.layers import blocked_attention
    gen = torch.Generator(device=dev).manual_seed(24)
    b, s = MOE_SERVE["batch"], MOE_SERVE["prompt_len"]
    rows = []
    for arch, hq, hkv in MOE_ATTN:
        q = torch.randn((b, hq, s, MOE_D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = [torch.randn((b, hkv, s, MOE_D), generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2)]
        kernel = lambda: flash_attention(q, k, v, causal=True)
        plain = lambda: blocked_attention(q, k, v, causal=True)
        mask = causal_lower_right(s, s)
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
        got, want, lib_out = kernel(), plain(), library()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {arch}: non-finite")
        tol = ATTN_TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), want.float(), **tol)
        torch.testing.assert_close(lib_out.float(), want.float(), **tol)
        err = float((got.float() - want.float()).abs().max())
        moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        pairs = b * _visible_pairs(s, s, True)
        rows.append(_row(
            f"flash_attention[bf16,causal,B={b},Hq={hq},Hkv={hkv},Sq={s},"
            f"Sk={s},D={MOE_D}] ({arch} prefill)", "flash_attention", err,
            time_ms(kernel, flush), time_ms(plain, flush),
            time_ms(library, flush), moved, 4 * hq * pairs * MOE_D,
            BF16_OPS_PER_S, arch=arch, sq=s, sk=s, causal=True,
            window=None, visible_pairs=pairs, plain="blocked_attention",
            library_max_abs_err=float((lib_out.float() - want.float())
                                      .abs().max())))
        del q, k, v, got, want, lib_out
    return rows


def _profile_split(what: str, fn, ranges) -> dict:
    """One run of ``fn`` under ``torch.profiler``: the device busy ms,
    the idle share, and the device ms of the kernels launched inside
    each of ``ranges`` (``record_function`` names; a kernel is counted
    under the innermost of them that encloses its launch), the rest as
    ``other``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    split = {name: 0.0 for name in ranges}
    split["other"] = 0.0
    for e in events:
        kernels = getattr(e, "kernels", None) or []
        if e.device_type != torch.autograd.DeviceType.CPU or not kernels:
            continue
        owner, up = "other", e
        while up is not None:
            if up.name in split:
                owner = up.name
                break
            up = up.cpu_parent
        split[owner] += sum(k.duration for k in kernels) / 1e3
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    span = ((max(e.time_range.end for e in ops)
             - min(e.time_range.start for e in ops)) / 1e3) if ops else 0.0
    rec = dict(device_busy_ms=busy, device_span_ms=span,
               idle_share=(1 - busy / span) if span else None,
               ops=len(ops), split_ms=split,
               attributed_ms=sum(split.values()))
    log(f"profile {what}: device_busy_ms={busy:.4f} span_ms={span:.4f} "
        f"idle_share={rec['idle_share']} split_ms "
        + json.dumps({k: round(v, 4) for k, v in split.items()}))
    return rec


def _routing_flips(a: list, b: list) -> float:
    """The share of (token, layer) whose set of experts differs between
    two runs' routings (``moe_apply``'s, one entry per layer)."""
    differ = total = 0
    for ra, rb in zip(a, b):
        ea = ra["expert_idx"].cpu().sort(dim=-1).values
        eb = rb["expert_idx"].cpu().sort(dim=-1).values
        differ += int((ea != eb).any(dim=-1).sum())
        total += ea[..., 0].numel()
    return differ / total


def _moe_serve(dev, name: str) -> tuple:
    """(a)-(c) of phase 9 for one MoE: returns (record, K4 launches)."""
    import dataclasses as dc
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.lm_demo import serve
    from repro_torch.models.moe import STAGES, init_moe_lm, moe_prefill
    full = get_arch(name).cfg
    cfg = dc.replace(full, n_layers=MOE_LAYERS[name])
    t0 = time.perf_counter()
    params = init_moe_lm(cfg, torch.Generator(dev).manual_seed(MOE_SEED), dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    log(f"moe {name}: full width, {cfg.n_layers} of {full.n_layers} layers "
        f"(depth the only cut), {cfg.n_params} parameters "
        f"({cfg.n_active_params} active), {n_bytes} bytes, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    flash_attention.launches = 0
    served = serve(cfg, params, device=dev, **MOE_SERVE)
    launches = flash_attention.launches
    log(f"moe launches: {json.dumps({'flash_attention': launches})}")
    if served["k4_launches"] != cfg.n_layers or launches != 2 * cfg.n_layers:
        raise AssertionError(f"moe {name}: {served['k4_launches']} K4 "
                             f"launches in the timed prefill, {launches} in "
                             f"all, {cfg.n_layers} layers")
    if not torch.isfinite(served["last_logits"]).all():
        raise AssertionError(f"moe {name}: non-finite logits")
    rec = {k: served[k] for k in (
        "batch", "prompt_len", "gen", "prefill_ms", "decode_ms_per_token",
        "k4_launches", "peak_bytes", "dropped_share")}
    rec.update(layers=f"{cfg.n_layers} of {full.n_layers}",
               n_params=cfg.n_params, n_active_params=cfg.n_active_params,
               param_bytes=n_bytes,
               token_ids=served["token_ids"][:, :8].tolist())
    log(f"moe {name}: prefill_ms={rec['prefill_ms']:.4f} "
        f"decode_ms_per_token={rec['decode_ms_per_token']:.4f} "
        f"dropped_share={rec['dropped_share']} "
        f"peak={(rec['peak_bytes'] or 0) / 1e9:.3f} GB")
    got, served_routing = served["prefill_logits"], served["routing"]
    del served
    free_device_memory()

    # (b) the served prefill (K4) against blocked_attention, same prompt
    b, s = MOE_SERVE["batch"], MOE_SERVE["prompt_len"]
    prompt = lm_batch(0, b, s, cfg.vocab)["tokens"]
    plain_routing = []
    want, _ = moe_prefill(cfg, params, prompt, impl="plain", device=dev,
                          routing=plain_routing)
    rec["routing_flip_share"] = _routing_flips(served_routing, plain_routing)
    log(f"moe {name}: (token, layer) pairs whose experts differ between "
        f"K4 and blocked_attention: {rec['routing_flip_share']}")
    rec["k4_vs_plain"] = _lm_check(
        f"{name} served prefill K4 vs blocked_attention B={b} S={s}", got,
        want, MOE_LOGIT_TOL)
    del got, want, served_routing, plain_routing
    free_device_memory()
    # (c) one profiled prefill: attention, routing, dispatch, the grouped
    # GEMM, combine
    rec["profile_prefill"] = _profile_split(
        f"moe {name} prefill", lambda: moe_prefill(cfg, params, prompt,
                                                   device=dev),
        ("moe.attention",) + STAGES)
    del params
    free_device_memory()
    return rec, launches


def _moe_reckoning(cfg, batch: int, seq: int, micro: int) -> dict:
    """Bytes the MoE train step holds before activations: bf16 params
    and a microbatch's bf16 grads, f32 moments, f32 accumulators when
    ``micro`` > 1, AdamW's two scratch buffers (the largest leaf in f32,
    twice); and the dispatch buffer of one microbatch."""
    n = cfg.n_params + cfg.n_layers * 3 * cfg.d_model + cfg.d_model
    largest = max(cfg.n_experts * cfg.d_model * cfg.d_ff,
                  cfg.vocab * cfg.d_model)
    held = dict(params=2 * n, grads=2 * n, moments=8 * n,
                accumulators=4 * n if micro > 1 else 0,
                scratch=2 * 4 * largest)
    tk = batch // micro * seq * cfg.top_k
    cap = -(-tk // cfg.n_experts) * cfg.capacity_factor
    held["dispatch_buffer_per_layer"] = int(2 * cfg.n_experts * cap
                                            * cfg.d_model)
    held["total_before_activations"] = sum(
        held[k] for k in ("params", "grads", "moments", "accumulators",
                          "scratch"))
    return held


def _moe_train(dev) -> dict:
    """(d) qwen3-moe at full width and MOE_TRAIN_LAYERS layers."""
    import dataclasses as dc
    from repro_torch.configs import qwen3_moe_235b_a22b as qwen
    from repro_torch.configs.base import lm_train_step
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.moe import init_moe_lm, moe_train_forward
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoopConfig, train_loop
    cfg = dc.replace(qwen.CFG, n_layers=MOE_TRAIN_LAYERS)
    b, s, mb = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_MICRO
    held = _moe_reckoning(cfg, b, s, mb)
    log(f"train {cfg.name}: full width, {cfg.n_layers} of "
        f"{qwen.CFG.n_layers} layers, B={b} as {mb} microbatches, S={s}, "
        f"remat={cfg.remat}; reckoned bytes {json.dumps(held)}")
    params = init_moe_lm(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED),
                         dev)
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats(dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(0, b, s, cfg.vocab).items()}
    step = lm_train_step(cfg, b, s, microbatches=mb, device=dev,
                         forward=moe_train_forward)
    flash_attention.launches = 0
    _, _, hist = train_loop(step, params, lambda i: batch,
                            TrainLoopConfig(total_steps=1 + MOE_TRAIN_TIMED),
                            opt_state=opt)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    rec = _timed_rows(hist, MOE_TRAIN_TIMED, cfg.name)
    tokens = b * s
    pairs = b * sum(range(1, s + 1))
    flops = 6 * cfg.n_active_params * tokens + 12 * cfg.n_layers \
        * cfg.n_heads * cfg.d_head * pairs
    rec.update(n_params=cfg.n_params, n_active_params=cfg.n_active_params,
               tokens=tokens, peak_bytes=peak, reckoned=held,
               tokens_per_s=tokens / (rec["ms"] / 1e3), model_flops=flops,
               mfu=flops / (rec["ms"] / 1e3) / BF16_FLOPS_PER_S,
               k4_launches=flash_attention.launches)
    log(f"train {cfg.name}: ms/step={rec['ms']:.4f} tokens/s="
        f"{rec['tokens_per_s']:.1f} model_flops={flops:.6e} (6*N_active*"
        f"tokens + 12*L*H*dh*visible pairs) mfu={rec['mfu']:.4f} of "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s peak={peak / 1e9:.3f} GB "
        f"K4 launches={flash_attention.launches}")
    timed = rec["losses"][-MOE_TRAIN_TIMED:]
    if not timed[-1] < timed[0]:
        raise AssertionError(f"train {cfg.name}: the loss did not fall over "
                             f"the timed steps: {rec['losses']}")
    rec["profile"] = profile_request(f"train {cfg.name} step",
                                     lambda: step(params, opt, batch))
    if flash_attention.launches or _kernel_ops(rec["profile"]):
        raise AssertionError(f"train {cfg.name}: K4 launched in training")
    del params, opt, batch, step
    free_device_memory()
    return rec


def _logits_close(what: str, got, want, tol: float, argmax: bool) -> float:
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    log(f"moe {what}: max_abs_err={err} tol={tol}")
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"moe {what}: logits differ by {err}, tol {tol}")
    if argmax and not torch.equal(got.argmax(-1).cpu(),
                                  want.argmax(-1).cpu()):
        raise AssertionError(f"moe {what}: argmax differs")
    return err


def _moe_reduced(dev) -> dict:
    """(e) the reduced MoEs, card against CPU from the same parameters:
    prefill (routing equal in f32), 4 teacher-forced decode steps and
    TRAIN_CHECK_STEPS train steps (TRAIN_TOL; bf16 MOE_BF16_TRAIN_TOL)."""
    import copy
    import dataclasses as dc
    from repro_torch.configs.base import lm_train_step
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.moe import (init_moe_lm, moe_decode_step,
                                        moe_prefill, moe_train_forward)
    from repro_torch.train import TrainLoopConfig, train_loop
    cpu = torch.device("cpu")
    out = {}
    for name in MOE_LAYERS:
        for dt in ("float32", "bfloat16"):
            cfg = dc.replace(get_arch(name).reduced_cfg, param_dtype=dt)
            what = f"{name}-reduced {dt}"
            f32 = dt == "float32"
            first = init_moe_lm(cfg, torch.Generator().manual_seed(
                TRAIN_SEED), cpu)
            card = copy.deepcopy(first).to(dev)
            toks = lm_batch(2, 2, 36, cfg.vocab)["tokens"]
            rc, rg = [], []
            lc, cc = moe_prefill(cfg, first, toks[:, :32], device=cpu,
                                 routing=rc)
            lg, cg = moe_prefill(cfg, card, toks[:, :32], device=dev,
                                 routing=rg)
            tol = 1e-4 if f32 else LM_LOGIT_TOL
            rec = dict(prefill=_logits_close(f"{what} prefill card vs CPU",
                                             lg, lc, tol, f32))
            if f32:
                for i, (a, b) in enumerate(zip(rg, rc)):
                    if not (torch.equal(a["expert_idx"].cpu(),
                                        b["expert_idx"])
                            and torch.equal(a["keep"].cpu(), b["keep"])):
                        raise AssertionError(f"moe {what}: layer {i} routes "
                                             "otherwise on the card")
            rec["routing_flip_share"] = _routing_flips(rg, rc)
            shape = (cfg.n_layers, 2, cfg.n_kv_heads, 36, cfg.d_head)
            caches = []
            for d, c in ((cpu, cc), (dev, cg)):
                kc = torch.zeros(shape, dtype=cfg.dtype, device=d)
                vc = torch.zeros_like(kc)
                kc[:, :, :, :32], vc[:, :, :, :32] = c
                caches.append((kc, vc))
            errs = []
            for i in range(4):
                tok = toks[:, 32 + i:33 + i]
                dc_, _ = moe_decode_step(cfg, first, tok, caches[0], 32 + i,
                                         device=cpu)
                dg, _ = moe_decode_step(cfg, card, tok, caches[1], 32 + i,
                                        device=dev)
                errs.append(_logits_close(f"{what} decode {i} card vs CPU",
                                          dg[:, 0], dc_[:, 0], tol, f32))
            rec["decode"] = max(errs)
            runs = []
            for d in (dev, cpu):
                params = copy.deepcopy(first).to(d)
                _, _, hist = train_loop(
                    lm_train_step(cfg, 4, 32, microbatches=2, device=d,
                                  forward=moe_train_forward), params,
                    lambda s, d=d: {k: torch.from_numpy(v).to(d) for k, v
                                    in lm_batch(s, 4, 32, cfg.vocab).items()},
                    TrainLoopConfig(total_steps=TRAIN_CHECK_STEPS))
                runs.append((hist, params))
            (ch, cp), (wh, wp) = runs
            rec["train"] = _same_training(
                f"{what} card vs CPU", ch, wh, cp, wp, cfg.dtype, first,
                None if f32 else MOE_BF16_TRAIN_TOL)
            out[what] = rec
    return out


def moe_phase(dev) -> tuple:
    """Phase 9: the MoE LMs.  Returns (record, K4 launches per arch)."""
    record, launches = {}, {}
    for name in MOE_LAYERS:
        record[name], launches[name] = _moe_serve(dev, name)
    record["train"] = _moe_train(dev)
    record["reduced"] = _moe_reduced(dev)
    free_device_memory()
    return record, launches


def _molecules(n_graphs: int, seed: int) -> dict:
    """``n_graphs`` molecules of MOLECULE["atoms"] atoms each (positions
    N(0, 1.5^2) Å, species 1..9) with MOLECULE["edges"] directed edges
    each between distinct atoms of the molecule; the GNN_SHAPES molecule
    cell at 128 graphs: 3,840 atoms, 16,384 edges."""
    rng = np.random.default_rng(seed)
    a, m = MOLECULE["atoms"], MOLECULE["edges"]
    n = n_graphs * a
    src = rng.integers(0, a, (n_graphs, m))
    dst = (src + rng.integers(1, a, (n_graphs, m))) % a
    off = (np.arange(n_graphs) * a)[:, None]
    return {"species": rng.integers(1, 10, n).astype(np.int32),
            "positions": (rng.standard_normal((n, 3)) * 1.5)
            .astype(np.float32),
            "src": (src + off).reshape(-1).astype(np.int32),
            "dst": (dst + off).reshape(-1).astype(np.int32),
            "graph_ids": np.repeat(np.arange(n_graphs), a).astype(np.int32),
            "energy": rng.standard_normal(n_graphs).astype(np.float32)}


def _sampled_tree(dims: dict):
    """The ``minibatch_lg`` shape as a GraphSAGE computation tree: 1,024
    seeds of a ``powerlaw_graph`` of the shape's node count, 10 sampled
    in-neighbours each (``NeighborSampler.sample_hop``), 15 of each of
    those; nodes numbered seeds, then hop 1, then hop 2, edges from a
    sampled node to the node that sampled it: exactly the shape's
    164,864 nodes and 163,840 edges."""
    from repro_torch.graph import Graph, NeighborSampler, powerlaw_graph
    n = dims["n_nodes"]
    base = powerlaw_graph(n, dims["n_edges"] // 2, alpha=1.0, seed=GNN_SEED,
                          block_size=1024)
    sampler = NeighborSampler(base, MINIBATCH_FANOUTS, seed=GNN_SEED)
    seeds = np.random.default_rng(GNN_SEED).choice(
        n, MINIBATCH_SEEDS, replace=False)
    hop1 = sampler.sample_hop(seeds, MINIBATCH_FANOUTS[0])
    hop2 = sampler.sample_hop(hop1.src_global, MINIBATCH_FANOUTS[1])
    if not (hop1.edge_mask.all() and hop2.edge_mask.all()):
        raise AssertionError("minibatch_lg: a sampled node has no in-edge")
    n1 = len(seeds)
    n2 = n1 + len(hop1.src_global)
    src = np.concatenate([n1 + np.arange(len(hop1.src_global)),
                          n2 + np.arange(len(hop2.src_global))])
    dst = np.concatenate([hop1.dst_local, n1 + hop2.dst_local])
    tree = Graph.from_coo(src, dst, n2 + len(hop2.src_global),
                          block_size=1024)
    if (tree.n_nodes, tree.n_edges) != (n, dims["n_edges"]):
        raise AssertionError(f"minibatch_lg: {tree.n_nodes} nodes, "
                             f"{tree.n_edges} edges")
    return tree


def _gnn_inputs(name: str, shape: str, cfg) -> dict:
    """The batch of one GNN cell as numpy arrays: ``full_graph_sm`` a
    ``powerlaw_graph`` of the shape's nodes and, symmetrized, about its
    edges; ``minibatch_lg`` the sampled tree; ``molecule`` the
    molecules."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.synthetic import gnn_batch
    from repro_torch.graph import powerlaw_graph
    dims = GNN_SHAPES[shape]
    if shape == "molecule":
        return _molecules(dims["n_graphs"], GNN_SEED)
    if shape == "minibatch_lg":
        g = _sampled_tree(dims)
    else:
        g = powerlaw_graph(dims["n_nodes"], dims["n_edges"] // 2, alpha=1.0,
                           seed=GNN_SEED, block_size=1024)
    if name == "pna":
        return gnn_batch(0, g, cfg.d_in, cfg.n_classes, seed=GNN_SEED)
    rng = np.random.default_rng(GNN_SEED)
    n, e = g.n_nodes, g.n_edges
    return {"src": np.asarray(g.src, np.int32),
            "dst": np.asarray(g.dst, np.int32),
            "node_feat": rng.standard_normal((n, cfg.d_node_in))
            .astype(np.float32),
            "edge_feat": rng.standard_normal((e, cfg.d_edge_in))
            .astype(np.float32),
            "target": rng.standard_normal((n, cfg.d_out)).astype(np.float32)}


def _gnn_train(dev, name: str, shape: str, cfg=None, params=None,
               profile: bool = True) -> tuple:
    """1 untimed + GNN_TIMED steps of one GNN cell on one repeated batch
    (AdamW at lr 1e-3); returns (record, the parameters after)."""
    from repro_torch.configs.base import loss_train_step
    from repro_torch.configs.registry import get_arch
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoopConfig, train_loop
    arch = get_arch(name)
    cfg = cfg or arch.cfg_for(shape)
    arrays = _gnn_inputs(name, shape, cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    if params is None:
        params = arch.init_params(
            cfg, torch.Generator(dev).manual_seed(GNN_SEED), dev)
    opt = adamw_init(params)
    step = loss_train_step(cfg, arch.loss, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, hist = train_loop(step, params, lambda i: batch,
                            TrainLoopConfig(total_steps=1 + GNN_TIMED),
                            opt_state=opt)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    what = f"{name} {shape} {cfg.sys.name}"
    rec = _timed_rows(hist, GNN_TIMED, what)
    timed = rec["losses"][-GNN_TIMED:]
    rec.update(nodes=len(arrays["species"] if shape == "molecule"
                         else arrays["node_feat"]), edges=len(arrays["src"]),
               n_params=sum(p.numel() for p in params.parameters()),
               peak_bytes=peak, config=cfg.sys.name,
               loss_fell=bool(timed[-1] < timed[0]))
    log(f"gnn {what}: ms/step={rec['ms']:.4f} peak={peak / 1e9:.3f} GB "
        f"edges={rec['edges']} params={rec['n_params']} "
        f"loss_fell={rec['loss_fell']}")
    if profile:
        rec["profile"] = profile_request(f"gnn {what} step",
                                         lambda: step(params, opt, batch))
    del opt, batch
    return rec, params


def _gnn_reduced(dev) -> dict:
    """The reduced GNNs: TRAIN_CHECK_STEPS steps on the card against the
    CPU from the same parameters, on ``launch.train``'s batches, at
    TRAIN_TOL (EquiformerV2 at its bf16 row: its edge tensors are
    bf16)."""
    import copy
    from repro_torch.configs.base import loss_train_step
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import _gnn_arrays
    from repro_torch.train import TrainLoopConfig, train_loop
    cpu = torch.device("cpu")
    out = {}
    for name in GNN_MODELS:
        arch = get_arch(name)
        cfg = arch.reduced_cfg
        first = arch.init_params(cfg, torch.Generator().manual_seed(
            TRAIN_SEED), cpu)
        runs = []
        for d in (dev, cpu):
            arrays = _gnn_arrays(arch, cfg)
            params = copy.deepcopy(first).to(d)
            _, _, hist = train_loop(
                loss_train_step(cfg, arch.loss, device=d), params,
                lambda s, d=d, arrays=arrays: {
                    k: torch.from_numpy(v).to(d)
                    for k, v in arrays(s).items()},
                TrainLoopConfig(total_steps=TRAIN_CHECK_STEPS))
            runs.append((hist, params))
        (ch, cp), (wh, wp) = runs
        dtype = torch.bfloat16 if name == "equiformer-v2" else torch.float32
        out[name] = _same_training(f"{name}-reduced card vs CPU", ch, wh, cp,
                                   wp, dtype, first)
    return out


def _equiformer_invariance(dev) -> float:
    """``tests/test_models.py::test_equiformer_rotation_invariance`` on
    the card: the reduced EquiformerV2's energies of a rotated molecule
    within 5e-3 of the original's (relative to the largest)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.gnn.equiformer_v2 import (equiformer_forward,
                                                      init_equiformer)
    cfg = get_arch("equiformer-v2").reduced_cfg
    params = init_equiformer(cfg, torch.Generator(dev).manual_seed(0), dev)
    rng = np.random.default_rng(1)
    n, e, g = 48, 128, cfg.n_graphs
    batch = {"species": rng.integers(0, 10, n).astype(np.int32),
             "positions": rng.standard_normal((n, 3)).astype(np.float32) * 2,
             "src": rng.integers(0, n, e).astype(np.int32),
             "dst": rng.integers(0, n, e).astype(np.int32),
             "graph_ids": (np.arange(n) % g).astype(np.int32)}
    rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    if np.linalg.det(rot) < 0:
        rot[:, 0] *= -1
    with torch.no_grad():
        e1 = equiformer_forward(cfg, params, batch, device=dev)
        e2 = equiformer_forward(cfg, params, dict(
            batch, positions=batch["positions"] @ rot.T.astype(np.float32)),
            device=dev)
    rel = float((e1 - e2).abs().max() / (e1.abs().max() + 1e-9))
    log(f"gnn equiformer-v2 rotation invariance on the card: rel={rel} "
        "(limit 5e-3)")
    if not rel < 5e-3:
        raise AssertionError(f"equiformer rotation invariance: {rel}")
    return rel


def gnn_phase(dev) -> dict:
    """Phase 10: the GNNs train.  Returns the record."""
    import copy
    import dataclasses as dc
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.gnn.common import GNN_CONFIGS
    record = {"cells": {}}
    ogb = GNN_SHAPES["ogb_products"]
    h = get_arch("pna").cfg_for("ogb_products").d_hidden
    record["ogb_products_reckoned"] = dict(
        edges=ogb["n_edges"], first_edge_mlp_input_bytes=ogb["n_edges"]
        * 2 * h * 4)
    log(f"gnn ogb_products: not run; PNA's first edge-MLP input alone is "
        f"[{ogb['n_edges']}, {2 * h}] f32 = "
        f"{ogb['n_edges'] * 2 * h * 4 / 1e9:.1f} GB before the backward "
        "keeps it (phase 11's dry run holds it on 256 ranks)")
    for name, shape in GNN_CELLS:
        rec, params = _gnn_train(dev, name, shape)
        record["cells"][f"{name}/{shape}"] = rec
        del params
        free_device_memory()
    # PNA at minibatch_lg under each coherence x consistency config, from
    # the same parameters
    name, shape = GNN_CONFIG_CELL
    arch = get_arch(name)
    base_cfg = arch.cfg_for(shape)
    first = arch.init_params(base_cfg, torch.Generator(dev).manual_seed(
        GNN_SEED), dev)
    configs = {}
    for sc in GNN_CONFIGS:
        cfg = dc.replace(base_cfg, sys=sc)
        configs[sc.name], params = _gnn_train(
            dev, name, shape, cfg=cfg, params=copy.deepcopy(first),
            profile=False)
        del params
    ref = configs["SG0"]["losses"]
    for c, rec in configs.items():
        rec["max_loss_diff_vs_SG0"] = max(abs(a - b) for a, b in
                                         zip(rec["losses"], ref))
    log("gnn pna minibatch_lg configs: " + " ".join(
        f"{c}={r['ms']:.4f}ms/dloss={r['max_loss_diff_vs_SG0']:.3e}"
        for c, r in configs.items()))
    record["pna_configs"] = configs
    del first
    free_device_memory()
    record["equiformer_rotation_rel"] = _equiformer_invariance(dev)
    record["reduced"] = _gnn_reduced(dev)
    free_device_memory()
    return record


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _sharded_copy(module, mesh, specs):
    """A copy of ``module`` whose parameters are DTensors on ``mesh``."""
    import copy
    from repro_torch.configs.base import distribute_params
    return distribute_params(copy.deepcopy(module), mesh, specs)


def _timed_host_ms(fn, n: int) -> float:
    """Median wall ms of ``n`` calls of ``fn``, each synchronized."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _shard_lm_prefill(dev, mesh, ax) -> tuple:
    """(a) starcoder2-7b's prefill through DTensor parameters, K4 in
    ``local_map``; returns (record, K4 launches of the sharded run)."""
    import dataclasses as dc
    from repro_torch.configs.base import distribute_tree, lm_param_sharding
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as T
    from repro_torch.models.mesh_compat import use_mesh
    cfg = dc.replace(get_arch("starcoder2-7b", axes=ax).cfg,
                     n_layers=SHARD_LM_LAYERS)
    plain = dc.replace(cfg, dp_axes=(), tp_axis=None, sp_axis=None)
    params = T.init_lm(plain, torch.Generator(dev).manual_seed(SHARD_SEED),
                       dev)
    sharded = _sharded_copy(params, mesh, lm_param_sharding(cfg, ax))
    tokens = torch.from_numpy(lm_batch(0, SHARD_LM["batch"], SHARD_LM["seq"],
                                       cfg.vocab)["tokens"]).to(dev)
    dtok = distribute_tree({"t": tokens}, mesh,
                           {"t": (ax.dp, None)})["t"]
    want, _ = T.prefill(plain, params, tokens, device=dev)
    flash_attention.launches = 0
    with use_mesh(mesh):
        got, _ = T.prefill(cfg, sharded, dtok, device=dev)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    got = got.full_tensor()
    equal = bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max())
    log(f"shard lm: {cfg.name} {cfg.n_layers} layers, B={SHARD_LM['batch']}"
        f" S={SHARD_LM['seq']} on a {tuple(mesh.shape)} mesh: K4 launches="
        f"{launches} logits bit-equal={equal} max_abs_err={err}")
    if launches != cfg.n_layers:
        raise AssertionError(f"shard lm: {launches} K4 launches for "
                             f"{cfg.n_layers} layers")
    if not equal:
        # DTensor's dispatch picked another ATen op somewhere: hold the
        # logits to phase 7's bound
        _lm_check("shard prefill vs unsharded", got, want, LM_LOGIT_TOL)
    plain_ms = _timed_host_ms(
        lambda: T.prefill(plain, params, tokens, device=dev), SHARD_LM_TIMED)

    def sharded_run():
        with use_mesh(mesh):
            T.prefill(cfg, sharded, dtok, device=dev)
    shard_ms = _timed_host_ms(sharded_run, SHARD_LM_TIMED)
    per_layer = (shard_ms - plain_ms) / cfg.n_layers
    log(f"shard lm: prefill ms unsharded={plain_ms:.3f} sharded="
        f"{shard_ms:.3f}: the DTensor path adds {per_layer:.3f} ms a layer")
    rec = dict(layers=cfg.n_layers, k4_launches=launches, bit_equal=equal,
               max_abs_err=err, plain_ms=plain_ms, sharded_ms=shard_ms,
               dtensor_ms_per_layer=per_layer)
    del params, sharded, got, want
    free_device_memory()
    return rec, launches


def _shard_moe(dev, mesh, ax) -> dict:
    """(b) qwen3-moe's prefill with its groups in ``local_map``."""
    import dataclasses as dc
    from repro_torch.configs.base import distribute_tree, lm_param_sharding
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import moe as M
    from repro_torch.models.mesh_compat import use_mesh
    arch = get_arch("qwen3-moe-235b-a22b", axes=ax)
    cfg = dc.replace(arch.cfg, n_layers=1,
                     dispatch_groups=SHARD_MOE["groups"])
    plain = dc.replace(cfg, dp_axes=(), tp_axis=None, sp_axis=None)
    params = M.init_moe_lm(plain,
                           torch.Generator(dev).manual_seed(SHARD_SEED), dev)
    sharded = _sharded_copy(params, mesh,
                            lm_param_sharding(cfg, ax, cfg.moe_mode))
    tokens = torch.from_numpy(lm_batch(1, SHARD_MOE["batch"],
                                       SHARD_MOE["seq"],
                                       cfg.vocab)["tokens"]).to(dev)
    dtok = distribute_tree({"t": tokens}, mesh, {"t": (ax.dp, None)})["t"]
    want_r, got_r = [], []
    want, _ = M.moe_prefill(plain, params, tokens, device=dev,
                            routing=want_r)
    flash_attention.launches = 0
    with use_mesh(mesh):
        got, _ = M.moe_prefill(cfg, sharded, dtok, device=dev,
                               routing=got_r)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    same = all(torch.equal(g[k].full_tensor(), w[k])
               for g, w in zip(got_r, want_r) for k in ("expert_idx", "keep"))
    kept = float(want_r[0]["keep"].float().mean())
    err = _logits_close("shard prefill vs unsharded", got.full_tensor(),
                        want, MOE_LOGIT_TOL, argmax=False)
    log(f"shard moe: {cfg.name} 1 layer, B={SHARD_MOE['batch']} S="
        f"{SHARD_MOE['seq']}, {cfg.dispatch_groups} groups in local_map: "
        f"routing and keep equal={same} (kept {kept:.4f}), K4 launches="
        f"{launches}")
    if not same or launches != 1:
        raise AssertionError(f"shard moe: routing equal {same}, {launches} "
                             "K4 launches")
    del params, sharded
    free_device_memory()
    return dict(groups=cfg.dispatch_groups, routing_equal=same,
                kept_share=kept, max_abs_err=err, k4_launches=launches)


def _shard_train(dev, mesh, ax) -> tuple:
    """(c) one starcoder2-7b train step through DTensor parameters;
    returns (record, the unsharded step's gradients' model)."""
    import dataclasses as dc
    from repro_torch.configs.base import (distribute_tree, lm_param_sharding,
                                          lm_train_step)
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.mesh_compat import use_mesh
    from repro_torch.optim import adamw_init
    cfg = dc.replace(get_arch("starcoder2-7b", axes=ax).cfg,
                     n_layers=SHARD_TRAIN_LAYERS)
    plain = dc.replace(cfg, dp_axes=(), tp_axis=None, sp_axis=None)
    b, s, mb = SHARD_TRAIN["batch"], SHARD_TRAIN["seq"], SHARD_TRAIN["micro"]
    params = T.init_lm(plain, torch.Generator(dev).manual_seed(SHARD_SEED),
                       dev)
    sharded = _sharded_copy(params, mesh, lm_param_sharding(cfg, ax))
    start = {n: p.detach().float().clone()
             for n, p in params.named_parameters()}
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(0, b, s, cfg.vocab).items()}
    dbatch = distribute_tree(batch, mesh, {"tokens": (ax.dp, None),
                                           "labels": (ax.dp, None)})
    _, _, want = lm_train_step(plain, b, s, mb, device=dev)(
        params, adamw_init(params), batch)
    with use_mesh(mesh):
        _, _, got = lm_train_step(cfg, b, s, mb, device=dev)(
            sharded, adamw_init(sharded), dbatch)
    torch.cuda.synchronize()
    tol = TRAIN_TOL[cfg.dtype]
    worst = 0.0
    for (n, a), (_, w) in zip(sharded.named_parameters(),
                              params.named_parameters()):
        a, w = a.detach().full_tensor().float(), w.detach()
        worst = max(worst, float((a - w.float()).abs().max()))
        torch.testing.assert_close(a, w.float(), **tol["params"],
                                   msg=lambda m, n=n: f"shard train {n}: {m}")
    moved = max(float((w.float() - start[n]).abs().max())
                for n, w in params.named_parameters())
    loss = [float(got["loss"]), float(want["loss"])]
    gn = [float(got["grad_norm"]), float(want["grad_norm"])]
    log(f"shard train: {cfg.name} {cfg.n_layers} layers, B={b} as {mb} "
        f"microbatches, S={s}: loss sharded/unsharded={loss} grad_norm="
        f"{gn} max param diff={worst} (largest move {moved})")
    torch.testing.assert_close(*map(torch.tensor, loss), **tol["loss"])
    torch.testing.assert_close(*map(torch.tensor, gn), **tol["grad_norm"])
    del sharded
    free_device_memory()
    return dict(layers=cfg.n_layers, loss=loss, grad_norm=gn,
                max_param_diff=worst, largest_move=moved), (plain, params,
                                                             batch)


def _shard_pieces(dev, mesh, ax, lm) -> dict:
    """(d) ``CompressedReducer`` over NCCL, ``ElasticMesh``, and a DTensor
    checkpoint restored with ``shardings=``."""
    from repro_torch.configs.base import (lm_param_sharding, trainable,
                                          value_and_grad)
    from repro_torch.models import transformer as T
    from repro_torch.optim.compression import (CompressedReducer,
                                               all_reduce_mean)
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.fault_tolerance import ElasticMesh
    cfg, params, batch = lm
    leaves = trainable(params)
    _, grads = value_and_grad(
        lambda: T.train_forward(cfg, params, batch, device=dev), leaves)
    for p in leaves.values():
        p.requires_grad_(False)
    cr = CompressedReducer(torch.bfloat16)
    state = cr.init_state(grads)
    for _ in range(2):   # two rounds: the second adds the residual back
        card_out, state_next = cr.reduce(grads, state, all_reduce_mean())
        cpu_out, cpu_state = cr.reduce(
            {k: g.cpu() for k, g in grads.items()},
            {k: r.cpu() for k, r in state.items()},
            lambda w: {k: v / 1 for k, v in w.items()})
        for k in grads:
            if not (torch.equal(card_out[k].cpu(), cpu_out[k])
                    and torch.equal(state_next[k].cpu(), cpu_state[k])):
                raise AssertionError(f"shard compression: {k} differs from "
                                     "the CPU's round")
        state = state_next
    nbytes = sum(g.numel() for g in grads.values())
    log(f"shard compression: 2 rounds over {len(grads)} gradients "
        f"({nbytes} values) with an NCCL all-reduce mean: wire and "
        f"residual bit-equal to the CPU's")
    em = ElasticMesh(model_parallel=1)
    mesh2 = em.build()
    specs = lm_param_sharding(cfg, ax)
    placed = em.reshard(params, mesh2, specs)
    ckpt = ROOT / "build" / "shard_checkpoint"
    if ckpt.exists():
        import shutil
        shutil.rmtree(ckpt)
    save_checkpoint(ckpt, 1, placed)
    fresh = T.init_lm(cfg.__class__(**{**dataclasses.asdict(cfg)}),
                      torch.Generator(dev).manual_seed(SHARD_SEED + 1), dev)
    restored, step, _ = restore_checkpoint(ckpt, fresh,
                                           shardings=(mesh2, specs))
    same = all(torch.equal(a.full_tensor(), b.full_tensor())
               for (_, a), (_, b) in zip(restored.named_parameters(),
                                         placed.named_parameters()))
    log(f"shard checkpoint: ElasticMesh {tuple(mesh2.shape)}, "
        f"{len(specs)} DTensor leaves saved whole and restored onto the "
        f"mesh with shardings=: bit-equal={same}")
    if not same or step != 1:
        raise AssertionError("shard checkpoint: the restore differs")
    return dict(compression_rounds=2, compressed_values=nbytes,
                elastic_mesh=list(mesh2.shape), checkpoint_bit_equal=same)


def _shard_dryrun(log_dir: Path) -> tuple:
    """(e) the dry run's cells, one process each, all started together;
    returns (records, wall seconds)."""
    out = log_dir / "dryrun_card"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = []
    for arch, shape, mesh in SHARD_DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(out)]
        if arch not in ("dlrm-mlperf", "pna"):
            cmd += ["--layers", str(SHARD_DRYRUN_LAYERS)]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
            stderr=open(out / f"{arch}__{shape}__{mesh}.log", "w")))
    for p in procs:
        p.wait()
    wall = time.perf_counter() - t0
    records = []
    for arch, shape, mesh in SHARD_DRYRUN_CELLS:
        name = f"{arch}__{shape}__{mesh}.json"
        rec = json.loads((out / name).read_text())
        if not rec.get("ok"):
            raise AssertionError(f"shard dryrun {name}: {rec.get('error')}")
        full = ROOT / "results" / "torch" / "dryrun" / name
        uncut = json.loads(full.read_text()) if full.exists() else {}
        coll = sum(v["bytes"] for v in rec["collectives"].values())
        log(f"shard dryrun {arch} {shape} {rec['mesh']} layers="
            f"{rec['layers']}: peak={rec['memory']['peak_bytes'] / 1e9:.3f} "
            f"GB/rank flops={rec['cost']['flops']:.4e}/rank collectives="
            f"{coll / 1e9:.3f} GB/rank step={rec['step_s']} s; uncut "
            f"(committed): peak={uncut.get('memory', {}).get('peak_bytes', 0) / 1e9:.3f}"
            f" GB/rank")
        records.append(dict(arch=arch, shape=shape, mesh=rec["mesh"],
                            layers=rec["layers"],
                            peak_bytes=rec["memory"]["peak_bytes"],
                            flops=rec["cost"]["flops"],
                            collective_bytes=coll, step_s=rec["step_s"]))
    log(f"shard dryrun: {len(records)} cells in {wall:.1f} s (one process "
        "each, all at once)")
    return records, wall, out


def _roofline_row(dryrun_dir, out) -> str:
    from repro_torch.benchmarks.roofline import analyze
    rows = analyze(dryrun_dir=dryrun_dir, out=out, mesh=None)
    worst = min(rows, key=lambda r: r["roofline_fraction"] or 1)
    return (f"roofline,{len(rows)},cells={len(rows)};worst_fraction="
            f"{worst['roofline_fraction']}@{worst['arch']}/{worst['shape']}")


def sharding_phase(dev, log_dir: Path) -> tuple:
    """Phase 11: the sharding pieces.  Returns (record, K4 launches of
    the sharded prefill)."""
    import torch.distributed as dist
    from repro_torch.configs.base import axes_for_mesh
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_local_mesh()
        ax = axes_for_mesh(mesh)
        log(f"shard: NCCL group of {dist.get_world_size()} rank, mesh "
            f"{mesh.mesh_dim_names} {tuple(mesh.shape)}, axes {ax}")
        record = {}
        record["prefill"], launches = _shard_lm_prefill(dev, mesh, ax)
        record["moe"] = _shard_moe(dev, mesh, ax)
        record["train"], lm = _shard_train(dev, mesh, ax)
        record["pieces"] = _shard_pieces(dev, mesh, ax, lm)
        del lm
        free_device_memory()
    finally:
        dist.destroy_process_group()
    record["dryrun"], record["dryrun_seconds"], out = _shard_dryrun(log_dir)
    rows = {"card": _roofline_row(out, out / "roofline.json"),
            "committed": _roofline_row(ROOT / "results" / "torch" / "dryrun",
                                       out / "roofline_committed.json")}
    for k, row in rows.items():
        log(f"shard roofline ({k} records): {row}")
    record["roofline"] = rows
    return record, launches


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


_ORACLES: dict = {}


def _oracles(graph) -> dict:
    """The numpy oracles of ``graph``'s exact and float apps, computed
    once per graph."""
    from repro_torch.algorithms import reference as ref
    if id(graph) not in _ORACLES:
        t0 = time.perf_counter()
        _ORACLES[id(graph)] = {
            "BFS": ref.bfs_np(graph), "SSSP": ref.sssp_np(graph),
            "PR": ref.pagerank_np(graph), "CC": ref.cc_np(graph),
            "BC": ref.bc_np(graph)}
        log(f"oracles: {time.perf_counter() - t0:.1f} s")
    return _ORACLES[id(graph)]


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

    oracles = _oracles(graph)
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


def dispatch_phase(graph, dev, log_dir: Path) -> dict:
    """The dispatch benchmark at its pinned workload, then the sweep of
    guarded steps per graph (K) on it and on the AMZ stand-in.  The
    benchmark runs in a process of its own, as the gate's other timed
    harnesses do: run inside this process on the H100, its geomean moved
    -26 to +35 % between runs, in a process of its own -10 to +11 %."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.benchmarks.dispatch import OUT as DISPATCH_OUT
    from repro_torch.core import SystemConfig, capture, run
    from repro_torch.graph import rmat_graph
    seconds = _bench_subprocess("repro_torch.benchmarks.dispatch", [],
                                log_dir / "dispatch.log")
    record = dict(benchmark=json.loads(DISPATCH_OUT.read_text()),
                  benchmark_seconds=seconds)
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


def _bench_subprocess(module: str, args: list, log_path: Path) -> float:
    """``python -m module args`` (``python module args`` where ``module``
    is a ``.py`` path) from the checkout's root with ``PYTHONHASHSEED``
    fixed, its output to ``log_path``; fails unless it exits 0 within
    BENCH_TIMEOUT_S.  Returns its seconds."""
    env = dict(os.environ, PYTHONHASHSEED=HASH_SEED)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    target = [module] if module.endswith(".py") else ["-m", module]
    t0 = time.perf_counter()
    with open(log_path, "w") as fh:
        proc = subprocess.run([sys.executable, *target, *args],
                              cwd=ROOT, env=env, stdout=fh,
                              stderr=subprocess.STDOUT,
                              timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n"
                             + log_path.read_text()[-4000:])
    log(f"{module}: exit 0 in {seconds:.1f} s (log {log_path})")
    return seconds


def _kernel_order(config_name: str) -> bool:
    """Whether K1/K2 carry a config's reductions under
    ``use_kernels=True``: the owned push order (``SD*``), the CSC pull
    order (``T*``) and both in the dynamic cells (``D*``)."""
    return config_name[0] in "TD" or config_name[:2] == "SD"


def specialize_phase(graph, dev, log_dir: Path) -> tuple:
    """The matrix and the specialize harness in subprocesses, then the
    specialized runs on the AMZ stand-in and the batched specialized
    runs.  The K1/K2 counts are set to 0 before the in-process runs and
    read after them."""
    import warnings
    from repro_torch.algorithms import REGISTRY
    from repro_torch.benchmarks.matrix import OUT as MATRIX_OUT
    from repro_torch.benchmarks.specialize import OUT as SPEC_OUT
    from repro_torch.core import (SpecializeFallbackWarning, SystemConfig,
                                  resolve_config, run, run_batch)
    from repro_torch.core import specialize_learned as sl
    from repro_torch.graph import paper_graph
    record = {}
    log_dir.mkdir(parents=True, exist_ok=True)
    record["matrix_seconds"] = _bench_subprocess(
        "repro_torch.benchmarks.matrix", ["--scale", str(MATRIX_SCALE)],
        log_dir / "matrix.log")
    matrix = json.loads(MATRIX_OUT.read_text())
    wl = matrix["workload"]
    n_cells = sum(len(c["configs"]) for c in matrix["cells"].values())
    if (wl["scale"], wl["use_kernels"], wl["autotune"], len(wl["configs"]),
            matrix["pythonhashseed"]) != (MATRIX_SCALE, True, "measure", 18,
                                          HASH_SEED):
        raise AssertionError(f"matrix: ran {wl}")
    stuck = [f"{w}/{c}" for w, cell in matrix["cells"].items()
             for c, r in cell["configs"].items() if not r["converged"]]
    if stuck or n_cells != len(wl["apps"]) * len(wl["graphs"]) * 18:
        raise AssertionError(f"matrix: {n_cells} cells, not converged: "
                             f"{stuck}")
    if min(matrix["kernel_launches"].values()) <= 0:
        raise AssertionError(f"matrix: K1/K2 wrapper calls "
                             f"{matrix['kernel_launches']}")
    summary = matrix["summary"]
    log(f"matrix: {matrix['summary']['n_workloads']} workloads, {n_cells} "
        f"cells, scale {wl['scale']}, repeats {wl['repeats']}, autotune "
        f"{wl['autotune']}, use_kernels {wl['use_kernels']}, "
        f"PYTHONHASHSEED={matrix['pythonhashseed']}, card {matrix['card']}")
    log(f"matrix: geomean_specialization_gain="
        f"{summary['geomean_specialization_gain']} n_distinct_best="
        f"{summary['n_distinct_best']} best_config_histogram="
        f"{json.dumps(summary['best_config_histogram'])}")
    log(f"matrix launches: {json.dumps(matrix['kernel_launches'])}")
    for name, rec in matrix["inputs"].items():
        log(f"matrix input {name}: {json.dumps(rec)}")
    record["matrix"] = dict(summary=summary, inputs=matrix["inputs"],
                            kernel_launches=matrix["kernel_launches"],
                            workload=wl, card=matrix["card"])

    record["specialize_seconds"] = _bench_subprocess(
        "repro_torch.benchmarks.specialize", [], log_dir / "specialize.log")
    bench = json.loads(SPEC_OUT.read_text())
    acc = bench["accuracy"]
    log("specialize: accuracy " + " ".join(
        f"{k}={acc[k]}" for k in ("learned", "learned_tol", "static_full",
                                  "static_full_tol", "static_partial",
                                  "static_partial_tol", "trace_augmented",
                                  "trace_augmented_tol")))
    log(f"specialize: speedup_vs_best_always="
        f"{bench['e2e']['speedup_vs_best_always']} best_always="
        f"{json.dumps(bench['e2e']['best_always'])} gate="
        f"{json.dumps(bench['gate'])} model depth={bench['model']['depth']} "
        f"leaves={bench['model']['n_leaves']}")
    log(f"specialize: taxonomy {json.dumps(bench['taxonomy'])}")
    if not all(bench["gate"].values()):
        raise AssertionError(f"specialize: gate {bench['gate']}")
    record["specialize"] = {k: bench[k] for k in ("accuracy", "e2e", "gate",
                                                  "model", "taxonomy")}

    # specialized runs on the AMZ stand-in
    _zero_seg_counts()
    sl.clear_memo()
    oracles = _oracles(graph)
    caller = SystemConfig.from_name("TG0")
    device_launches = {"seg_sum": 0, "seg_minmax": 0}
    record["runs"] = []
    for app in REGISTRY:
        program, seed = REGISTRY[app](), PRIORITY_SEED.get(app)

        def key():
            return None if seed is None else \
                torch.Generator().manual_seed(seed)

        for mode in SPECIALIZE_MODES:
            with warnings.catch_warnings():
                warnings.simplefilter("error", SpecializeFallbackWarning)
                res = run(program, graph, caller, key=key(),
                          use_kernels=True, device=dev, specialize=mode)
            cfg = res.config_name
            if res.config_source != mode or not res.converged:
                raise AssertionError(f"specialize {app} {mode}: source "
                                     f"{res.config_source}, converged "
                                     f"{res.converged}")
            plain = run(program, graph, SystemConfig.from_name(cfg),
                        key=key(), use_kernels=True, device=dev)
            _same_run(app, cfg, res, plain)
            _oracle_check(app, graph, res, program, oracles)
            entry = dict(app=app, mode=mode, config=cfg,
                         source=res.config_source, iterations=res.iterations,
                         seconds=res.seconds, plain_seconds=plain.seconds)
            if _kernel_order(cfg):
                for attempt in range(PROFILE_ATTEMPTS):
                    # late in a long process the tracer can miss the
                    # kernel nodes of a graph captured before the
                    # profile: the later attempts capture anew inside it
                    fresh = attempt >= 2
                    prog = REGISTRY[app]() if fresh else program
                    prof = profile_request(
                        f"specialize {app} {mode} {cfg}"
                        + (" (new capture)" if fresh else ""), lambda: run(
                            prog, graph, SystemConfig.from_name(cfg),
                            key=key(), use_kernels=True, device=dev))
                    found = _device_launches(prof)
                    if sum(found.values()) > 0:
                        break
                entry["profiled_capture"] = "new" if fresh else "replayed"
                if sum(found.values()) <= 0:
                    raise AssertionError(f"specialize {app} {mode} {cfg}: "
                                         "the profiled run executed no "
                                         "K1/K2")
                for k, n in found.items():
                    device_launches[k] += n
                entry["device_launches"] = found
            record["runs"].append(entry)
            log(f"specialize run {app} {mode}: ok {json.dumps(entry)}")
    launches = _seg_counts()
    log(f"specialize path launches: {json.dumps(launches)}; device "
        f"launches (profiled runs): {json.dumps(device_launches)}")
    if sum(launches.values()) <= 0:
        raise AssertionError("specialize path: no K1/K2 wrapper launched")

    # batched specialized runs on stand-ins of different shapes
    record["batch"] = []
    for app in SPEC_BATCH_APPS:
        program = REGISTRY[app]()
        gs = [paper_graph(n, scale=SPEC_BATCH_SCALE,
                          weighted=program.weighted)
              for n in SPEC_BATCH_GRAPHS]
        with warnings.catch_warnings():
            warnings.simplefilter("error", SpecializeFallbackWarning)
            results = run_batch(program, gs, caller, use_kernels=True,
                                device=dev, specialize="learned")
            own = [resolve_config(program, g, caller, "learned")
                   for g in gs]
        for name, g, r, (cfg, source) in zip(SPEC_BATCH_GRAPHS, gs,
                                             results, own):
            if (r.config_name, r.config_source) != (cfg.name, "learned"):
                raise AssertionError(f"specialize batch {app} {name}: "
                                     f"{r.config_name} ({r.config_source}),"
                                     f" resolved alone {cfg.name}")
            seq = run(program, g, cfg, use_kernels=True, device=dev)
            _batch_same(app, cfg.name, r, seq)
        entry = dict(app=app, graphs=list(SPEC_BATCH_GRAPHS),
                     sizes=[[g.n_nodes, g.n_edges] for g in gs],
                     configs=[r.config_name for r in results])
        record["batch"].append(entry)
        log(f"specialize batch {app}: ok {json.dumps(entry)}")
    del gs
    paper_graph.cache_clear()
    return record, launches, device_launches


def _host_result(res):
    """A result with its state copied to the host."""
    return dataclasses.replace(res, state={k: torch.as_tensor(v).cpu()
                                           for k, v in res.state.items()})


def _gateway_same(app, cfg, got, want) -> None:
    """A gateway result (host arrays, converged) against the sequential
    fused run of its graph, as ``_batch_same``, on the host: while the
    gateway's worker captures or certifies, the process-wide sync-debug
    mode makes any other thread's synchronizing CUDA call raise, so the
    sequential runs' states are copied to the host before it starts."""
    if got.engine != "gateway" or got.outcome != "converged":
        raise AssertionError(f"gateway {app} {cfg}: engine {got.engine}, "
                             f"outcome {got.outcome}")
    _batch_same(app, f"{cfg} (gateway)", _host_result(got),
                _host_result(want))


def _gateway_clean(what: str, snap: dict, n: int) -> None:
    """A clean stream: every ticket converged, none quarantined, no
    slice retried."""
    if (snap["converged"], snap["quarantined"], snap["slice_retries"],
            snap["faulted"]) != (n, 0, 0, 0):
        raise AssertionError(f"gateway {what}: {json.dumps(snap)}")


def gateway_phase(graph, dev, log_dir: Path) -> tuple:
    """The streaming gateway on the card with the kernels: a steady
    three-lane stream from 16 client threads against sequential fused
    runs, one profiled scheduling round, roster churn, the AMZ stand-in,
    the slice faults and kill -> recover, then the serve and chaos
    harnesses (serve in a process of its own, as the gate's other timed
    harnesses).  The sequential runs come first; the K1/K2 counts are set
    to 0 before the first gateway and read after the last fault case."""
    import shutil
    import threading
    from repro_torch.algorithms import REGISTRY
    from repro_torch.benchmarks.chaos import run_chaos_bench
    from repro_torch.benchmarks.serve import OUT as SERVE_OUT
    from repro_torch.core import PLAN_CACHE, SystemConfig, bucket_key, run
    from repro_torch.core.resilience import ExecutionFault
    from repro_torch.graph import rmat_batch
    from repro_torch.launch.serve import (ContinuousScheduler, GraphGateway,
                                          OverloadError)
    from repro_torch.testing import (GatewayKillFault, InjectedFault,
                                     SimulatedProcessDeath,
                                     SliceExceptionFault, SliceFaultInjector,
                                     SliceNaNFault)

    class PackedOnly(SliceFaultInjector):
        """Fails ``times`` packed-roster slices (B > 1), not the solo
        ones: the cohabitation fault the breaker routes around."""

        def __init__(self, times: int):
            self.times, self.fired = times, 0

        def before_slice(self, ticket_ids):
            if len(ticket_ids) > 1 and self.fired < self.times:
                self.fired += 1
                raise InjectedFault(f"packed slice of {len(ticket_ids)}")
    record = {}
    t0 = time.perf_counter()
    graphs = rmat_batch(weighted=True, **GATEWAY_GRAPHS)
    keys = {bucket_key(g) for g in graphs}
    if len(keys) != 1:
        raise AssertionError(f"gateway: {len(keys)} buckets, expected one")
    lanes = [(app, cfg, REGISTRY[app](), SystemConfig.from_name(cfg))
             for app, cfg in GATEWAY_LANES]

    def host_run(program, g, config):
        """A serial server's request: the run and its state's copy to
        the host."""
        res = run(program, g, config, use_kernels=True, device=dev)
        return res, {k: v.cpu() for k, v in res.state.items()}

    # the sequential fused runs every gateway result is held against, and
    # a serial server's warm service time (run and the copy to the host)
    want, serial_s = {}, {}
    for app, cfg, program, config in lanes:
        for i, g in enumerate(graphs):
            host_run(program, g, config)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res, host = host_run(program, g, config)
            serial_s[app, i] = time.perf_counter() - t1
            want[app, i] = dataclasses.replace(res, state=host)
    amz_want = {app: _host_result(run(
        REGISTRY[app](), graph, SystemConfig.from_name(cfg),
        use_kernels=True, device=dev)) for app, cfg in GATEWAY_AMZ_CELLS}
    log(f"gateway: {len(graphs)} graphs bucket={keys.pop()} "
        f"V={graphs[0].n_nodes} E={min(g.n_edges for g in graphs)}.."
        f"{max(g.n_edges for g in graphs)}; {len(want) + len(amz_want)} "
        f"sequential runs in {time.perf_counter() - t0:.1f} s")

    # (a) the steady stream ------------------------------------------------
    _zero_seg_counts()
    n = GATEWAY_PER_LANE * len(lanes)

    def request(i):
        app, cfg, program, config = lanes[i % len(lanes)]
        g = (i // len(lanes)) % len(graphs)
        return app, cfg, program, config, g

    results = [None] * n
    errors = []
    with GraphGateway(max_batch=GATEWAY_MAX_BATCH,
                      slice_len=GATEWAY_SLICE_LEN, device=dev) as gw:
        # one admission round takes the whole wave (the worker waits on
        # the gateway's lock), so every lane's roster holds every graph
        with gw._wake:
            warm = [(app, cfg, i, gw.submit(program, g, config,
                                            use_kernels=True))
                    for app, cfg, program, config in lanes
                    for i, g in enumerate(graphs)]
        for app, cfg, i, t in warm:
            _gateway_same(app, cfg, t.result(timeout=600), want[app, i])
        warm_snap = gw.stats()
        gw.reset_stats()

        def client(k):
            try:
                for i in range(k, n, GATEWAY_CLIENTS):
                    app, cfg, program, config, g = request(i)
                    t = gw.submit(program, graphs[g], config,
                                  use_kernels=True)
                    results[i] = t.result(timeout=600)
            except Exception as err:  # noqa: BLE001
                errors.append(repr(err))
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(GATEWAY_CLIENTS)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t1
        snap = gw.stats()
    if errors:
        raise AssertionError(f"gateway clients: {errors[:3]}")
    _gateway_clean("steady", snap, n)
    if snap["roster_rebuilds"]:
        raise AssertionError(f"gateway steady: {snap['roster_rebuilds']} "
                             "roster rebuilds after the warm-up")
    for i, res in enumerate(results):
        app, cfg, _, _, g = request(i)
        _gateway_same(app, cfg, res, want[app, g])
    lat = [r.seconds for r in results]
    serial = sum(serial_s[request(i)[0], request(i)[4]] for i in range(n))
    slices = snap["slices"]
    steady = dict(
        requests=n, clients=GATEWAY_CLIENTS, wall_s=wall, rps=n / wall,
        serial_rps=n / serial, rps_over_serial=serial / wall,
        p50_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_ms=float(np.percentile(lat, 99)) * 1e3,
        serial_ms=serial / n * 1e3,
        mean_occupancy=snap["mean_occupancy"], slices=slices,
        replays=snap["replays"],
        slice_ms=snap["slice_seconds"] / slices * 1e3,
        replay_ms_per_slice=snap["dispatch_seconds"] / slices * 1e3,
        host_ms_per_slice=(snap["slice_seconds"] - snap["dispatch_seconds"]
                           - snap["certificate_seconds"]) / slices * 1e3,
        certificate_ms=snap["certificate_seconds"]
        / max(snap["certificates"], 1) * 1e3,
        certificates=snap["certificates"],
        warmup_roster_rebuilds=warm_snap["roster_rebuilds"],
        roster_rebuilds=snap["roster_rebuilds"], stats=snap)
    record["steady"] = steady
    log("gateway steady: ok " + " ".join(
        f"{k}={steady[k]}" for k in (
            "requests", "clients", "rps", "serial_rps", "rps_over_serial",
            "p50_ms", "p99_ms", "serial_ms", "mean_occupancy", "slices",
            "replays", "slice_ms", "replay_ms_per_slice",
            "host_ms_per_slice", "certificate_ms", "certificates",
            "warmup_roster_rebuilds", "roster_rebuilds")))

    # one profiled scheduling round: a slice per lane, every slot active
    sched = gw._sched
    device_launches = {"seg_sum": 0, "seg_minmax": 0}
    profiles = []
    for attempt in range(PROFILE_ATTEMPTS):
        # late in a long process the tracer can miss the kernel nodes of
        # a graph captured before the profile: the later attempts take
        # new program objects, whose lanes capture anew inside it
        fresh = attempt >= 2
        batch_t = [(app, cfg, i, sched.submit(
            REGISTRY[app]() if fresh else program, g, config,
            use_kernels=True))
            for app, cfg, program, config in lanes
            for i, g in enumerate(graphs)]
        prof = profile_request(
            "gateway round (3 slices of 16"
            + (", new captures)" if fresh else ")"), sched.poll)
        sched.run_until_idle()
        for app, cfg, i, t in batch_t:
            _gateway_same(app, cfg, t.result(0), want[app, i])
        prof["capture"] = "new" if fresh else "replayed"
        profiles.append(prof)
        found = _device_launches(prof)
        if min(found.values()) > 0:
            break
    if min(found.values()) <= 0:
        raise AssertionError(f"gateway: the profiled round executed "
                             f"{found}")
    for k, v in found.items():
        device_launches[k] += v
    record["profiles"] = profiles
    log(f"gateway profiled rounds: idle_share "
        f"{[round(p['idle_share'], 3) for p in profiles]} (the first "
        f"replays warm graphs), device_launches={json.dumps(found)} in "
        f"the last ({prof['capture']})")
    del sched, gw
    PLAN_CACHE.clear()
    free_device_memory()

    # (b) churn --------------------------------------------------------------
    churn_graphs = rmat_batch(**GATEWAY_CHURN_GRAPHS)
    program, config = REGISTRY["BFS"](), SystemConfig.from_name("SD1")
    torch.cuda.synchronize()
    execs0 = PLAN_CACHE.kinds().get("exec_fn", 0)
    reserved0 = torch.cuda.memory_reserved(dev)
    t1 = time.perf_counter()
    with GraphGateway(max_batch=GATEWAY_MAX_BATCH,
                      slice_len=GATEWAY_SLICE_LEN, device=dev) as gw:
        tickets = [gw.submit(program, g, config, use_kernels=True)
                   for g in churn_graphs]
        done = [t.result(timeout=600) for t in tickets]
        snap = gw.stats()
    torch.cuda.synchronize()
    churn = dict(graphs=len(churn_graphs),
                 seconds=time.perf_counter() - t1,
                 roster_rebuilds=snap["roster_rebuilds"],
                 captures=PLAN_CACHE.kinds().get("exec_fn", 0) - execs0,
                 memory_reserved_before=reserved0,
                 memory_reserved_after=torch.cuda.memory_reserved(dev),
                 slices=snap["slices"],
                 mean_occupancy=snap["mean_occupancy"],
                 p99_ms=snap["latency_p99_ms"])
    _gateway_clean("churn", snap, len(churn_graphs))
    for j in range(0, len(churn_graphs), BATCH_SEQ_EVERY):
        _gateway_same("BFS", "SD1", done[j], run(
            program, churn_graphs[j], config, use_kernels=True, device=dev))
    record["churn"] = churn
    log("gateway churn BFS SD1: ok " + " ".join(
        f"{k}={v}" for k, v in churn.items()))
    del churn_graphs, done, tickets
    PLAN_CACHE.clear()
    free_device_memory()

    # (c) Table II size ----------------------------------------------------
    t1 = time.perf_counter()
    amz_cells = [(app, cfg, REGISTRY[app](), SystemConfig.from_name(cfg))
                 for app, cfg in GATEWAY_AMZ_CELLS]
    amz = {}
    with GraphGateway(max_batch=GATEWAY_AMZ_BATCH,
                      slice_len=GATEWAY_SLICE_LEN, device=dev) as gw:
        # a cold wave builds the rosters (packing 4 copies on the host,
        # the contexts, the captures); a warm wave replays them
        for wave in ("cold", "warm"):
            with gw._wake:
                tickets = [(app, cfg, gw.submit(program, graph, config,
                                                use_kernels=True))
                           for app, cfg, program, config in amz_cells
                           for _ in range(GATEWAY_AMZ_REQUESTS)]
            for app, cfg, t in tickets:
                _gateway_same(app, cfg, t.result(timeout=600),
                              amz_want[app])
            snap = gw.stats()
            gw.reset_stats()
            _gateway_clean(f"AMZ {wave}", snap, len(tickets))
            amz[wave] = dict(
                requests=len(tickets), p50_ms=snap["latency_p50_ms"],
                p99_ms=snap["latency_p99_ms"], slices=snap["slices"],
                replays=snap["replays"],
                roster_rebuilds=snap["roster_rebuilds"],
                slice_ms=snap["slice_seconds"] / snap["slices"] * 1e3,
                replay_ms_per_slice=snap["dispatch_seconds"]
                / snap["slices"] * 1e3,
                certificate_ms=snap["certificate_seconds"]
                / max(snap["certificates"], 1) * 1e3)
    amz.update(seconds=time.perf_counter() - t1,
               sequential_ms={a: r.seconds * 1e3
                              for a, r in amz_want.items()})
    record["amz"] = amz
    log("gateway AMZ: ok " + " ".join(f"{k}={v}" for k, v in amz.items()))
    del tickets
    PLAN_CACHE.clear()
    free_device_memory()

    # (d) faults on the (a) pool -----------------------------------------
    faults = {}

    def scheduler(**kw):
        return ContinuousScheduler(max_batch=GATEWAY_MAX_BATCH,
                                   slice_len=kw.pop("slice_len",
                                                    GATEWAY_SLICE_LEN),
                                   device=dev, **kw)

    def lane_tickets(sched, app):
        _, cfg, program, config = next(x for x in lanes if x[0] == app)
        return cfg, [sched.submit(program, g, config, use_kernels=True)
                     for g in graphs]

    def check(case, app, cfg, tickets, bad, code):
        for i, t in enumerate(tickets):
            if i == bad:
                try:
                    t.result(0)
                except ExecutionFault as err:
                    if err.code != code:
                        raise AssertionError(f"gateway {case}: {err.code}")
                    continue
                raise AssertionError(f"gateway {case}: ticket {i} "
                                     "was not quarantined")
            _gateway_same(app, cfg, t.result(0), want[app, i])

    sched = scheduler()
    cfg, tickets = lane_tickets(sched, "SSSP")
    sched.fault_injector = SliceNaNFault(ticket_id=tickets[1].id)
    sched.run_until_idle()
    check("nan", "SSSP", cfg, tickets, 1, "sentinel")
    faults["nan"] = sched.stats.snapshot()

    sched = scheduler(fault_injector=SliceExceptionFault(times=1))
    cfg, tickets = lane_tickets(sched, "BFS")
    sched.run_until_idle()
    check("transient", "BFS", cfg, tickets, None, None)
    faults["transient"] = sched.stats.snapshot()
    try:
        sched.submit(lanes[0][2], graphs[0], lanes[0][3], use_kernels=True,
                     deadline_s=1e-9)
        raise AssertionError("gateway: a hopeless deadline was admitted")
    except OverloadError as err:
        if err.code != "overload_shed":
            raise
        faults["shed"] = err.detail

    sched = scheduler()
    cfg, tickets = lane_tickets(sched, "BFS")
    sched.fault_injector = SliceExceptionFault(ticket_id=tickets[2].id)
    sched.run_until_idle()
    check("persistent", "BFS", cfg, tickets, 2, "slice_exception")
    faults["persistent"] = sched.stats.snapshot()

    sched = scheduler(slice_len=1, breaker_threshold=2, breaker_cooldown=1,
                      fault_injector=PackedOnly(3))
    cfg, tickets = lane_tickets(sched, "SSSP")
    sched.run_until_idle()
    check("breaker", "SSSP", cfg, tickets, None, None)
    faults["breaker"] = sched.stats.snapshot()

    kill_dir = ROOT / "build" / "gateway_journal"
    shutil.rmtree(kill_dir, ignore_errors=True)
    # slices of 2 iterations: the kill lands in mid-run of both lanes
    sched = scheduler(slice_len=2, journal_dir=str(kill_dir),
                      fault_injector=GatewayKillFault(after_slices=2))
    killed = [t for app in ("BFS", "SSSP")
              for t in lane_tickets(sched, app)[1]]
    try:
        sched.run_until_idle()
        raise AssertionError("gateway: the kill never fired")
    except SimulatedProcessDeath:
        pass
    t1 = time.perf_counter()
    fresh = scheduler(slice_len=2)
    recovered = fresh.recover(str(kill_dir))
    resumed = sum(t._restore is not None for t in recovered)
    fresh.run_until_idle()
    recover_s = time.perf_counter() - t1
    by_jid = {t.jid: t.result(0) for t in killed if t.done()}
    by_jid.update({t.jid: t.result(0) for t in recovered})
    for j, t in enumerate(killed):
        app = ("BFS", "SSSP")[j // len(graphs)]
        _gateway_same(app, "SD1", by_jid[t.jid],
                      want[app, j % len(graphs)])
    if not resumed:
        raise AssertionError("gateway kill: no ticket resumed from a "
                             "checkpoint")
    faults["kill"] = dict(recovered=len(recovered), resumed=resumed,
                          seconds=recover_s, stats=fresh.stats.snapshot())
    shutil.rmtree(kill_dir, ignore_errors=True)
    expect = {"nan": dict(quarantined=1, sentinel_trips=1, faulted=1),
              "transient": dict(quarantined=0, faulted=0),
              "persistent": dict(quarantined=1, faulted=1),
              "breaker": dict(breaker_opens=1, breaker_closes=1,
                              quarantined=0)}
    for case, want_counts in expect.items():
        got = {k: faults[case][k] for k in want_counts}
        if got != want_counts:
            raise AssertionError(f"gateway {case}: {got}")
    if faults["transient"]["slice_retries"] < 1 or \
            faults["breaker"]["solo_degraded_slices"] < 1:
        raise AssertionError(f"gateway faults: {json.dumps(faults)}")
    record["faults"] = faults
    for case in ("nan", "transient", "persistent", "breaker"):
        s = faults[case]
        log(f"gateway fault {case}: ok " + " ".join(
            f"{k}={s[k]}" for k in (
                "converged", "faulted", "quarantined", "sentinel_trips",
                "slice_retries", "breaker_opens", "breaker_probes",
                "breaker_closes", "solo_degraded_slices", "slices")))
    log(f"gateway shed: ok {json.dumps(faults['shed'])}")
    log(f"gateway kill -> recover: ok recovered={len(recovered)} "
        f"resumed_from_checkpoint={faults['kill']['resumed']} "
        f"seconds={recover_s:.3f}")
    launches = _seg_counts()
    log(f"gateway path launches: {json.dumps(launches)}; device launches "
        f"(profiled round): {json.dumps(device_launches)}")
    if min(launches.values()) <= 0:
        raise AssertionError("gateway path: a K1/K2 wrapper never launched")
    del sched, fresh, killed, recovered
    PLAN_CACHE.clear()
    free_device_memory()

    # (e) the harnesses ------------------------------------------------------
    serve_s = _bench_subprocess("repro_torch.benchmarks.serve", [],
                                log_dir / "serve.log")
    bench = json.loads(SERVE_OUT.read_text())
    log(f"serve benchmark: {serve_s:.1f} s {json.dumps(bench['modes'])}")
    t1 = time.perf_counter()
    chaos = run_chaos_bench(device=dev)
    log(f"chaos benchmark: {time.perf_counter() - t1:.1f} s "
        f"{json.dumps(chaos['summary'])}")
    s = chaos["summary"]
    if not (s["core_agrees"] and chaos["gateway"]["n_bit_identical"]
            == len(chaos["gateway"]["apps"]) and s["overload_contained"]):
        raise AssertionError(f"chaos: {json.dumps(s)}")
    record["serve_bench"] = dict(modes=bench["modes"],
                                 summary=bench["summary"])
    record["chaos_bench"] = dict(summary=s, core=chaos["core"],
                                 gateway=chaos["gateway"],
                                 overload=chaos["overload"])
    PLAN_CACHE.clear()
    free_device_memory()
    return record, launches, device_launches


def harness_phase(card: str, log_dir: Path) -> tuple:
    """The paper's harnesses, the autotune benchmark and the perf gate,
    each ``python -m repro_torch.benchmarks.<name>`` in a subprocess with
    ``PYTHONHASHSEED`` fixed (``paper_graph`` seeds with ``hash(name)``):
    Table II, Fig. 5 at Table II's sizes, Table V, Fig. 6, the autotune
    benchmark at its pinned workloads, then the gate over every artifact
    this run wrote.  The K1/K2 counts of the autotune path are its
    subprocess's own (from 0 at its start), read from its record; its
    record also holds every cell's K1/K2 states, under the default and
    the tuned plans, against the plain version's on the card."""
    from repro_torch.benchmarks.autotune import OUT as AUTOTUNE_OUT
    from repro_torch.benchmarks.compare import ARTIFACTS, BASELINES, RESULTS
    from repro_torch.benchmarks.fig5 import _configs_for
    from repro_torch.graph import PAPER_GRAPHS
    record = {"seconds": {}}
    log_dir.mkdir(parents=True, exist_ok=True)

    def bench(name, args=()):
        record["seconds"][name] = _bench_subprocess(
            f"repro_torch.benchmarks.{name}", list(args),
            log_dir / f"{name}.log")
        path = AUTOTUNE_OUT if name == "autotune" else RESULTS / \
            f"{name}.json"
        data = json.loads(path.read_text())
        if data.get("card") != card:
            raise AssertionError(f"{name}: card {data.get('card')!r}")
        return data

    # Table II: section (a) against the reference's, pinned
    t2 = bench("table2")
    for row in t2["rows"]:
        pub, comp = TABLE2_PINNED[row["graph"]]
        want = (dict(zip(("volume_kb", "vol_class", "reuse", "reuse_class",
                          "imb", "imb_class"), pub)),
                dict(zip(("volume_kb", "vol_class", "reuse", "reuse_class"),
                         comp)))
        if (row["published"], row["computed_from_published"]) != want:
            raise AssertionError(f"table2 {row['graph']}: {row}")
        log(f"table2 {row['graph']}: ok (a) {row['computed_from_published']}"
            f" (b) {json.dumps(row['measured_on_recreation'])}")
    if len(t2["rows"]) != len(TABLE2_PINNED):
        raise AssertionError(f"table2: {len(t2['rows'])} rows")

    # Fig. 5 at Table II's sizes, every app
    f5 = bench("fig5", ["--scale", str(FIG5_SCALE)])
    cells = f5["cells"]
    if f5["workload"]["scale"] != FIG5_SCALE or \
            f5["pythonhashseed"] != HASH_SEED:
        raise AssertionError(f"fig5: ran {f5['workload']}")
    apps = f5["workload"]["apps"]
    want = {f"{g}/{a}": list(_configs_for(a)) for g in PAPER_GRAPHS
            for a in apps}
    if {k: list(v["configs"]) for k, v in cells.items()} != want:
        raise AssertionError(f"fig5: workloads {sorted(cells)}")
    bad = [f"{k}/{c}" for k, v in cells.items()
           for c, r in v["configs"].items()
           if not r["converged"] or (c.startswith("D")
                                     and not r.get("directions"))]
    if bad:
        raise AssertionError(f"fig5: not converged or no trace: {bad}")
    best = {k: v["best"] for k, v in cells.items()}
    record["fig5"] = dict(workload=f5["workload"], best=best,
                          n_workloads=len(cells),
                          n_cells=sum(len(v["configs"])
                                      for v in cells.values()),
                          best_not_tg0_dg1=sum(b not in ("TG0", "DG1")
                                               for b in best.values()))
    for k, v in cells.items():
        log(f"fig5 {k}: best={v['best']} " + " ".join(
            f"{c}={r['seconds'] * 1e3:.4f}ms/{r['iterations']}"
            + (f"[{r['directions']}]" if "directions" in r else "")
            for c, r in v["configs"].items()))
    log(f"fig5: {record['fig5']['n_workloads']} workloads, "
        f"{record['fig5']['n_cells']} cells, best not TG0/DG1 in "
        f"{record['fig5']['best_not_tg0_dg1']}")

    # Table V and Fig. 6 over this run's Fig. 5
    t5 = bench("table5", ["--scale", str(FIG5_SCALE)])
    if t5["paper_faithful"]["match_table_v"] != "36/36":
        raise AssertionError(f"table5: {t5['paper_faithful']}")
    record["table5"] = {k: t5[k] for k in ("deployed_exact_hits",
                                           "deployed_mean_gap")}
    record["table5"]["paper_faithful"] = \
        t5["paper_faithful"]["match_table_v"]
    log(f"table5: paper_faithful={record['table5']['paper_faithful']} "
        f"deployed hits={t5['deployed_exact_hits']}/{len(t5['deployed'])} "
        f"mean gap={t5['deployed_mean_gap']}")
    f6 = bench("fig6")
    record["fig6"] = {k: f6[k] for k in ("n_cases", "avg_reduction_pct",
                                         "max_reduction_pct")}
    log(f"fig6: {json.dumps(record['fig6'])}")

    # the autotune benchmark: K1/K2 on every S*D, T* and D* cell
    at = bench("autotune")
    launches = at["kernel_launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"autotune: K1/K2 wrapper calls {launches}")
    unequal = [f"{w}/{c}" for w, wl in at["workloads"].items()
               for c, cell in wl["configs"].items()
               if not cell["states_equal"]]
    if unequal or not at["summary"]["states_equal"]:
        raise AssertionError(f"autotune: measure != off in {unequal}")
    # the default and the tuned plans' K1/K2 states against the plain
    # version, bit for bit, at this path's graphs and plans
    unplain = [f"{w}/{c}" for w, wl in at["workloads"].items()
               for c, cell in wl["configs"].items()
               if not cell["plain_equal"]]
    if unplain or not at["summary"]["plain_equal"]:
        raise AssertionError(f"autotune: kernels != plain in {unplain}")
    record["autotune"] = dict(summary=at["summary"],
                              kernel_launches=launches,
                              workloads={w: wl["summary"] for w, wl
                                         in at["workloads"].items()})
    for w, wl in at["workloads"].items():
        log(f"autotune {w}: {json.dumps(wl['summary'])} tuning " + " ".join(
            f"{o}={t['plan']['tile_e']}x{t['plan']['block_mult']}/"
            f"{t['plan']['block_div']}/{t['plan']['gather_splits']}"
            f"@{t['kernel_speedup_vs_default']}"
            for o, t in wl["tuning"].items()))
    log(f"autotune launches: {json.dumps(launches)}")

    # the gate, last: every artifact of this run against the baselines
    record["seconds"]["compare"] = _bench_subprocess(
        "repro_torch.benchmarks.compare", [], log_dir / "compare.log")
    record["gate"] = [line for line in
                      (log_dir / "compare.log").read_text().splitlines()
                      if line.startswith("perf-gate")]
    for line in record["gate"]:
        log(line)
    if len(record["gate"]) != len(ARTIFACTS):
        raise AssertionError(f"compare: {record['gate']} against "
                             f"{BASELINES}")
    return record, launches


def _stats_runs(graph, dev) -> dict:
    """Phase 12 (c): after ``STATS.reset()``, each STATS cell once on the
    host engine and once fused with the kernels; each run's share of
    ``STATS.dispatches`` against its ``RunResult``, then the states
    against plain fused runs.  The K1/K2 counts are set to 0 first."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.core import STATS, SystemConfig, run
    from repro_torch.core.capture import STEPS_PER_LAUNCH
    _zero_seg_counts()
    STATS.reset()
    runs, results, total = [], {}, 0
    for app, cfg in LAST_STATS_CELLS:
        for engine in ("host", "fused"):
            before = STATS.dispatches
            res = run(REGISTRY[app](), graph, SystemConfig.from_name(cfg),
                      use_kernels=True, engine=engine, device=dev)
            share = STATS.dispatches - before
            want = res.iterations if engine == "host" else \
                -(-res.iterations // STEPS_PER_LAUNCH)
            if not res.converged or share != res.dispatches or \
                    share != want:
                raise AssertionError(
                    f"STATS {app} {cfg} {engine}: {share} dispatches "
                    f"counted, RunResult {res.dispatches}, expected "
                    f"{want} for {res.iterations} iterations")
            total += res.dispatches
            results[app, cfg, engine] = res
            runs.append(dict(app=app, config=cfg, engine=engine,
                             iterations=res.iterations, stats=share,
                             dispatches=res.dispatches))
    launches = _seg_counts()
    log(f"last names (c): STATS {STATS.dispatches} dispatches = the runs' "
        f"{total}; {json.dumps(runs)}; K1/K2 launches {json.dumps(launches)}")
    if STATS.dispatches != total or min(launches.values()) <= 0:
        raise AssertionError(f"STATS {STATS.dispatches} != {total}, or a "
                             f"kernel never launched: {launches}")
    for app, cfg in LAST_STATS_CELLS:
        plain = run(REGISTRY[app](), graph, SystemConfig.from_name(cfg),
                    use_kernels=False, device=dev)
        for engine in ("host", "fused"):
            _same_run(app, f"{cfg} {engine} with the kernels against plain",
                      results[app, cfg, engine], plain)
    return dict(runs=runs, dispatches=total, launches=launches)


def _gathered_checks(dev) -> list:
    """Phase 12 (d): ``gathered_segment_reduce`` on the card against its
    numpy oracle, sum, min and max over float32 and int32 values."""
    from repro_torch.kernels.segment_reduce import (
        gathered_segment_reduce, gathered_segment_reduce_ref)
    c = GATHER_CASE
    rng = np.random.default_rng(c["seed"])
    ids = rng.integers(-2, c["segments"] + 2, c["n"]).astype(np.int32)
    values = {"float32": rng.standard_normal(c["n"]).astype(np.float32),
              "int32": rng.integers(-1000, 1000, c["n"]).astype(np.int32)}
    rows = []
    for dtype, vals in values.items():
        for kind in ("sum", "min", "max"):
            got = gathered_segment_reduce(
                torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev),
                c["segments"], kind).cpu().numpy()
            want = gathered_segment_reduce_ref(vals, ids, c["segments"], kind)
            exact = not (dtype == "float32" and kind == "sum")
            ok = (np.array_equal(got, want) if exact else
                  np.allclose(got, want, **GATHER_SUM_TOL))
            err = float(np.max(np.abs(got.astype(np.float64) - want)))
            rows.append(dict(dtype=dtype, kind=kind, max_abs_err=err,
                             exact=exact))
            if got.dtype != want.dtype or not ok:
                raise AssertionError(f"gathered {dtype} {kind}: max abs err "
                                     f"{err}, dtype {got.dtype}")
    log(f"last names (d): gathered_segment_reduce {c} equal to its oracle "
        f"{json.dumps(rows)}")
    return rows


def _smoke_records(smoke_dir: Path) -> dict:
    """Phase 12 (e): the two smoke records: ``smoke`` true, every
    identity field true."""
    batch = json.loads((smoke_dir / "BENCH_batch.json").read_text())
    res = json.loads((smoke_dir / "BENCH_resilience.json").read_text())
    equal = [cell["equal_sequential"] for per_b in batch["configs"].values()
             for cell in per_b.values()]
    # PR's float sums are read to tolerance on the card
    within = [c["within_tolerance"] for c in res["configs"].values()]
    if not (batch.get("smoke") and res.get("smoke") and all(equal)
            and all(within) and len(equal) == 18 * 2 and len(within) == 18):
        raise AssertionError(f"smoke records: batch smoke "
                             f"{batch.get('smoke')} equal {equal}; "
                             f"resilience smoke {res.get('smoke')} within "
                             f"{within}")
    return dict(batch=batch["summary"], resilience=res["summary"],
                batch_workload=batch["workload"],
                resilience_workload=res["workload"])


def last_names_phase(dev, log_dir: Path) -> tuple:
    """Phase 12: the names the port gained last.  Returns (record, K1/K2
    launches of (c), K4 launches of the demo's prefill)."""
    import math
    from repro_torch.algorithms import REGISTRY
    from repro_torch.core import SystemConfig, frontier_density, run
    from repro_torch.graph import graph_stats, powerlaw_graph
    from repro_torch.graph.structure import host_array
    tracked = [ROOT / "results" / "torch" / f"BENCH_{n}.json"
               for n in ("batch", "resilience")]
    before = [p.read_bytes() for p in tracked]
    smoke_dir = ROOT / "build" / "last_names_smoke"
    record = {}
    graph = powerlaw_graph(**AMZ)
    gdev = graph.to(dev)
    # (a) graph_stats on the card against numpy on the host copy
    deg = host_array(graph.out_degree)
    want = dict(n_nodes=graph.n_nodes, n_edges=graph.n_edges,
                max_degree=int(deg.max()), avg_degree=float(deg.mean()),
                std_degree=float(deg.std()))
    stats = graph_stats(gdev).as_dict
    if stats != want:
        raise AssertionError(f"graph_stats {stats} != numpy {want}")
    record["graph_stats"] = stats
    log(f"last names (a): graph_stats of the AMZ stand-in on the card "
        f"{json.dumps(stats)}")

    # (b) frontier_density over a BFS run's frontiers (one per level)
    res = run(REGISTRY["BFS"](), graph,
              SystemConfig.from_name(LAST_BFS_CONFIG), device=dev)
    depth = res.state["depth"]
    depth_h = depth.cpu().numpy()
    got, want = [], []
    for level in range(int(depth_h.max()) + 1):
        d = frontier_density(depth == level, gdev.out_degree,
                             graph.n_edges)
        if d.dtype != torch.float32 or d.device != gdev.out_degree.device:
            raise AssertionError(f"frontier_density: {d.dtype} on "
                                 f"{d.device}")
        m_f = np.int32(deg[depth_h == level].sum(dtype=np.int32))
        got.append(np.float32(d.item()))
        want.append(np.float32(m_f) / np.float32(max(graph.n_edges, 1)))
    if np.asarray(got).view(np.uint32).tolist() != \
            np.asarray(want).view(np.uint32).tolist():
        raise AssertionError(f"frontier_density {got} != numpy {want}")
    record["frontier_density"] = [float(x) for x in got]
    log(f"last names (b): frontier_density of {len(got)} BFS "
        f"{LAST_BFS_CONFIG} frontiers bit-equal to numpy float32: "
        f"{[round(float(x), 6) for x in got]}")

    # (c) STATS and K1/K2; (d) the gathered reduce and its oracle
    record["stats"] = _stats_runs(graph, dev)
    record["gathered"] = _gathered_checks(dev)
    del graph, gdev, res, depth

    # (e) the smoke harnesses; (f) the LM demo, one after another
    run_mod = "repro_torch.benchmarks.run"
    record["subprocess_seconds"] = {
        "batch smoke": _bench_subprocess(run_mod, [
            "--batch-only", "--batch-smoke", "--out-dir", str(smoke_dir)],
            log_dir / "batch_smoke.log"),
        "resilience smoke": _bench_subprocess(run_mod, [
            "--resilience-only", "--resilience-smoke", "--out-dir",
            str(smoke_dir)], log_dir / "resilience_smoke.log"),
        "examples/lm_demo_torch.py": _bench_subprocess(
            "examples/lm_demo_torch.py", ["--steps", str(LM_DEMO_STEPS)],
            log_dir / "lm_demo_torch.log"),
    }
    record["smoke"] = _smoke_records(smoke_dir)
    if [p.read_bytes() for p in tracked] != before:
        raise AssertionError("a smoke run changed the tracked "
                             f"{[p.name for p in tracked]}")
    log(f"last names (e): smoke records {json.dumps(record['smoke'])}; "
        f"results/torch/BENCH_batch.json and BENCH_resilience.json "
        "unchanged")
    demo = json.loads((log_dir / "lm_demo_torch.log").read_text()
                      .strip().splitlines()[-1])
    if not (demo["k4_launches"] == demo["n_layers"] and demo["loss_last"]
            is not None and math.isfinite(demo["loss_last"])
            and demo["device"].startswith("cuda")):
        raise AssertionError(f"examples/lm_demo_torch.py: {demo}")
    record["lm_demo"] = demo
    log(f"last names (f): lm_demo_torch loss {demo['loss_first']:.4f} -> "
        f"{demo['loss_last']:.4f} in {demo['steps']} steps, decoded "
        f"{demo['token_ids']} at {demo['ms_per_token']:.2f} ms/token, "
        f"{demo['k4_launches']} K4 launches in the prefill of "
        f"{demo['n_layers']} layers")
    return record, record["stats"]["launches"], demo["k4_launches"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results" / "torch" /
                                         "chip_smoke.json"))
    ap.add_argument("--sweep", action="store_true",
                    help="time K1/K2 over chunk sizes and threads per CTA, "
                         "and stop")
    args = ap.parse_args()
    # the model file and the benchmarks' records are paths from the root
    args.out = str(Path(args.out).resolve())
    os.chdir(ROOT)

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
    rows += moe_attention_rows(dev, flush)
    del flush
    free_device_memory()

    clock.lap("3 kernels")
    # 4. the graph path, then the dispatch benchmark and the K sweep
    runs, launches, device_launches = main_path(graph, dev)
    clock.lap("4 graph path")
    dispatch = dispatch_phase(graph, dev, out.parent)
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
    PLAN_CACHE.clear()
    free_device_memory()

    # 4f. the specialization study: the matrix, the model, specialized runs
    specialized, spec_launches, spec_device = specialize_phase(
        graph, dev, out.parent)
    clock.lap("4f specialize")
    specialized["seconds"] = clock.seconds["4f specialize"]
    PLAN_CACHE.clear()
    free_device_memory()

    # 4g. the streaming gateway
    gateway, gw_launches, gw_device = gateway_phase(graph, dev, out.parent)
    clock.lap("4g gateway")
    gateway["seconds"] = clock.seconds["4g gateway"]
    del graph
    PLAN_CACHE.clear()
    free_device_memory()

    # 4h. the paper's harnesses, the autotune benchmark, the perf gate
    harnesses, harness_launches = harness_phase(card, out.parent)
    clock.lap("4h harnesses")
    harnesses["phase_seconds"] = clock.seconds["4h harnesses"]

    # 5. DLRM serving
    dlrm, launches["embag"], k3_rows = dlrm_phase(dev)
    clock.lap("5 dlrm")
    rows += k3_rows
    free_device_memory()

    # 6. the attention entry point
    attn, attn_launches = attention_path(dev)
    clock.lap("6 attention")
    free_device_memory()

    # 7. LM serving: K4 once per layer of every prefill
    lm, launches["flash_attention"], cr_launches = lm_phase(dev)
    clock.lap("7 lm serving")
    free_device_memory()

    # 8. training: DLRM's train_batch, starcoder2-7b, card against CPU
    train = train_phase(dev)
    clock.lap("8 training")
    free_device_memory()

    # 9. the MoE LMs: K4 once per layer of each served prefill
    moe, moe_launches = moe_phase(dev)
    clock.lap("9 moe")

    # 10. the GNNs train through aggregate's coherence x consistency
    gnn = gnn_phase(dev)
    clock.lap("10 gnn")
    free_device_memory()

    # 11. the sharding pieces: meshes, DTensor execution, the dry run
    sharding, shard_launches = sharding_phase(dev, out.parent)
    clock.lap("11 sharding")
    free_device_memory()

    # 12. the last names: graph_stats, frontier_density, STATS, the
    # gathered oracle, the two smoke harnesses, examples/lm_demo_torch.py
    names, names_launches, demo_launches = last_names_phase(dev,
                                                            out.parent)
    clock.lap("12 last names")
    for row in rows:
        row["launches"] = launches[row["kernel"]]
        if row["kernel"] == "flash_attention":
            row["attention_launches"] = attn_launches
            row["command_r_launches"] = cr_launches
            row["moe_launches"] = moe_launches
            row["sharding_launches"] = shard_launches
            row["lm_demo_torch_launches"] = demo_launches
            if "arch" in row:  # the MoE prefill shapes: that path's count
                row["launches"] = moe_launches[row["arch"]]
            if attn_launches <= 0 or cr_launches <= 0 or \
                    min(moe_launches.values()) <= 0 or shard_launches <= 0 \
                    or demo_launches <= 0:
                raise AssertionError(f"{row['name']}: no launch on a path")
        if row["kernel"] in device_launches:
            row["device_launches"] = device_launches[row["kernel"]]
            # the later paths, each counted from 0 on its own
            row["autotune_launches"] = tune_launches[row["kernel"]]
            row["batch_launches"] = batch_launches[row["kernel"]]
            row["batch_device_launches"] = batch_device[row["kernel"]]
            row["resilience_launches"] = res_launches[row["kernel"]]
            row["resilience_device_launches"] = res_device[row["kernel"]]
            row["matrix_launches"] = \
                specialized["matrix"]["kernel_launches"][row["kernel"]]
            row["specialize_launches"] = spec_launches[row["kernel"]]
            row["specialize_device_launches"] = spec_device[row["kernel"]]
            row["gateway_launches"] = gw_launches[row["kernel"]]
            row["gateway_device_launches"] = gw_device[row["kernel"]]
            row["harness_launches"] = harness_launches[row["kernel"]]
            row["last_names_launches"] = names_launches[row["kernel"]]
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
                                   specialize=specialized,
                                   specialize_launches=spec_launches,
                                   specialize_device_launches=spec_device,
                                   gateway=gateway,
                                   gateway_launches=gw_launches,
                                   gateway_device_launches=gw_device,
                                   harnesses=harnesses,
                                   harness_launches=harness_launches,
                                   dlrm=dlrm, attention=attn, lm=lm,
                                   train=train, moe=moe, gnn=gnn,
                                   sharding=sharding, last_names=names,
                                   phase_seconds=clock.seconds), indent=1))
    # 13. the kernel table, then the last line
    log(json.dumps({"kernels": rows}))
    log(last)
    return 0


if __name__ == "__main__":
    sys.exit(main())
