#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the CIDER engine on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, from the repo root

Phases (any mismatch raises, and the script exits non-zero):

0. device and build — the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds all five kernels of ``src/repro_torch/kernels/csrc``
   (``flash_attention_bwd`` among them); each kernel's registers and spills
   (``ptxas -v``; the sort sweeps must not spill), the attention kernels'
   shared memory per block at every head dim (paged: 1, 2 and 16 query
   heads a kv head; the backward's dK/dV and dQ blocks in bf16 and f32),
   and a check that ``cuobjdump -sass`` of each flash library (forward and
   backward) holds ``HGMMA`` (bf16 runs on the tensor cores).
1. each kernel against its plain PyTorch version on the card: the two sort
   sweeps bit for bit over N in ``SWEEP_SIZES`` (1-3, 64, every tile edge of
   either kernel, ragged last tiles, the main path's sizes, 2^20) and four
   key layouts, each
   one kernel launch per call; their times at the main path's N and 2^20
   beside their single-launch floor (N = 1) and ``torch.cumsum``;
   the integer helpers (``_backoff_polls``, ``credit_slot``);
   ``paged_attention`` at the serve shape (every length 1-40), at
   decode_32k and at its table shape with lengths 4,096, 32,768 and on the
   split boundaries (0, 1, SPLIT - 1, SPLIT, SPLIT + 1, ...), and at the
   split-sequence decode's launch (64 one-page sequences of 4,096 rows),
   each also with its f32 log-sum-exp against the plain version's, and
   ``flash_attention`` at the prefill shape (B 2, S 4096),
   a ragged S, no mask and a 1024-token window, each in bf16 and f32 within
   the tolerances of ``tests/test_kernels.py`` (bf16 also within two ulps);
   then the other families' shapes (``FLASH_NEW``, ``PAGED_NEW``: flash
   D 80, 96, 112 (kimi-k2-1t-a32b's prefill, B 1 x S 2048, H 64, KH 8),
   256 and deepseek-moe's ungrouped D 128; paged D 96, 112, 256 and the
   ungrouped D 128, at every length 1-40, and D 256 also over
   recurrentgemma's 2,048-row ring; and at D 128 the group sizes 5, 4
   and 12 of qwen2.5-32b, minitron-8b and mistral-large-123b, which no
   later phase runs); kernel, plain, library and bound
   times (a windowed row's library time is SDPA with the mask as a
   boolean ``attn_mask``); the grid each checked paged launch ran, by the
   launcher's report (``counter_plan``), against the host's plan; and the
   design each flash forward ran, by the launcher's report
   (``counter_tc``) and the profiler's kernel names (``FWD_ENTRIES``:
   ``flash_fwd_bf16`` in bf16 at every D, with D 256's registers and
   shared memory, ``flash_fwd_cc`` in f32).  ``flash_attention_bwd`` against
   ``flash_attention_bwd_ref`` (``BWD_TOL``), both fed the kernel
   forward's output and ``lse`` (itself held to the plain version's): the
   training shape (B 2, S 4096, H 16, KH 8, D 128, causal) in bf16 and
   f32, no mask, a 1024-token window and a ragged S, a small shape at
   each other head dim, and the other families' training shapes
   (``BWD_NEW``: hubert-xlarge's D 80, phi-3-vision's D 96,
   recurrentgemma's windowed D 256, kimi-k2-1t-a32b's D 112 at B 1 x S
   4096, H 64, KH 8); kernel, plain, SDPA backward (a
   window as a boolean ``attn_mask``) and bound times, and the design each
   case ran, checked from the profiler's kernel names (``BWD_ENTRIES``:
   the tensor-core entries in bf16 at every D, with the reduce launch
   where the launcher split D 256's dK/dV pass over head groups, by its
   report (``counter_bwd_plan``); the CUDA-core ones in f32).  Head dims
   between the kernels' compiled instances (``BETWEEN``,
   ``PAGED_BETWEEN``), each run on the next instance with zero-filled
   columns: D 16 (recurrentgemma-9b's smoke config: 4 query heads on one
   kv head, window 16), 48, 72 and 200, forward and backward, causal,
   non-causal and windowed, in bf16 and f32; paged D 16 over the smoke's
   40-row slot and 16-row ring and D 80 (on paged's 96 instance), every
   length; every launch on the instance ``instance_of`` plans, by the
   launcher's report (``counter_instance``), in bf16 on the tensor cores;
   kernel, plain, SDPA and bound times at each row's first mask.  Head
   dims whose rows no tensor map describes and past the widest instance
   (``ANY_D``, ROADMAP C4): flash forward and backward at bf16 D 20 and
   36, f32 D 6 and 30 (padded copies), D 32 on a view off 16-byte
   boundaries, and D 264, 320 and 512 in both dtypes (column passes), B 1
   x S 1,024, H 8, KH 2, causal, non-causal and a 64-token window, the
   backward the same bits twice; paged at the same head dims over a
   40-row slot (every length; element loads where the rows are not whole
   16-byte chunks on 16-byte boundaries) and a 4,096-row page (split and
   merge), with ``return_lse``; every launch on the plan ``plan_of``
   gives, by the launchers' reports, and on its design's entries by the
   profiler; kernel, plain, SDPA and bound times (causal; paged at length
   40).  Then C4's seeded inputs (``c4_seeded``): ``gqa_attention``, its
   gradients and ``decode_attention`` at bf16 D 20 and 264 from
   ``default_rng(0)``, card against CPU.
2. the ``engine_json`` configuration (65,536 slots, batch 4096, 16 windows,
   write-intensive Zipf 0.99, 16 CNs) in all four SyncModes: every verb
   counter and the modeled Mops/s and latency percentiles must equal the
   committed ``BENCH_engine.json``.
3. YCSB A-F at the ``ycsb_json`` size x 4 modes: every field of the
   committed ``BENCH_ycsb.json`` ``single`` rows must be reproduced.
4. deployment scale: YCSB A and E over 2^24 populated keys, 64 CNs, batch
   4096, 64 windows, CIDER and MCS; every op's result and the final value of
   every touched key must equal the sequential oracle.
5. ``qwen3-0.6b`` at full width (random weights from a seeded generator):
   ``Model.prefill`` at B 2, S 4096; prefill of 64 tokens and 16 decode
   steps of 8 sequences on the card against the same weights on the CPU; prefill logits
   against token-by-token decode logits on the card; decode step times.
6. ``repro_torch.launch.serve.main(["--arch", "qwen3-0.6b"])``: its stats
   must equal the reference serve's (``SERVE_STATS``); the greedy tokens of
   its first four requests must be the CPU's argmax with the same weights,
   or a near-tie within the card-vs-CPU tolerance.
7. ``BENCH_recovery.json``: three CN-crash scenarios x 4 modes through
   ``recovery.run_recovery`` (32 windows of 2048 ops, 64 CNs); every field of
   every ``modes`` row, the crash storm's ``failover`` sub-dict from
   ``recovery.run_recovery_sharded`` (4 shards, survivors 0 and 2 from the
   crash window) included, held to the single-device drop-mask run.
8. ``BENCH_replication.json``: the ``single`` rows for R 1-3 x 4 modes (R 1
   also against ``BENCH_engine.json``) and the ``mn_crash`` cell through
   ``recovery.run_recovery_replicated``, held to the segmented
   ``n_replicas``-swap run and the crash-free R 3 prefix.
9. ``BENCH_scenarios.json``: the ``single`` rows of the four dynamic
   scenarios x 4 modes through ``runner.run_windows_traced``, per-window
   trajectories and credit mass included.
10. ``BENCH_scale.json``'s open-loop curves on one card (1,048,576 slots,
    512 CNs x 8 lanes, 16 windows): 5 loads x 4 modes, the MMPP row, and
    the dense re-pack identity (bill, credits, store, permuted results).
11. deployment scale: 2^24 keys, 64 CNs, batch 4096, 64 windows, CIDER and
    MCS at 3 MN replicas: ``crash_storm`` (a quarter of the CNs die at
    window 21) with replica 2 dying at window 42, through
    ``run_recovery_replicated``, against the oracle, the segmented run, an
    R = 1 run and the per-replica bill; then a ``RaceHash`` of 2^22 slots
    with 2^21 keys, 16 YCSB-A windows against the oracle, and a SCAN batch
    that must raise.
12. the sharded store (``dist.store`` on ``launch.mesh.make_local_mesh``:
    every shard a partition on the one card): the ``sharded4`` rows of
    ``BENCH_ycsb.json`` (A-F x 4 modes), ``BENCH_replication.json`` (R 1-3)
    and ``BENCH_scenarios.json`` (traced), each also equal to its ``single``
    row; ``BENCH_scale.json``'s ``weak_scaling`` (meshes 1, 4, 8, 16;
    131,072 slots, 512 lanes and 64 CNs a shard; per-shard bills) and
    ``efficiency``; then YCSB A and E over 2^24 keys on 4 shards, CIDER and
    MCS, against the single-device run and the oracle.

13. the protocol simulator (``core.sim``, ticks replayed from CUDA graphs):
    ``run_sim`` at the default ``SimParams``' width (1,024 lanes) for
    8,192 of its 32,768 ticks (``SIM_DEFAULT_TICKS``),
    at ``benchmarks/run.py``'s BASE in 4 modes x {48, 512} clients and
    CIDER with ``wc_off``, ``cas_off`` and 3 MN replicas, and the two crash
    configurations of ``tests/test_substrates.py``: every ``SimResult``
    field equal to ``SIM_PINS`` (pinned from the JAX reference by
    ``tests/test_torch_sim_pins.py``; every run through
    ``examples_torch/cider_sim_figures.py``'s ``sweep``), wall time and ms
    a tick each; 128 ticks eagerly and through the graphs from one
    full-width state in
    all 4 modes, every ``SimState`` field equal; ms a tick by replay and
    eagerly, kernels a tick and the idle share of one profiled replay;
    replays and an engine window loop under
    ``torch.cuda.set_sync_debug_mode("error")``; and ``race_check``'s
    tick-level conformance scenario on the card.

14. the other model families at their published width and full depth,
    one model at a time (``PHASE14``): ``deepseek-moe-16b`` (prefill B 1 x
    2048), ``mamba2-1.3b`` (B 2 x 4096), ``recurrentgemma-9b`` (B 1 x
    4096), ``hubert-xlarge`` (B 2 x 1024 frames of stub features) and
    ``phi-3-vision-4.2b`` (576 stub patches + 64 tokens), and
    ``kimi-k2-1t-a32b`` (D 112, 384 experts; prefill B 1 x 2048) at 1 of
    its 61 layers (``PHASE14``'s ``n_layers``: one layer's 19.4 B
    parameters are 36.2 GiB), then ``recurrentgemma-9b``'s smoke config
    (D 16, on every attention kernel's 32-column instance:
    ``phase14_smoke``: ``serve.main --smoke`` with the reference's stats,
    card against CPU at its own depth with decode against prefill past its
    16-token window, and its 16-row ring wrapped, ``RING_SMOKE``), each
    prefill's
    flash launches on the design phase 1 holds for its head dim (the
    launcher's report); decode against
    prefill (``DECODE_HELD_AT_DEPTH``: held to the tolerance at full depth
    for moe and vlm, printed for ssm and hybrid, and held for every family
    at 2 layers, the hybrid 6); the decode step's time and idle share;
    ``serve.main`` of every decoder over the default 16 requests at 2
    layers of full width (the hybrid 6, kimi 1: the stats depend on the
    request stream alone), its stats equal to ``SERVE_STATS_14``; the card
    against the CPU at 2
    layers (the hybrid two triples, 6; a forward of 4 x 32 positions and 4
    decode steps of 64 sequences; kimi at 1 layer of its attention and
    expert widths with 16 experts and a 4,096-token vocabulary,
    ``CPU_CUT``, a forward of 1 x 256); the hybrid's ring cache past a
    32-token
    window (80 decode steps at 3 layers against its forward).
    MoE comparisons replay one side's expert choices on the other, and
    the choices the other side would have made must agree but for at most
    ``FLIP_MAX`` of them.

15. training every family at full width: first ``qwen3-0.6b`` at full
    depth (``TRAIN``):
    ``repro_torch.launch.train.main`` for 8 steps at B 2 x S 4096 (random
    weights and Zipf tokens from seeds): losses finite and the last below
    the first; flash forward and backward launches a step (the forward
    twice under ``remat="block"``); ms a step (host clock, synchronized),
    tokens/s, peak memory and the idle share of one profiled step, in
    whose profile the backward must be the tensor-core entries, once a
    layer each, and no CUDA-core one (its device time and share printed); the
    loss and every gradient leaf on the card against the CPU on the same
    weights at 2 layers of full width, B 1 x S 256 (``TRAIN_TOL``), every
    leaf's gradient present and nonzero on the card; two steps with
    ``--int8-grads``; and 2 + 2 steps with a restart through ``--ckpt``
    against 4 straight steps (at B 1 x S 512; the state is the full
    model's, 6 GB with the moments), within ``TRAIN_TOL``'s loss rtol (the
    embedding's backward adds by atomics, so not bit for bit).  The
    attention backward takes delta from the forward's f32 output (phase 1
    holds ``_FlashFn``'s gradients to the plain backward fed the plain f32
    output at ``BWD_EMU_CASES``); peak and step time print beside those
    measured with the bf16 residual (``BF16_RESIDUAL``).  Then the other
    five families one at a time (``TRAIN_FAMILIES``: hubert-xlarge B 2 x
    1,024 frames and mamba2-1.3b B 2 x 4,096 at full depth, phi-3-vision
    B 1 x 576 patches + 64 tokens, deepseek-moe-16b B 1 x 2,048 and
    recurrentgemma-9b B 1 x 4,096 at the deepest that fits), each through
    ``launch.train.train_step`` on one seeded batch: losses finite and
    falling, the step's peak under ``TRAIN_PEAK_GIB``, ms a step, positions
    a second, busy time and idle share of one profiled step, flash
    launches a step and the backwards on the tensor cores (every one, at
    D 80, 96, 128 and 256), the backward's share of the busy time;
    then ``train_vs_cpu`` at 2 layers (the hybrid 6), B 1 x S 256, the MoE
    replaying the CPU's expert choices.  No step trains kimi-k2-1t-a32b at
    width (one layer with AdamW is about 410 GB); its head dim 112 trains
    through ``train_vs_cpu`` at its smoke config with ``head_dim`` 112
    (``TRAIN_D112``), the backward's D-112 instance on the card; and
    recurrentgemma-9b's smoke config (D 16) through ``train_vs_cpu``, the
    backward on its 32-column instance and the tensor cores.  Last,
    qwen3-0.6b at full width, 2 layers, with ``head_dim`` 20 and then 264
    (``HEAD_DIM_RUNS``), card against CPU: the prefill's last logits at B
    2 x S 1,024, 16 decode steps and ``train_vs_cpu``, every launch on its
    plan (D 20: flash on padded copies, paged's element loads; D 264: two
    column passes in all three kernels).

16. the distribution and dry-run layer: (a) ``decode_attention_spmd`` at
    decode_32k (B 8, qwen3's H 16, KH 8, D 128, Smax 32,768, bf16,
    ``SPLIT_LENGTHS`` on and around the parts' boundaries) split n = 1, 2,
    4 and 8 ways on a local mesh (one ``paged_attention`` launch over
    B x n parts, merged by their log-sum-exps), each within 2e-2 and two
    bf16 ulps of the unsplit kernel, device times beside it; (b)
    ``combined_embed_grad`` (run heads by ``wc_combine``) and
    ``apply_sparse_grad`` at qwen3's vocab 151,936 x 1,024 in bf16, T
    8,192 and 65,536 Zipf ids: ``hids`` and ``uniq`` equal to the CPU's,
    rows within their f32 summation bound,
    the SGD step within the dense f32 step's bound; unique ids and times;
    (c) the dry-run of all 40 (arch x cell) on both production meshes on
    the host (31 ok, 9 skipped a mesh), each ok cell's collectives counted
    as a DTensor program on a fake process group (``DryrunGrid``: started
    after phase 14, beside phase 15's device-bound training steps, in
    ``DRYRUN_JOBS`` niced processes; phase 16 waits for it), under a torch whose counts
    of qwen3-0.6b's smoke steps on a 2 x 4 mesh equal ``counter.SMOKE``
    (``check_torch``, which each count runs; phase 16 prints them): every
    ok cell's collective bytes positive and its collective term set; both
    meshes' ``report.table``, the cells whose bottleneck is the collective
    term, the grid's host seconds; (d)
    the dry-run's parameter and AdamW-state bytes of qwen3-0.6b equal to
    the bytes of the tensors phase 15 created, and the allocator's growth
    then within its rounding of them (512 bytes, and up to 1 MiB of
    unsplit remainder, a block).

17. the reference's drivers (``examples_torch/*.py``, the counterparts of
    ``examples/*.py``, and ``tools/analyze_torch.py``), each ``main`` in
    this process on the card: quickstart (YCSB A-F x 4 modes, the modeled
    Mops/s == ``QUICKSTART_MOPS``), dynamic_contention (16 windows of
    pess, wc, credit mass and p99 == ``DYNAMIC_ROWS``), crash_recovery
    (repair CAS and p99 a window and a mode == ``CRASH_WINDOWS``,
    ``CRASH_SUMMARY``; the 2-shard failover's bill bit-equal to the single
    device run, its reown reads == ``CRASH_FAILOVER``), serve_kv_cache
    (stats == ``SERVE_KV_STATS``), train_lm (200 steps into a fresh
    checkpoint directory, the loss falling; its first steps on the CPU from
    the card's weights and batches within ``TRAIN_TOL``'s loss rtol) and
    analyze_torch (all three passes clean on the card); the pins are the
    reference examples' (``tests/test_torch_examples.py``).  Each driver's
    seconds.  cider_sim_figures runs no new point here: phase 13's pinned
    runs (its ``base_{mode}_{48,512}`` among them) go through its ``sweep``.

Phases 7-12 print the wall time and peak device memory of their runs and
the idle share of one profiled rerun each (phase 12: of its YCSB-A and
hotspot runs only).  Every phase prints its time.  The launch counters
are zeroed just before phase 2 and read after phase 17; every kernel must have launched in that run, in
the phases that run it, and every head-dim instance of the attention
kernels and ``wc_combine`` from the MoE dispatch (a launch tag) in phase
14.  The attention kernels' tallies by plan (head dim, instance, column
passes, padded) must show each head dim on the instance and passes
``plan_of`` names, every published config's head dim on its own
instance, unpadded, in one pass, and D 16, 20 and 264 on theirs; the
kernel line carries them (``launches_by_plan_of_head_dim``).  A kernel
captured into a CUDA graph (phase 13) is counted once at capture, so its
replays' launches
are added from the graphs' capture counts and replay counts.  The last
lines are the kernel table as JSON, the card's name and power limit, and
the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 16.7e12      # 132 SMs x 64 int32 lanes x 1.98 GHz
FLOPS = {"bfloat16": 989e12,   # H100 SXM dense tensor-core bf16
         "float32": 67e12}     # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2**20          # H100 SXM L2 cache
ATT_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py:39,61
# and, in bf16, two ulps of the output: kernel and plain version both work
# in f32 and round once to bf16, so they differ by at most one ulp
# (2^-7 |out|) plus f32 rounding; 2e-2 alone is most of a typical |out|
BF16_ULPS2 = 2.0 ** -6
# card vs CPU logits of the full-width model: bf16 matmuls round at other
# places in cuBLAS and on the CPU, and 28 layers carry the difference on;
# the repo's own decode-vs-prefill tolerance (tests/test_archs_smoke.py)
MODEL_RTOL, MODEL_ATOL = 1e-1, 1.5e-1
MODES = ("OSYNC", "SPIN", "MCS", "CIDER")
# the reference serve's stats for its default stream, pinned by
# tests/test_torch_serving.py from the JAX scheduler
SERVE_STATS = {"prefix_hits": 15, "prefix_misses": 17, "admitted": 16,
               "completed": 16}
# the sort sweeps' checked sizes: N = 1 and 2, edges of their 512-key tiles,
# ragged sizes (514 and 4098 leave the last thread two keys), the main
# path's sizes (the simulator's 3, 64, 512 and 1024 lanes among them; the
# MoE dispatch's T * k with deepseek-moe-16b's k = 6: 6 a one-token decode
# step, 48 a decode step of 8 sequences, 288 and 384 one sequence's
# 48-token prefill and 64-token forward, 384 also a decode step of 64
# sequences, 768 a forward of 128 tokens, 12,288 a 2,048-token prefill;
# kimi-k2-1t-a32b's k = 8: 8 a serve's decode step, 16,384 a 2,048-token
# prefill) and 2^20
SWEEP_SIZES = (1, 2, 3, 6, 8, 48, 64, 256, 288, 384, 511, 512, 513, 514,
               768, 1000, 1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096,
               4097, 4098, 4352, 8192, 9692, 12288, 16384, 34816, 69632,
               1 << 20)
SWEEP_TIMED = (1, 6, 1024, 4096, 12288, 34816, 69632, 1 << 20)
KERNEL_META = {
    "wc_combine": dict(source="src/repro_torch/kernels/csrc/wc_combine.cu",
                       replaces="src/repro/kernels/wc_combine/wc_combine.py:57",
                       bytes_per_elem=10, ops_per_elem=5, main_n=4096,
                       entry="wc_combine_kernel"),
    "scan_probe": dict(source="src/repro_torch/kernels/csrc/scan_probe.cu",
                       replaces="src/repro/kernels/scan_probe/scan_probe.py:74",
                       bytes_per_elem=15, ops_per_elem=8, main_n=69632,
                       entry="scan_probe_kernel"),
}


ATTN_META = {
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:95", main="train", d=128),
    "paged_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:61",
        main="serve", d=128),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:69",
        main="prefill", d=128),
}
# phase 14's models' attention shapes, each a row of the kernel table:
# flash (row, model, D, B, S, H, KH, causal, window) and paged (row, model,
# D, H, KH; B 1, one 40-row page, every length 1-40).  deepseek-moe-16b
# runs D 128 without grouping (KH = H), beside qwen3-0.6b's grouped rows;
# kimi-k2-1t-a32b D 112 with 8 query heads a kv head.  The "_g" rows hold
# the group sizes of the registered configs no phase serves (qwen2.5-32b
# 5, minitron-8b 4, mistral-large-123b 12) at D 128, kernel level only:
# their launches are the D-128 instance's.
FLASH_NEW = (("flash_attention_d80", "hubert-xlarge", 80, 2, 1024, 16, 16,
              False, 0),
             ("flash_attention_d96", "phi-3-vision-4.2b", 96, 1, 640, 32, 32,
              True, 0),
             ("flash_attention_d256", "recurrentgemma-9b", 256, 1, 4096, 16,
              1, True, 2048),
             ("flash_attention_d128_mha", "deepseek-moe-16b", 128, 1, 2048,
              16, 16, True, 0),
             ("flash_attention_d112", "kimi-k2-1t-a32b", 112, 1, 2048, 64, 8,
              True, 0),
             ("flash_attention_d128_g5", "qwen2.5-32b", 128, 1, 1024, 40, 8,
              True, 0),
             ("flash_attention_d128_g4", "minitron-8b", 128, 1, 1024, 32, 8,
              True, 0),
             ("flash_attention_d128_g12", "mistral-large-123b", 128, 1, 1024,
              96, 8, True, 0))
PAGED_NEW = (("paged_attention_d96", "phi-3-vision-4.2b", 96, 32, 32),
             ("paged_attention_d256", "recurrentgemma-9b", 256, 16, 1),
             ("paged_attention_d128_mha", "deepseek-moe-16b", 128, 16, 16),
             ("paged_attention_d112", "kimi-k2-1t-a32b", 112, 64, 8),
             ("paged_attention_d128_g5", "qwen2.5-32b", 128, 40, 8),
             ("paged_attention_d128_g4", "minitron-8b", 128, 32, 8),
             ("paged_attention_d128_g12", "mistral-large-123b", 128, 96, 8))
# phase 15's families' attention backwards, at each model's training shape
# (the rows of FLASH_NEW: row, model, D, B, S, H, KH, causal, window), and
# kimi-k2-1t-a32b's D 112 at B 1 x S 4096, which phase 15 trains only at
# the smoke config's widths (TRAIN_D112)
BWD_NEW = (("flash_attention_bwd_d80", "hubert-xlarge", 80, 2, 1024, 16, 16,
            False, 0),
           ("flash_attention_bwd_d96", "phi-3-vision-4.2b", 96, 1, 640, 32,
            32, True, 0),
           ("flash_attention_bwd_d256", "recurrentgemma-9b", 256, 1, 4096,
            16, 1, True, 2048),
           ("flash_attention_bwd_d112", "kimi-k2-1t-a32b", 112, 1, 4096, 64,
            8, True, 0))
# phase 17's attention shapes (the smoke qwen3-0.6b: H 4, KH 2, D 32):
# serve_kv_cache's decode, (label, H, KH, D, page rows = prompt 32 + 6 new
# tokens), and train_lm's causal training attention, (label, B, S, H, KH, D,
# causal, window), forward and backward
SMOKE_PAGED = ("smoke_serve", 4, 2, 32, 38)
SMOKE_FLASH = ("smoke_train", 8, 64, 4, 2, 32, True, 0)
for _kernel, _rows in (("flash_attention", FLASH_NEW),
                       ("paged_attention", PAGED_NEW),
                       ("flash_attention_bwd", BWD_NEW)):
    for _row in _rows:
        ATTN_META[_row[0]] = dict(ATTN_META[_kernel], main=_row[1],
                                  d=_row[2], kernel=_kernel)
# head dims between the kernels' compiled instances, each run on the next
# instance with zero-filled columns (phase 1): (D, B, S, H, KH, the
# window of the windowed mask, model or None).  Every row is held causal,
# non-causal and windowed, in bf16 and f32, forward and backward, and
# timed at its first mask.  D 16 is recurrentgemma-9b's smoke config (4
# query heads on one kv head, window 16; phases 14 and 15 serve and train
# it), at its training shape (B 1 x S 256) and first mask, causal with the
# window; D 48, 72 and 200 reach the 64-, 80- and 256-column instances at
# small shapes, causal first.
BETWEEN = ((16, 1, 256, 4, 1, 16, "recurrentgemma-9b (smoke)"),
           (48, 1, 1024, 8, 2, 128, None),
           (72, 2, 512, 8, 8, 128, None),
           (200, 1, 1024, 8, 1, 256, None))
# paged_attention between its instances: (D, H, KH, spans, model or None):
# the smoke's 40-row serve slot (prompt 32 + 8 new tokens; timed) and its
# 16-row ring, every length; D 80, which paged runs on its 96 instance
PAGED_BETWEEN = ((16, 4, 1, (40, 16), "recurrentgemma-9b (smoke)"),
                 (80, 16, 16, (40,), None))
for _kernel in ("flash_attention", "paged_attention", "flash_attention_bwd"):
    ATTN_META[f"{_kernel}_d16"] = dict(ATTN_META[_kernel], d=16,
                                       main=BETWEEN[0][-1], kernel=_kernel)
# head dims whose rows no tensor map describes, a view off 16-byte
# boundaries, and head dims past the widest instance (phase 1's
# phase1_any_head_dim; ROADMAP C4): (D, dtype, view), the view the
# columns 1 .. D of a (.., D + 2) tensor.  Flash forward and backward at
# ANY_D_SHAPE (B, S, H, KH, window), causal, unmasked and windowed, timed
# causal; paged with the same heads at every length 1-40 of a 40-row slot
# (timed at 40), at 4,096 (eight splits and the merge), with return_lse.
ANY_D = ((20, "bfloat16", False), (36, "bfloat16", False),
         (6, "float32", False), (30, "float32", False),
         (32, "bfloat16", True),
         (264, "bfloat16", False), (264, "float32", False),
         (320, "bfloat16", False), (320, "float32", False),
         (512, "bfloat16", False), (512, "float32", False))
ANY_D_SHAPE = (1, 1024, 8, 2, 64)
# qwen3-0.6b at full width, 2 layers, with these head dims (phase 15's
# head_dim_runs): prefill B 2 x S 1,024, 16 decode steps, one training
# step, card against CPU; their bf16 phase-1 rows are kernel-table rows
HEAD_DIM_RUNS = dict(arch="qwen3-0.6b", dims=(20, 264), n_layers=2,
                     batch=2, seq=1024, steps=16)
for _kernel in ("flash_attention", "paged_attention", "flash_attention_bwd"):
    for _d in HEAD_DIM_RUNS["dims"]:
        ATTN_META[f"{_kernel}_d{_d}"] = dict(
            ATTN_META[_kernel], d=_d, kernel=_kernel,
            main=f"{HEAD_DIM_RUNS['arch']} (head_dim {_d}, 2 layers)")


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


_ENTRY = re.compile(r"(flash_fwd_bf16|flash_fwd_cols|flash_fwd_cc|"
                    r"flash_bwd_delta|flash_bwd_dkdv_bf16|flash_bwd_dq_bf16|"
                    r"flash_bwd_reduce_bf16|flash_bwd_dkdv_cols|"
                    r"flash_bwd_dq_cols|flash_bwd_dkdv|flash_bwd_dq|"
                    r"paged_split_kernel|paged_cols_kernel|"
                    r"paged_merge_kernel)I((?:13__nv_bfloat16|f)*)"
                    r"(?:Li(\d+)E)?(?:Lb([01])E)?")
_SWEEP_ENTRY = re.compile(r"(wc_combine_kernel|scan_probe_kernel)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
# ptxas -v's lines of each entry function (``flash_fwd_bf16<bf16, D=256>``
# ...) of the libraries this run built
PTXAS: dict[str, list[str]] = {}
# the forward's dynamic shared memory per block in bf16, by head dim
FLASH_SMEM_BF16: dict[int, int] = {}


def ptxas_report(name: str, log: str) -> int:
    """Registers, spills and static shared memory of each entry function
    of library ``name``, from ``nvcc -Xptxas -v``'s log (kept in
    ``PTXAS``).  Returns the bytes of spill stores and loads over all its
    entries."""
    entry, spilled = None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _ENTRY.search(line)
            sweep = _SWEEP_ENTRY.search(line)
            # the template's type arguments (the delta kernel's out type,
            # then its input type)
            types = re.findall(r"13__nv_bfloat16|f", m.group(2)) if m else []
            dtype = "".join({"13__nv_bfloat16": "bf16, ", "f": "f32, "}[t]
                            for t in types)
            args = ([f"D={m.group(3)}"] if m and m.group(3) else []) + (
                [f"{bool(int(m.group(4)))}"] if m and m.group(4) else [])
            entry = (f"{m.group(1)}<{dtype}{', '.join(args)}>".replace(
                        ", >", ">") if m
                     else sweep.group(1) if sweep
                     else line.split("'")[1][:72])
        elif entry and any(w in line for w in ("registers", "spill",
                                               "smem")):
            spill = _SPILLS.search(line)
            if spill:
                spilled += int(spill.group(1)) + int(spill.group(2))
            PTXAS.setdefault(entry, []).append(
                line.split(':', 1)[-1].strip())
            say(f"  {name}: {entry}: {PTXAS[entry][-1]}")
    return spilled


def attention_smem() -> None:
    """Dynamic shared memory per block of the attention kernels, as their
    launchers request it (``*_smem_bytes`` of each library)."""
    import ctypes
    from repro_torch.kernels import build
    fns = {}
    for name, n_args in (("flash_attention", 2), ("paged_attention", 3)):
        # a handle of its own: the launchers' cached handle keeps their
        # signatures
        lib = ctypes.CDLL(str(build.library_path(name)))
        fn = getattr(lib, f"{name}_smem_bytes")
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * n_args
        fns[name] = fn
    from repro_torch.kernels.flash_attention.ops import INSTANCES as FLASH_D
    from repro_torch.kernels.paged_attention.ops import INSTANCES as PAGED_D
    bwd = ctypes.CDLL(str(build.library_path("flash_attention_bwd")))
    bwd.flash_attention_bwd_smem_bytes.restype = ctypes.c_int
    bwd.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    for dtype, label in ((1, "bf16"), (0, "f32")):
        for which, block in ((0, "dK/dV"), (1, "dQ")):
            sizes = {d: bwd.flash_attention_bwd_smem_bytes(dtype, d, which)
                     for d in FLASH_D}
            check(all(0 < b <= 232_448 for b in sizes.values()),
                  f"flash_attention_bwd shared memory {sizes} beyond 227 KB")
            say(f"  dynamic shared memory per block, flash_attention_bwd "
                f"{block}, {label}, by D: {sizes} B")
    for dtype, label in ((1, "bf16"), (0, "f32")):
        flash = {d: fns["flash_attention"](dtype, d) for d in FLASH_D}
        if dtype:
            FLASH_SMEM_BF16.update(flash)
        check(all(0 < b <= 232_448 for b in flash.values()),
              f"flash_attention shared memory {flash} beyond 227 KB")
        say(f"  dynamic shared memory per block, {label}, by D: "
            f"flash_attention {flash} B")
        # g = 1 (phi-3-vision), 2 (qwen3-0.6b), 16 (recurrentgemma-9b's MQA)
        for g in (1, 2, 16):
            paged = {d: fns["paged_attention"](dtype, d, g) for d in PAGED_D}
            check(all(0 < b <= 232_448 for b in paged.values()),
                  f"paged_attention shared memory {paged} beyond 227 KB")
            say(f"    paged_attention (g = {g}) {paged} B")


def hgmma_count(path) -> int:
    """``HGMMA`` instructions in the SASS of the library at ``path``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300, check=True)
    return out.stdout.count("HGMMA")


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, iters: int = 20, n_top: int | None = 5):
    """Run ``fn`` ``iters`` times under ``torch.profiler``, tracing the
    device only (a trace of the CPU's operators would be most of the
    processing time of a long run, and no number here reads it).  Returns
    ``(device_ms_per_call, wall_ms_per_call, top)``: the summed self device
    time of every GPU event, the host wall time around the calls, and the
    ``n_top`` events (all for None) with the most device time, each as
    (name, ms a call, count).  The device time is None when the profiler
    recorded no GPU events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in gpu) / 1e3 / iters
    top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:n_top]
    top = [(e.key[:60], e.self_device_time_total / 1e3 / iters, e.count)
           for e in top]
    return (total if gpu else None), wall, top


def floor_ms(nbytes: int, flops: int = 0) -> float:
    """The least device ms any call can take for work that moves ``nbytes``
    and does ``flops`` operations: the bytes over the memory rate where
    they exceed the L2 cache (smaller inputs may stay in L2 from one call
    to the next), and the operations over the card's highest peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3 if nbytes > L2_BYTES else 0.0
    return max(by_bytes, flops / FLOPS["bfloat16"] * 1e3)


def timed(fn, iters: int, events: bool = False, floor: float = 0.0):
    """``(device ms, call ms)`` per call of ``fn``: the profiler's summed
    device time, and the CUDA-event time of back-to-back calls, which
    includes host overhead; with ``events`` also the profiler's five
    longest GPU events (``profile_device``'s ``top``; empty when it
    recorded none).  A session that records no GPU events, or a device
    time below ``floor`` (``floor_ms`` of the call's work: the session
    dropped events), is run again, up to three times; then the CUDA-event
    time stands for the device time, and is flagged."""
    call = cuda_ms(fn, iters=iters, warmup=1)
    for _ in range(3):
        dev, _, top = profile_device(fn, iters=iters)
        if dev is not None and dev >= floor:
            return (dev, call, top) if events else (dev, call)
        if dev is not None:
            say(f"  (a profiled device time of {dev:.5f} ms is below the "
                f"call's floor of {floor:.5f} ms: events dropped, run again)")
    say(f"  (no profiled session gave a device time: device time by CUDA "
        f"events, {call:.5f} ms"
        + (f", BELOW the floor of {floor:.5f} ms)" if call < floor else ")"))
    return (call, call, []) if events else (call, call)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def key_layouts(n: int, rng):
    """Sorted int32 key arrays: all distinct, one run over every block, a
    +inf sentinel tail (invalid lanes), random duplicate-heavy runs."""
    import numpy as np
    big = 2**31 - 1
    tail = np.sort(rng.integers(0, max(n // 4, 1), n)).astype(np.int64)
    tail[n - n // 4:] = big
    return {
        "distinct": np.arange(n, dtype=np.int64) * 3 - n,
        "one_run": np.full(n, 7, np.int64),
        "sentinel_tail": tail,
        "dup_heavy": np.sort(rng.integers(0, max(n // 8, 1), n)),
    }


def kernel_device_ms(fn, entry: str, iters: int = 50) -> float:
    """Device ms per call of ``fn`` by the profiler, which must show one
    kernel named ``entry`` per call and no other kernel or memset; a
    session that records no GPU events, or fewer ``entry`` events than
    calls and nothing else (the profiler dropped some), is run again, up to
    three times."""
    for _ in range(3):
        ms, _, top = profile_device(fn, iters=iters)
        dropped = (ms is not None and len(top) == 1 and entry in top[0][0]
                   and top[0][2] < iters)
        if ms is not None and not dropped:
            break
    check(ms is not None, f"{entry}: the profiler recorded no GPU events in "
                          f"three sessions")
    check(len(top) == 1 and entry in top[0][0] and top[0][2] == iters,
          f"expected one {entry} per call, the profiler saw {top} over "
          f"{iters} calls")
    return ms


def phase1_kernels(dev, card: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.kernels.wc_combine import ops as wcc

    rng = np.random.default_rng(2024)
    stats = {name: {"max_abs_err": 0, "times": {}} for name in KERNEL_META}
    for n in SWEEP_SIZES:
        for layout, keys_np in key_layouts(n, rng).items():
            keys = torch.as_tensor(keys_np.astype(np.int32), device=dev)
            setcode = torch.as_tensor(rng.integers(-1, 2, n).astype(np.int32),
                                      device=dev)
            writer = torch.as_tensor(rng.random(n) < 0.3, device=dev)
            e_init = torch.as_tensor(rng.random(n) < 0.5, device=dev)
            for name, kern, plain, args in (
                    ("wc_combine", wcc.wc_combine_cuda, wcc.wc_combine_ref,
                     (keys,)),
                    ("scan_probe", sp.scan_probe_cuda, sp.scan_probe_ref,
                     (keys, setcode, writer, e_init))):
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"{name} N={n} {layout}: dtype/shape differ")
                    err = int((g.to(torch.int64) - w.to(torch.int64))
                              .abs().max().item()) if n else 0
                    stats[name]["max_abs_err"] = max(
                        stats[name]["max_abs_err"], err)
                    check(err == 0, f"{name} N={n} {layout}: kernel differs "
                                    f"from its plain version (max |diff| {err})")
                if layout != "dup_heavy" or n not in SWEEP_TIMED:
                    continue
                meta = KERNEL_META[name]
                dev_k = kernel_device_ms(lambda: kern(*args), meta["entry"])
                call_k = cuda_ms(lambda: kern(*args), iters=50, warmup=1)
                dev_p, call_p = timed(lambda: plain(*args), 50)
                dev_c = timed(lambda: torch.cumsum(keys, 0, dtype=torch.int32),
                              50)[0]
                bytes_ms = meta["bytes_per_elem"] * n / HBM_BYTES_PER_S * 1e3
                ops_ms = meta["ops_per_elem"] * n / INT32_OPS_PER_S * 1e3
                t = dict(ms=dev_k, plain_ms=dev_p, call_ms=call_k,
                         plain_call_ms=call_p, cumsum_ms=dev_c,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations")
                stats[name]["times"][n] = t
                floor = stats[name]["times"][SWEEP_TIMED[0]]["ms"]
                say(f"  {name:10s} N={n:8d} device: kernel {dev_k} ms "
                    f"(single-launch floor, N=1: {floor} ms), plain {dev_p} "
                    f"ms, torch.cumsum int32 (the card's own device-wide "
                    f"scan, for comparison; not a library equivalent) {dev_c}"
                    f" ms; per call (host-bound): kernel {call_k:.5f} ms, "
                    f"plain {call_p:.5f} ms; bound {t['bound_ms']:.6f} ms "
                    f"({t['bound_by']}); one {meta['entry']} per call; "
                    f"library: none (no single PyTorch call computes it) "
                    f"[{card}]")
        say(f"  N={n}: both kernels bit-equal to their plain versions on 4 "
            f"key layouts")
    return stats


def phase1_helpers(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.core.credits import credit_slot
    from repro_torch.core.engine import _backoff_polls

    w = torch.arange(0, 2**20 + 1, dtype=torch.int32, device=dev)
    for cap in range(0, 22):
        got = _backoff_polls(w, cap)
        # the reference's float32 form, computed on the card
        wf = w.to(torch.float32)
        exp_phase = torch.clamp(torch.ceil(torch.log2(torch.clamp(wf, min=1.0)
                                                      + 1.0)), max=float(cap))
        linear = torch.clamp(wf - (2.0**cap - 1.0), min=0.0) / (2.0**cap)
        want = torch.where(w > 0, exp_phase + torch.floor(linear),
                           0.0).to(torch.int32)
        check(torch.equal(got, want), f"_backoff_polls cap={cap} differs from "
                                      f"the float32 form on the card")
        check(torch.equal(got.cpu(), _backoff_polls(w.cpu(), cap)),
              f"_backoff_polls cap={cap}: card and CPU differ")
    keys = np.random.default_rng(5).integers(-2**31, 2**31, 1 << 20)
    keys[:4] = (-2**31, -1, 0, 2**31 - 1)
    kt = torch.as_tensor(keys.astype(np.int32))
    h = ((keys.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
         * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    for table in (1024, 4096, 4093):
        want = ((h >> np.uint64(7)) % np.uint64(table)).astype(np.int32)
        got = credit_slot(kt.to(dev), table).cpu().numpy()
        check(np.array_equal(got, want), f"credit_slot table={table} differs "
                                         f"from the uint32 hash on the card")
    say("  _backoff_polls (w in [0, 2^20], caps 0-21) and credit_slot (full "
        "int32 range) equal their plain forms on the card")


# ---------------------------------------------------------------------------
# phase 1 (attention): both attention kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(shape, dtype, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev,
                       dtype=torch.float32).to(dtype)


def paged_lse_check(args, what: str) -> None:
    """``paged_attention_cuda(..., return_lse=True)`` (a part of a split
    sequence): where the length is positive, the f32 output rounds to the
    bits of the output without it and stays within f32 rounding (2e-5 +
    2e-5 |out|) of the plain version's, and each head's log-sum-exp within
    1e-4 + 1e-5 |lse| of the plain one; where it is not, output 0 and lse
    -inf."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa
    q, kp, vp, bt, lens = args
    out, lse = pa.paged_attention_cuda(*args, return_lse=True)
    want, want_lse = pa.paged_attention_ref(*args, return_lse=True)
    live = lens > 0
    check(out.dtype == torch.float32 and lse.dtype == torch.float32,
          f"paged_attention lse {what}: output {out.dtype}, lse {lse.dtype}")
    check(torch.equal(out[live].to(q.dtype),
                      pa.paged_attention_cuda(*args)[live]),
          f"paged_attention lse {what}: the f32 output does not round to "
          f"the output")
    err = float((out - want).abs().max())
    check(bool(((out - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()),
          f"paged_attention lse {what}: f32 output max |diff| {err}")
    lerr = float((lse - want_lse).abs()[live].max()) if bool(live.any()) \
        else 0.0
    check(lerr <= 1e-4 + 1e-5 * float(want_lse.abs()[live].max())
          if bool(live.any()) else True,
          f"paged_attention lse {what}: max |diff| {lerr}")
    check(not bool(out[~live].any())
          and bool((lse[~live] == -torch.inf).all()),
          f"paged_attention lse {what}: a length-0 head read something")
    say(f"  paged_attention lse {what}: f32 output max |diff| {err:.3g}, "
        f"lse max |diff| {lerr:.3g} over {int(live.sum())} sequences with "
        f"positions, {int((~live).sum())} empty (0, -inf)")


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int((hi - lo + 1).sum())


def bwd_tile_bytes(b: int, s: int, h: int, kh: int, d: int, causal: bool,
                   window: int, head_groups: int) -> dict:
    """Bytes each pass of the bf16 tensor-core backward loads by TMA (from
    L2, or from device memory on a miss), by the kernels' own loops:
    every block its two own tiles (128 rows, 64 at D 256) once and a tile
    pair (64 rows of each of two tensors) a streamed tile; the dK/dV pass
    over the query tiles its keys see, once for each query head of its
    group, the dQ pass over the key tiles its queries see."""
    own = 64 if d > 128 else 128
    pair = 2 * 64 * d * 2
    dkdv = dq = 0
    for k0 in range(0, s, own):
        kmax = min(k0 + own, s) - 1
        q_hi = min(s, kmax + window) if window else s
        tiles = -(-q_hi // 64) - (k0 if causal else 0) // 64
        dkdv += tiles * h // kh * pair + head_groups * 2 * own * d * 2
    for q0 in range(0, s, own):
        hi = -(-s // 64)
        if causal:
            hi = min(hi, -(-min(q0 + own, s) // 64))
        lo = max(0, q0 - window + 1) // 64 if window else 0
        dq += h * ((hi - lo) * pair + 2 * own * d * 2)
    return {"dkdv": b * kh * dkdv, "dq": b * dq}


def phase1_attention(dev, card: str) -> dict:
    """Each attention kernel against its plain version at the serving
    slice's shapes, in bf16 and f32; times by CUDA events; returns the
    kernel-line numbers at each kernel's main-path shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    out = {name: {"max_abs_err": 0.0} for name in ATTN_META}

    def row_of(ms, call, plain, plain_call, lib, lib_call, nbytes, flops,
               dtype):
        bound_ms, bound_by = attention_bound(nbytes, flops, dtype)
        return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                    bound_by=bound_by, call_ms=call, plain_call_ms=plain_call,
                    library_call_ms=lib_call)

    def compare(name, got, want, dtype, what):
        torch.cuda.synchronize()
        tol = ATT_TOL[str(dtype).removeprefix("torch.")]
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name} {what}: dtype/shape differ")
        check(bool(torch.isfinite(got).all()), f"{name} {what}: not finite")
        err = float((got.float() - want.float()).abs().max())
        bad = ((got.float() - want.float()).abs()
               > tol + tol * want.float().abs()).sum().item()
        check(bad == 0, f"{name} {what}: {bad} elements beyond rtol = atol = "
                        f"{tol} (max |diff| {err})")
        if dtype == torch.bfloat16:
            bad = ((got.float() - want.float()).abs()
                   > 1e-5 + BF16_ULPS2 * want.float().abs()).sum().item()
            check(bad == 0, f"{name} {what}: {bad} elements more than two "
                            f"bf16 ulps off (max |diff| {err})")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        return err

    def windowed_sdpa(q, k, v, causal, window, want, fl):
        """The library's time for a sliding window: SDPA with the causal +
        window mask as an explicit boolean ``attn_mask`` over k/v expanded
        to q's heads (every row keeps its own key, so this is the same
        function; its output is held to the plain version's within
        ``ATT_TOL``).  Returns (device ms, call ms, the profiler's top GPU
        event: the SDPA backend's kernel)."""
        s, g = q.shape[2], q.shape[1] // k.shape[1]
        pos = torch.arange(s, device=q.device)
        keep = pos[None, :] > pos[:, None] - window
        if causal:
            keep &= pos[None, :] <= pos[:, None]
        ke, ve = (x.repeat_interleave(g, 1) for x in (k, v))
        tol = ATT_TOL[str(q.dtype).removeprefix("torch.")]
        got = F.scaled_dot_product_attention(q, ke, ve, attn_mask=keep)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        ms, call, top = timed(lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=keep), 5, events=True, floor=fl)
        return ms, call, (top[0][0] if top else None)

    def planned(what, launch, b, kh, g, span, passes=1):
        """Runs ``launch``, one paged launch, and checks that the grid the
        launcher reported for it (``pa.counter_plan``) is the host's plan
        for these shapes (``passes`` column passes a block of the grid).
        Returns the launch's output and the plan."""
        groups = pa.head_group_plan(b, kh, g, span, pa.fill_blocks(dev))
        splits = pa.split_plan(span)[1]
        want = pa.Plan(groups, splits, kh * groups * b * splits * passes)
        pa.counter_plan.reset()
        got = launch()
        ran = dict(pa.counter_plan.by_size)
        check(ran == {want: 1}, f"paged_attention {what}: the launcher ran "
                                f"{ran}, planned {want}")
        return got, want._asdict()

    # paged: the serve shape (one 40-row page per sequence, the identity
    # block table, lengths 1-40), and decode_32k (B 8, lengths up to 32,768,
    # 16-row pages, a permuted block table into a larger pool: 64 splits),
    # also with every length 4,096, every length 32,768, lengths on the
    # split boundaries, and the split-sequence decode's one launch
    # (phase 16: decode_32k's cache as 8 x 8 parts of 4,096 rows, one page
    # each, at SPLIT_LENGTHS cut into parts); each also with its log-sum-exp
    # (``return_lse``, which dist.decode_attn merges by) against the plain
    # version's
    rng = np.random.default_rng(32)
    sp = pa.SPLIT
    for label, b, page, np_, extra in (
            ("serve", 1, 40, 1, 0), ("decode_32k", 8, 16, 2048, 64),
            ("len_4096", 8, 16, 2048, 64), ("len_32768", 8, 16, 2048, 64),
            ("split_edges", 8, 16, 2048, 64), ("parts_8", 64, 4096, 1, 0)):
        h, kh, d = 16, 8, 128
        npool = b * np_ + extra
        bt_np = rng.permutation(npool)[: b * np_].reshape(b, np_)
        if label == "serve":
            lens_np = np.array([40], np.int32)
        elif label == "decode_32k":
            lens_np = rng.integers(1, np_ * page + 1, b).astype(np.int32)
            lens_np[0] = np_ * page
        elif label == "split_edges":
            lens_np = np.array([0, 1, sp - 1, sp, sp + 1, 2 * sp - 1,
                                2 * sp, 2 * sp + 1], np.int32)
        elif label == "parts_8":
            bt_np = np.arange(b).reshape(b, 1)
            lens_np = np.clip(np.array(SPLIT_LENGTHS)[:, None]
                              - page * np.arange(8)[None, :], 0,
                              page).reshape(b).astype(np.int32)
        else:
            lens_np = np.full(b, int(label[4:]), np.int32)
        bt = torch.as_tensor(bt_np.astype(np.int32), device=dev)
        lens = torch.as_tensor(lens_np, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn((b, h, d), dtype, dev, 1)
            kp = _randn((npool, page, kh, d), dtype, dev, 2)
            vp = _randn((npool, page, kh, d), dtype, dev, 3)
            args = (q, kp, vp, bt, lens)
            got, plan = planned(f"{label} {dtype}",
                                lambda: pa.paged_attention_cuda(*args), b, kh,
                                h // kh, np_ * page)
            err = compare("paged_attention", got,
                          pa.paged_attention_ref(*args), dtype,
                          f"{label} {dtype}")
            paged_lse_check(args, f"{label} {dtype}")
            if label == "serve":
                # every other length the serve gives the kernel: the mask
                # inside the page
                for n in range(1, 40):
                    ln = torch.full((1,), n, dtype=torch.int32, device=dev)
                    compare("paged_attention",
                            pa.paged_attention_cuda(q, kp, vp, bt, ln),
                            pa.paged_attention_ref(q, kp, vp, bt, ln), dtype,
                            f"serve length {n} {dtype}")
            es = q.element_size()
            n_rows = int(lens_np.clip(0, np_ * page).sum())
            nbytes = (2 * n_rows * kh * d * es + 2 * b * h * d * es
                      + 4 * int(np.ceil(lens_np / page).sum()) + 4 * b)
            flops = 4 * n_rows * h * d
            fl = floor_ms(nbytes, flops)
            ms, call = timed(lambda: pa.paged_attention_cuda(*args), 20,
                             floor=fl)
            plain, plain_call = timed(lambda: pa.paged_attention_ref(*args), 5,
                                      floor=fl)
            # yardstick: SDPA over the same rows as a dense cache
            dk = kp[bt.long()].reshape(b, np_ * page, kh, d).transpose(1, 2)
            dv = vp[bt.long()].reshape(b, np_ * page, kh, d).transpose(1, 2)
            mask = (torch.arange(np_ * page, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                q[:, :, None], dk, dv, attn_mask=mask, enable_gqa=True), 20,
                floor=fl)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FLOPS[str(dtype).removeprefix("torch.")] * 1e3
            row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", call_ms=call,
                       plain_call_ms=plain_call, library_call_ms=lib_call,
                       plan=plan)
            if label == ATTN_META["paged_attention"]["main"] \
                    and dtype == torch.bfloat16:
                out["paged_attention"].update(row)
            say(f"  paged_attention {label} B{b} H{h} KH{kh} D{d} page "
                f"{page} x {np_} ({plan}), "
                f"{n_rows} rows, {dtype}: max |diff| {err:.3g};"
                f" device: kernel {ms:.5f} ms, plain {plain:.5f} ms, "
                f"SDPA (dense, masked) {lib:.5f} ms; per call: {call:.5f} / "
                f"{plain_call:.5f} / {lib_call:.5f} ms; bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']}, "
                f"{nbytes / 1e9:.4f} GB) [{card}]")
            del q, kp, vp, dk, dv

    # flash: the prefill shape (B 2, S 4096, H 16, KH 8, D 128, causal), a
    # ragged S, no mask, a 1024-token sliding window, and the training
    # shape of phase 17's train_lm (SMOKE_FLASH; the f32 output for
    # training is checked with the backward, phase1_backward)
    for label, b, s, h, kh, d, causal, window in (
            ("prefill", 2, 4096, 16, 8, 128, True, 0),
            ("ragged", 2, 1000, 16, 8, 128, True, 0),
            ("non_causal", 2, 4096, 16, 8, 128, False, 0),
            ("window", 2, 4096, 16, 8, 128, True, 1024), SMOKE_FLASH):
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn((b, h, s, d), dtype, dev, 4)
            k = _randn((b, kh, s, d), dtype, dev, 5)
            v = _randn((b, kh, s, d), dtype, dev, 6)
            kw = dict(causal=causal, window=window)
            design = fwd_design(fa, dtype, d)
            want = fa.flash_attention_ref(q, k, v, **kw)
            err = compare("flash_attention",
                          fwd_checked(fa, design, q, k, v, kw), want, dtype,
                          f"{label} {dtype}")
            es = q.element_size()
            nbytes = 2 * (b * h * s * d + b * kh * s * d) * es
            flops = 4 * b * h * d * flash_pairs(s, causal, window)
            fl = floor_ms(nbytes, flops)
            ms, call, top = timed(
                lambda: fa.flash_attention_cuda(q, k, v, **kw), 5,
                events=True, floor=fl)
            entries = (check_entries("flash_attention", top,
                                     FWD_ENTRIES[design], design,
                                     f"{label} {dtype}") if top else None)
            plain, plain_call = timed(
                lambda: fa.flash_attention_ref(q, k, v, **kw), 3, floor=fl)
            lib_kernel = None
            if window:
                lib, lib_call, lib_kernel = windowed_sdpa(
                    q, k, v, causal, window, want, fl)
            else:
                lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), 5, floor=fl)
            del want
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FLOPS[str(dtype).removeprefix("torch.")] * 1e3
            row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", call_ms=call,
                       plain_call_ms=plain_call, library_call_ms=lib_call,
                       design=design, ms_by_entry=entries,
                       library_kernel=lib_kernel)
            if label == ATTN_META["flash_attention"]["main"] \
                    and dtype == torch.bfloat16:
                out["flash_attention"].update(row)
            say(f"  flash_attention {label} B{b} S{s} H{h} KH{kh} D{d} "
                f"causal={causal} window={window}, {dtype} on the {design} "
                f"({entries}): max |diff| "
                f"{err:.3g}; device: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f}"
                f" TFLOP/s), plain {plain:.4f} ms, SDPA {lib} ms "
                f"({lib_kernel or 'its own mask'}); per call: "
                f"{call:.4f} / {plain_call:.4f} / {lib_call} ms; bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                f"{flops / 1e9:.2f} GFLOP) [{card}]")
            del q, k, v

    # the other families' head dims: flash at each model's prefill shape
    # and mask, and the design each ran
    for name, model, d, b, s, h, kh, causal, window in FLASH_NEW:
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn((b, h, s, d), dtype, dev, 7)
            k = _randn((b, kh, s, d), dtype, dev, 8)
            v = _randn((b, kh, s, d), dtype, dev, 9)
            kw = dict(causal=causal, window=window)
            design = fwd_design(fa, dtype, d)
            want = fa.flash_attention_ref(q, k, v, **kw)
            err = compare(name, fwd_checked(fa, design, q, k, v, kw), want,
                          dtype, f"{model} {dtype}")
            nbytes = 2 * (b * h * s * d + b * kh * s * d) * q.element_size()
            flops = 4 * b * h * d * flash_pairs(s, causal, window)
            fl = floor_ms(nbytes, flops)
            ms, call, top = timed(
                lambda: fa.flash_attention_cuda(q, k, v, **kw), 5,
                events=True, floor=fl)
            entries = (check_entries(name, top, FWD_ENTRIES[design], design,
                                     f"{model} {dtype}") if top else None)
            plain, plain_call = timed(
                lambda: fa.flash_attention_ref(q, k, v, **kw), 3, floor=fl)
            lib_kernel = None
            if window:
                lib, lib_call, lib_kernel = windowed_sdpa(
                    q, k, v, causal, window, want, fl)
            else:
                lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), 5, floor=fl)
            del want
            row = row_of(ms, call, plain, plain_call, lib, lib_call, nbytes,
                         flops, dtype)
            row.update(design=design, ms_by_entry=entries,
                       library_kernel=lib_kernel)
            if design == "tensor cores" and d in (112, 256):
                # D 256's two-stage geometry and D 112's zero-padded
                # boxes: registers (ptxas -v, when this run built the
                # library) and shared memory
                row.update(ptxas=PTXAS.get(f"flash_fwd_bf16<D={d}>"),
                           smem_bytes=FLASH_SMEM_BF16[d])
                say(f"  {name}: flash_fwd_bf16<D={d}> ptxas {row['ptxas']}, "
                    f"{row['smem_bytes']} B of dynamic shared memory")
            if dtype == torch.bfloat16:
                out[name].update(row)
            say(f"  {name} ({model}) B{b} S{s} H{h} KH{kh} causal={causal} "
                f"window={window}, {dtype} on the {design} ({entries}): max "
                f"|diff| {err:.3g}; device: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s; "
                f"{ms / lib:.2f}x SDPA), plain {plain:.4f} ms, SDPA {lib} "
                f"ms ({lib_kernel or 'its own mask'}); per call: "
                f"{call:.4f} / "
                f"{plain_call:.4f} / {lib_call} ms; bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                f"{flops / 1e9:.2f} GFLOP) [{card}]")
            del q, k, v

    # paged at each model's decode shape: one 40-row page, lengths 1-40,
    # timed at 40; recurrentgemma's MQA (D 256) also over its full ring of
    # min(window, smax) = 2,048 rows (4 splits), at lengths on and around
    # the split boundaries and every 61st, timed at 2,048
    for name, model, d, h, kh in PAGED_NEW:
        bt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        spans = ((40, range(1, 41)),)
        if d == 256:
            ring = 2048
            spans += ((ring, sorted({1, 2, ring} | set(range(1, ring, 61))
                                    | {k * pa.SPLIT + e for k in (1, 2, 3)
                                       for e in (-1, 0, 1)})),)
        for span, lengths in spans:
            for dtype in (torch.bfloat16, torch.float32):
                q = _randn((1, h, d), dtype, dev, 10)
                kp = _randn((1, span, kh, d), dtype, dev, 11)
                vp = _randn((1, span, kh, d), dtype, dev, 12)
                err = 0.0
                for n in lengths:
                    ln = torch.full((1,), n, dtype=torch.int32, device=dev)
                    got, plan = planned(
                        f"{model} span {span}",
                        lambda: pa.paged_attention_cuda(q, kp, vp, bt, ln), 1,
                        kh, h // kh, span)
                    err = max(err, compare(
                        name, got, pa.paged_attention_ref(q, kp, vp, bt, ln),
                        dtype, f"{model} span {span} length {n} {dtype}"))
                args = (q, kp, vp, bt, ln)
                es = q.element_size()
                nbytes = 2 * span * kh * d * es + 2 * h * d * es + 4 + 4
                fl = floor_ms(nbytes, 4 * span * h * d)
                ms, call = timed(lambda: pa.paged_attention_cuda(*args), 20,
                                 floor=fl)
                plain, plain_call = timed(
                    lambda: pa.paged_attention_ref(*args), 5, floor=fl)
                lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kp.transpose(1, 2), vp.transpose(1, 2),
                    enable_gqa=True), 20, floor=fl)
                row = row_of(ms, call, plain, plain_call, lib, lib_call,
                             nbytes, 4 * span * h * d, dtype)
                row["plan"] = plan
                if dtype == torch.bfloat16:
                    if span == 40:
                        out[name].update(row)
                    else:
                        out[name]["ring"] = dict(row, span=span)
                say(f"  {name} ({model}) B1 H{h} KH{kh} page {span} x 1 "
                    f"({plan}), {len(lengths)} lengths up to {span}, "
                    f"{dtype}: max |diff| {err:.3g}; device at length "
                    f"{span}: kernel {ms:.5f} ms, plain {plain:.5f} ms, "
                    f"SDPA {lib:.5f} ms; per call: {call:.5f} / "
                    f"{plain_call:.5f} / {lib_call:.5f} ms; bound "
                    f"{row['bound_ms']:.6f} ms ({row['bound_by']}) [{card}]")
                del q, kp, vp

    # phase 17's serve_kv_cache decode (SMOKE_PAGED): B 1, one page of
    # smax rows, every length 1-smax
    label, h, kh, d, span = SMOKE_PAGED
    bt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        q = _randn((1, h, d), dtype, dev, 13)
        kp = _randn((1, span, kh, d), dtype, dev, 14)
        vp = _randn((1, span, kh, d), dtype, dev, 15)
        err = 0.0
        for n in range(1, span + 1):
            ln = torch.full((1,), n, dtype=torch.int32, device=dev)
            got, plan = planned(f"{label} {dtype}",
                                lambda: pa.paged_attention_cuda(q, kp, vp, bt,
                                                                ln),
                                1, kh, h // kh, span)
            err = max(err, compare(
                "paged_attention", got,
                pa.paged_attention_ref(q, kp, vp, bt, ln), dtype,
                f"{label} length {n} {dtype}"))
        say(f"  paged_attention {label} B1 H{h} KH{kh} D{d} page {span} x 1 "
            f"({plan}), lengths 1-{span}, {dtype}: max |diff| {err:.3g} "
            f"[{card}]")
        del q, kp, vp
    torch.cuda.empty_cache()
    phase1_between(dev, card, out, compare, planned, windowed_sdpa)
    phase1_any_head_dim(dev, card, out, compare, planned)
    phase1_backward(dev, card, out)
    return out


# the backward kernel against its plain version, both fed the kernel
# forward's output and lse: (rtol, atol as a share of max(1, max |want|)).
# f32: the two sum up to S products in other orders; bf16: both work in
# f32 from the same bf16 inputs and round once (an ulp or two, 2^-7
# relative each); the atol floor of 1 covers dS = P (dP - delta), which
# cancels (to 0 at S = 1) in unit-scale inputs
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -6, 1e-4)}
# the backward's cases: (label, B, S, H, KH, D, causal, window); the first
# is the training shape, whose bf16 numbers go into the kernel line
BWD_CASES = (("train", 2, 4096, 16, 8, 128, True, 0),
             ("non_causal", 2, 4096, 16, 8, 128, False, 0),
             ("window", 2, 4096, 16, 8, 128, True, 1024),
             ("ragged", 2, 1000, 16, 8, 128, True, 0),
             ("d32", 1, 512, 4, 2, 32, True, 0),
             ("d64", 1, 512, 4, 2, 64, False, 0),
             ("d80", 1, 512, 4, 4, 80, False, 0),
             ("d96", 1, 640, 8, 8, 96, True, 0),
             ("d256", 1, 1024, 4, 1, 256, True, 256),
             ("smoke_train",) + SMOKE_FLASH[1:])


# the entry functions of each design, as the profiler names them; the
# column passes run head dims past 256 in both dtypes
FWD_ENTRIES = {"tensor cores": ("flash_fwd_bf16",),
               "CUDA cores": ("flash_fwd_cc",),
               "column passes": ("flash_fwd_cols",)}
BWD_ENTRIES = {"tensor cores": ("flash_bwd_delta", "flash_bwd_dkdv_bf16",
                                "flash_bwd_dq_bf16"),
               "CUDA cores": ("flash_bwd_delta", "flash_bwd_dkdv<",
                              "flash_bwd_dq<"),
               "column passes": ("flash_bwd_delta", "flash_bwd_dkdv_cols",
                                 "flash_bwd_dq_cols")}
# the fourth launch of a dK/dV pass split over head groups (D 256)
BWD_REDUCE = "flash_bwd_reduce_bf16"


def _instance(fa, d: int):
    """The instance that runs head dim ``d`` (``instance_of``'s), or None
    past the widest (its column passes)."""
    return next((w for w in fa.INSTANCES if w >= d), None)


def fwd_design(fa, dtype, d: int) -> str:
    """The forward design the launcher runs for a dtype and head dim (its
    instance's; past the widest the column passes)."""
    if _instance(fa, d) is None:
        return "column passes"
    return ("tensor cores" if str(dtype) == "torch.bfloat16"
            and _instance(fa, d) in fa.FWD_TENSOR_CORE_DIMS
            else "CUDA cores")


def bwd_design(dtype_name: str, d: int) -> str:
    """The backward design the launcher runs for a dtype and head dim (its
    instance's; past the widest the column passes)."""
    from repro_torch.kernels.flash_attention import ops as fa
    if _instance(fa, d) is None:
        return "column passes"
    return ("tensor cores" if dtype_name == "bfloat16"
            and _instance(fa, d) in fa.BWD_TENSOR_CORE_DIMS
            else "CUDA cores")


def bwd_entries(design: str, plan) -> tuple:
    """The entries of a backward of ``design`` whose dK/dV pass ran
    ``plan`` (a ``BwdPlan``): the design's three, and the reduce launch
    when the pass was split over head groups."""
    return BWD_ENTRIES[design] + ((BWD_REDUCE,) if plan.head_groups > 1
                                  else ())


def new_tallies(counter, before: dict) -> dict:
    """What ``counter`` tallied since ``before`` (a copy of its
    ``by_size``): the dK/dV plans, the head-dim plans."""
    return {k: n - before.get(k, 0) for k, n in counter.by_size.items()
            if n > before.get(k, 0)}


def fwd_checked(fa, design: str, q, k, v, kw: dict):
    """One ``flash_attention_cuda`` call, which must report ``design``
    (``counter_tc`` and ``counter_cols`` count the launches it ran on the
    tensor cores and on the column passes)."""
    t0, c0 = fa.counter_tc.count, fa.counter_cols.count
    got = fa.flash_attention_cuda(q, k, v, **kw)
    ran = ("tensor cores" if fa.counter_tc.count > t0 else "column passes"
           if fa.counter_cols.count > c0 else "CUDA cores")
    check(ran == design, f"flash_attention D {q.shape[-1]} {q.dtype}: the "
                         f"launcher ran the {ran}, expected the {design}")
    return got


def attention_bound(nbytes: int, flops: int, dtype) -> tuple:
    """``(bound ms, "bytes" or "operations")``: the larger of ``nbytes``
    over the memory rate and ``flops`` over the peak rate of ``dtype``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                    else "operations")


# PyTorch's copy and fill kernels: a padded plan's glue around the kernels
GLUE = ("elementwise", "copy", "Copy", "fill", "Fill")


def check_entries(kernel: str, top, want: tuple, design: str, what: str,
                  may: tuple = ()) -> dict:
    """Check that the profiled GPU events ``top`` (``profile_device``'s)
    are the entries ``want`` of ``design`` and nothing else but names
    holding one of ``may``; returns ``{entry: ms a call}``."""
    found = {w: sum(ms for name, ms, _ in top if w in name) for w in want}
    others = [name for name, _, _ in top
              if not any(w in name for w in want + may)]
    check(all(n in " ".join(name for name, _, _ in top) for n in want)
          and not others,
          f"{kernel} {what}: expected the {design} entries {want}, the "
          f"profiler saw {top}")
    return found


def phase1_backward(dev, card: str, out: dict) -> None:
    """``flash_attention_bwd`` against ``flash_attention_bwd_ref`` at
    ``BWD_CASES`` in bf16 and f32 (and the forward's ``lse`` against the
    plain version's), then at the families' training shapes
    (``BWD_NEW``), with kernel, plain, SDPA-backward and bound times and
    the design each ran (its entries checked in the profile: the tensor
    cores in bf16 at every D, the CUDA cores in f32), the dK/dV plan the
    launcher reported and each entry's time (the reduce's where the plan
    split the pass); fills ``out["flash_attention_bwd"]`` and the
    ``BWD_NEW`` rows.  A windowed
    case's SDPA backward takes the mask as a boolean ``attn_mask`` over
    k/v expanded to q's heads (timed, not checked)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa

    row_out = out["flash_attention_bwd"]
    cases = BWD_CASES + tuple((name, b, s, h, kh, d, causal, window)
                              for name, _, d, b, s, h, kh, causal, window
                              in BWD_NEW)
    for label, b, s, h, kh, d, causal, window in cases:
        # the kernel-line row this case's bf16 numbers fill, if any
        target = out.get("flash_attention_bwd" if label == "train"
                         else label)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            q = _randn((b, h, s, d), dtype, dev, 21)
            k = _randn((b, kh, s, d), dtype, dev, 22)
            v = _randn((b, kh, s, d), dtype, dev, 23)
            do = _randn((b, h, s, d), dtype, dev, 24)
            kw = dict(causal=causal, window=window)
            # the residuals training saves: lse and the f32 output, from
            # which the backward takes delta (the reference's f32 out)
            o16, lse, o = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                  **kw)
            check(o.dtype == torch.float32
                  and torch.equal(o.to(dtype), o16),
                  f"flash_attention {label} {dname}: the f32 output does "
                  f"not round to the output")
            _, lse_ref, _ = fa.flash_attention_ref(q, k, v,
                                                   return_lse=True, **kw)
            lse_err = float((lse - lse_ref).abs().max())
            check(lse_err <= 1e-5 + 1e-5 * float(lse_ref.abs().max()),
                  f"flash_attention lse {label} {dname}: max |diff| "
                  f"{lse_err}")
            del lse_ref, o16
            plans0 = dict(fa.counter_bwd_plan.by_size)
            tc0 = fa.counter_bwd_tc.count
            got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            ran = ("tensor cores" if fa.counter_bwd_tc.count > tc0
                   else "CUDA cores")
            check(ran == bwd_design(dname, d),
                  f"flash_attention_bwd {label} {dname}: the launcher ran "
                  f"the {ran}, expected the {bwd_design(dname, d)}")
            plans = list(new_tallies(fa.counter_bwd_plan, plans0))
            check(len(plans) == 1, f"flash_attention_bwd {label} {dname}: "
                                   f"plans {plans}")
            plan = plans[0]
            want = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
            rtol, atol = BWD_TOL[dname]
            err = 0.0
            for g, w, name in zip(got, want, ("dq", "dk", "dv")):
                check(g.dtype == dtype and g.shape == w.shape
                      and bool(torch.isfinite(g).all()),
                      f"flash_attention_bwd {label} {dname} {name}: dtype, "
                      f"shape or finiteness")
                diff = (g.float() - w.float()).abs()
                scale = max(float(w.float().abs().max()), 1.0)
                bad = int((diff > atol * scale
                           + rtol * w.float().abs()).sum())
                check(bad == 0, f"flash_attention_bwd {label} {dname} "
                                f"{name}: {bad} elements beyond rtol {rtol} "
                                f"/ atol {atol} x {scale:.3g} (max |diff| "
                                f"{float(diff.max())})")
                err = max(err, float(diff.max()))
            for r in {id(row_out): row_out, id(target): target}.values():
                if r is not None:
                    r["max_abs_err"] = max(r["max_abs_err"], err)
            del got, want
            args = (q, k, v, o, do, lse)
            es = q.element_size()
            # q, dO, dQ and K, V, dK, dV in the input's type, the f32
            # output and lse
            nbytes = (3 * b * h * s * d + 4 * b * kh * s * d) * es \
                + 4 * b * h * s * d + 4 * b * h * s
            flops = 10 * b * h * d * flash_pairs(s, causal, window)
            fl = floor_ms(nbytes, flops)
            ms, call, top = timed(
                lambda: fa.flash_attention_bwd_cuda(*args, **kw), 3,
                events=True, floor=fl)
            design = bwd_design(dname, d)
            entries = (check_entries("flash_attention_bwd", top,
                                     bwd_entries(design, plan), design,
                                     f"{label} {dname}") if top else None)
            plain, plain_call = timed(
                lambda: fa.flash_attention_bwd_ref(*args, **kw), 2, floor=fl)
            if window:       # SDPA takes a window only as a mask
                pos = torch.arange(s, device=dev)
                keep = pos[None, :] > pos[:, None] - window
                if causal:
                    keep &= pos[None, :] <= pos[:, None]
                leaves = [x.detach().requires_grad_(True) for x in (
                    q, k.repeat_interleave(h // kh, 1),
                    v.repeat_interleave(h // kh, 1))]
                ref_out = F.scaled_dot_product_attention(*leaves,
                                                         attn_mask=keep)
                del keep
            else:
                leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
                ref_out = F.scaled_dot_product_attention(
                    *leaves, is_causal=causal, enable_gqa=True)
            lib, lib_call = timed(lambda: torch.autograd.grad(
                ref_out, leaves, do, retain_graph=True), 3, floor=fl)
            del leaves, ref_out
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FLOPS[dname] * 1e3
            row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", call_ms=call,
                       plain_call_ms=plain_call, library_call_ms=lib_call,
                       bound_f32_ms=flops / FLOPS["float32"] * 1e3,
                       design=design, ms_by_entry=entries,
                       plan=plan._asdict())
            if design == "tensor cores" and entries:
                # each pass's tile loads over its profiled time
                tiles = bwd_tile_bytes(b, s, h, kh, d, causal, window,
                                       plan.head_groups)
                row["tile_bytes_by_pass"] = tiles
                row["tile_tb_per_s_by_pass"] = {
                    p: n / (entries[f"flash_bwd_{p}_bf16"] * 1e-3) / 1e12
                    for p, n in tiles.items()
                    if entries[f"flash_bwd_{p}_bf16"] > 0}
            if target is not None and dtype == torch.bfloat16:
                target.update(row)
            say(f"  flash_attention_bwd {label} B{b} S{s} H{h} KH{kh} D{d} "
                f"causal={causal} window={window}, {dname} on the {design} "
                f"(dK/dV plan {tuple(plan)}; ms a call by entry {entries}): "
                f"max |diff| "
                f"{err:.3g} (lse {lse_err:.3g}); device: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
                f"SDPA backward {lib} ms; per call: {call:.4f} / "
                f"{plain_call:.4f} / {lib_call} ms; bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                f"{flops / 1e9:.2f} GFLOP; f32 CUDA-core bound "
                f"{row['bound_f32_ms']:.4f} ms)"
                + (f"; tile loads by pass {row['tile_bytes_by_pass']} B, "
                   f"{row['tile_tb_per_s_by_pass']} TB/s"
                   if "tile_bytes_by_pass" in row else "") + f" [{card}]")
            del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    flash_fn_backward(dev, card)


# the cases of tests/test_torch_kernel_designs.py's backward emulation
# (B, H, KH, S, D, causal, window), in which the bf16 residual put dq and
# dk elements beyond BWD_TOL of the f32 gradient
BWD_EMU_CASES = ((1, 4, 2, 512, 128, True, 0), (1, 4, 2, 512, 64, False, 0),
                 (1, 4, 2, 512, 128, True, 100), (1, 4, 2, 300, 64, True, 0),
                 (1, 4, 2, 512, 32, True, 0), (1, 4, 4, 256, 80, False, 0),
                 (1, 4, 4, 256, 96, True, 0), (1, 4, 1, 320, 256, True, 64))


def flash_fn_backward(dev, card: str) -> None:
    """``gqa_attention``'s gradients through ``_FlashFn`` on the card (the
    forward kernel's f32 output saved, delta taken from it) against the
    plain backward fed the plain forward's f32 output, at
    ``BWD_EMU_CASES`` in bf16: no element beyond ``BWD_TOL``."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.attention import gqa_attention

    rtol, atol = BWD_TOL["bfloat16"]
    for b, h, kh, s, d, causal, window in BWD_EMU_CASES:
        kw = dict(causal=causal, window=window)
        q, do = (_randn((b, h, s, d), torch.bfloat16, dev, i)
                 for i in (31, 34))
        k, v = (_randn((b, kh, s, d), torch.bfloat16, dev, i)
                for i in (32, 33))
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v)]
        out = gqa_attention(*leaves, **kw)
        got = [g.transpose(1, 2) for g in torch.autograd.grad(
            out, leaves, do.transpose(1, 2))]
        _, lse, o32 = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
        want = fa.flash_attention_bwd_ref(q, k, v, o32, do, lse, **kw)
        bad = []
        for g, w in zip(got, want):
            scale = max(float(w.float().abs().max()), 1.0)
            bad.append(int(((g.float() - w.float()).abs()
                            > atol * scale + rtol * w.float().abs()).sum()))
        check(bad == [0, 0, 0], f"_FlashFn backward B{b} H{h} KH{kh} S{s} "
                                f"D{d} causal={causal} window={window}: "
                                f"(dq, dk, dv) elements beyond BWD_TOL of "
                                f"the plain backward fed the f32 out: {bad}")
        say(f"  _FlashFn backward B{b} H{h} KH{kh} S{s} D{d} causal={causal}"
            f" window={window} (bf16, the f32 out saved): (dq, dk, dv) "
            f"elements beyond BWD_TOL of the plain backward {bad} [{card}]")


def published_head_dims(decode: bool) -> list:
    """The head dims of the registered configs at their published widths
    that have attention layers (and, with ``decode``, a decode step)."""
    from repro_torch.configs import ALL_ARCHS, get_config
    cfgs = [get_config(arch) for arch in ALL_ARCHS]
    return sorted({c.hd for c in cfgs if c.family != "ssm"
                   and (c.has_decode or not decode)})


def grads_beyond(got, want, dname: str):
    """``(bad, max |diff|)`` of the gradients ``got`` against ``want``:
    the elements of each of dq, dk, dv beyond ``BWD_TOL[dname]`` (atol as
    a share of max(1, max |want|)), after checking dtype, shape and
    finiteness."""
    import torch
    rtol, atol = BWD_TOL[dname]
    bad, err = [], 0.0
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"{name}: shape or finiteness")
        diff = (g.float() - w.float()).abs()
        scale = max(float(w.float().abs().max()), 1.0)
        bad.append(int((diff > atol * scale + rtol * w.float().abs()).sum()))
        err = max(err, float(diff.max()))
    return bad, err


def phase1_between(dev, card: str, out: dict, compare, planned,
                   windowed_sdpa) -> None:
    """The three attention kernels at head dims between their compiled
    instances (``BETWEEN``, ``PAGED_BETWEEN``) against their plain versions
    in bf16 and f32 at every mask (``compare``: ``ATT_TOL`` and, in bf16,
    two ulps; the backward within ``BWD_TOL``, fed the kernel forward's f32
    output and lse), every launch on the instance ``instance_of`` plans by
    the launcher's report (``counter_instance``, ``counter_bwd_instance``)
    and, in bf16, on the tensor cores (``counter_tc``,
    ``counter_bwd_tc``); paged every length of each span, on the grid the
    host plans (``planned``).  Kernel, SDPA (forward, backward, dense decode;
    a window as a boolean mask, ``windowed_sdpa``) and bound times at each
    row's first mask, the plain version's in bf16.  D 16's bf16 numbers
    fill the kernel table's D-16 rows; the others go under each kernel's
    row as ``between_instances``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    def keep(kernel, d, row):
        if d == 16:
            out[f"{kernel}_d16"].update(row)
        else:
            out[kernel].setdefault("between_instances", {})[f"d{d}"] = row

    for d, b, s, h, kh, window, model in BETWEEN:
        masks = ((True, window), (True, 0), (False, 0)) if d == 16 else \
            ((True, 0), (False, 0), (True, window))
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            w = fa.instance_of(d, dtype)
            design = fwd_design(fa, dtype, d)
            q, do = (_randn((b, h, s, d), dtype, dev, i) for i in (41, 44))
            k, v = (_randn((b, kh, s, d), dtype, dev, i) for i in (42, 43))
            name = f"flash_attention_d{d}" if d == 16 else "flash_attention"
            bname = ("flash_attention_bwd_d16" if d == 16
                     else "flash_attention_bwd")
            errs, berrs = [], []
            for causal, win in masks:
                kw = dict(causal=causal, window=win)
                what = f"D {d} (instance {w}) causal={causal} window={win} " \
                       f"{dname}"
                i0 = dict(fa.counter_instance.by_size)
                got = fwd_checked(fa, design, q, k, v, kw)
                check(new_tallies(fa.counter_instance, i0)
                      == {fa.plan_of(d, dtype): 1},
                      f"flash_attention {what}: the launcher ran "
                      f"{new_tallies(fa.counter_instance, i0)}")
                errs.append(compare(name, got, fa.flash_attention_ref(
                    q, k, v, **kw), dtype, what))
                _, lse, o = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                    **kw)
                i0 = dict(fa.counter_bwd_instance.by_size)
                t0 = fa.counter_bwd_tc.count
                got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
                ran = ("tensor cores" if fa.counter_bwd_tc.count > t0
                       else "CUDA cores")
                check(ran == bwd_design(dname, d)
                      and new_tallies(fa.counter_bwd_instance, i0)
                      == {fa.plan_of(d, dtype): 1},
                      f"flash_attention_bwd {what}: ran the {ran}, "
                      f"{new_tallies(fa.counter_bwd_instance, i0)}")
                bad, err = grads_beyond(got, fa.flash_attention_bwd_ref(
                    q, k, v, o, do, lse, **kw), dname)
                check(bad == [0, 0, 0], f"flash_attention_bwd {what}: "
                                        f"(dq, dk, dv) beyond BWD_TOL {bad}")
                out[bname]["max_abs_err"] = max(out[bname]["max_abs_err"],
                                                err)
                berrs.append(err)
                del got
            # timed at the first mask
            causal, win = masks[0]
            kw = dict(causal=causal, window=win)
            es = q.element_size()
            pairs = flash_pairs(s, causal, win)
            nbytes = 2 * (b * h * s * d + b * kh * s * d) * es
            flops = 4 * b * h * d * pairs
            fl = floor_ms(nbytes, flops)
            ms, call = timed(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                             5, floor=fl)
            plain, plain_call = (
                timed(lambda: fa.flash_attention_ref(q, k, v, **kw), 3,
                      floor=fl) if dtype == torch.bfloat16 else (None, None))
            lib_kernel = None
            if win:
                lib, lib_call, lib_kernel = windowed_sdpa(
                    q, k, v, causal, win, fa.flash_attention_ref(q, k, v,
                                                                 **kw), fl)
            else:
                lib, lib_call = timed(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True), 5,
                    floor=fl)
            bnd, by = attention_bound(nbytes, flops, dtype)
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by, call_ms=call, plain_call_ms=plain_call,
                       library_call_ms=lib_call, floor_ms=fl, instance=w,
                       design=design, library_kernel=lib_kernel,
                       masks=[list(m) for m in masks], model=model)
            # the backward at the same mask
            _, lse, o = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                **kw)
            args = (q, k, v, o, do, lse)
            bbytes = (3 * b * h * s * d + 4 * b * kh * s * d) * es \
                + 4 * b * h * s * d + 4 * b * h * s
            bflops = 10 * b * h * d * pairs
            bfl = floor_ms(bbytes, bflops)
            bms, bcall = timed(
                lambda: fa.flash_attention_bwd_cuda(*args, **kw), 3,
                floor=bfl)
            bplain, bplain_call = (
                timed(lambda: fa.flash_attention_bwd_ref(*args, **kw), 2,
                      floor=bfl) if dtype == torch.bfloat16 else (None, None))
            kk, vv = (x.repeat_interleave(h // kh, 1) for x in (k, v))
            leaves = [x.detach().requires_grad_(True) for x in (q, kk, vv)]
            if win:
                pos = torch.arange(s, device=dev)
                mask = pos[None, :] > pos[:, None] - win
                if causal:
                    mask &= pos[None, :] <= pos[:, None]
                ref_out = F.scaled_dot_product_attention(*leaves,
                                                         attn_mask=mask)
            else:
                ref_out = F.scaled_dot_product_attention(*leaves,
                                                         is_causal=causal)
            blib, blib_call = timed(lambda: torch.autograd.grad(
                ref_out, leaves, do, retain_graph=True), 3, floor=bfl)
            del leaves, ref_out, kk, vv
            bbnd, bby = attention_bound(bbytes, bflops, dtype)
            brow = dict(ms=bms, plain_ms=bplain, library_ms=blib,
                        bound_ms=bbnd, bound_by=bby, call_ms=bcall,
                        plain_call_ms=bplain_call, library_call_ms=blib_call,
                        floor_ms=bfl, instance=w,
                        design=bwd_design(dname, d),
                        masks=[list(m) for m in masks], model=model)
            if dtype == torch.bfloat16:
                keep("flash_attention", d, row)
                keep("flash_attention_bwd", d, brow)
            say(f"  flash_attention D {d} on its {w}-column instance "
                f"({model or 'no registered config'}) B{b} S{s} H{h} KH{kh} "
                f"{dname} on the {design}, masks {masks}: max |diff| "
                f"{[round(e, 6) for e in errs]}; timed causal={causal} "
                f"window={win}: device: kernel {ms:.5f} ms, plain {plain} ms, "
                f"SDPA {lib:.5f} ms ({lib_kernel or 'its own mask'}); bound "
                f"{bnd:.6f} ms ({by}; floor {fl:.6f} ms) [{card}]")
            say(f"  flash_attention_bwd D {d} on its {w}-column instance, "
                f"{dname} on the {brow['design']}, masks {masks}: max |diff| "
                f"{[round(e, 6) for e in berrs]} (BWD_TOL); timed at the "
                f"first: device: kernel {bms:.5f} ms, plain {bplain} ms, SDPA "
                f"backward {blib:.5f} ms; bound {bbnd:.6f} ms ({bby}; floor "
                f"{bfl:.6f} ms) [{card}]")
            del q, k, v, do, o, lse

    bt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    for d, h, kh, spans, model in PAGED_BETWEEN:
        name = "paged_attention_d16" if d == 16 else "paged_attention"
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            w = pa.instance_of(d, dtype)
            for span in spans:
                q = _randn((1, h, d), dtype, dev, 45)
                kp, vp = (_randn((1, span, kh, d), dtype, dev, i)
                          for i in (46, 47))
                i0 = dict(pa.counter_instance.by_size)
                err = 0.0
                for n in range(1, span + 1):
                    ln = torch.full((1,), n, dtype=torch.int32, device=dev)
                    got, plan = planned(
                        f"D {d} span {span} {dname}",
                        lambda: pa.paged_attention_cuda(q, kp, vp, bt, ln),
                        1, kh, h // kh, span)
                    err = max(err, compare(
                        name, got, pa.paged_attention_ref(q, kp, vp, bt, ln),
                        dtype, f"D {d} span {span} length {n} {dname}"))
                check(new_tallies(pa.counter_instance, i0)
                      == {pa.plan_of(d, dtype): span},
                      f"paged_attention D {d}: the launcher ran "
                      f"{new_tallies(pa.counter_instance, i0)}")
                paged_lse_check((q, kp, vp, bt, ln),
                                f"D {d} span {span} {dname}")
                msg = (f"  paged_attention D {d} on its {w}-column instance "
                       f"({model or 'no registered config'}) B1 H{h} KH{kh} "
                       f"page {span} x 1 ({plan}), lengths 1-{span}, {dname}: "
                       f"max |diff| {err:.3g}")
                if span == spans[0]:
                    args = (q, kp, vp, bt, ln)
                    es = q.element_size()
                    nbytes = 2 * span * kh * d * es + 2 * h * d * es + 8
                    flops = 4 * span * h * d
                    fl = floor_ms(nbytes, flops)
                    ms, call = timed(lambda: pa.paged_attention_cuda(*args),
                                     20, floor=fl)
                    plain, plain_call = (
                        timed(lambda: pa.paged_attention_ref(*args), 5,
                              floor=fl)
                        if dtype == torch.bfloat16 else (None, None))
                    lib, lib_call = timed(
                        lambda: F.scaled_dot_product_attention(
                            q[:, :, None], kp.transpose(1, 2),
                            vp.transpose(1, 2), enable_gqa=True), 20,
                        floor=fl)
                    bnd, by = attention_bound(nbytes, flops, dtype)
                    if dtype == torch.bfloat16:
                        keep("paged_attention", d, dict(
                            ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=bnd, bound_by=by, call_ms=call,
                            plain_call_ms=plain_call,
                            library_call_ms=lib_call, floor_ms=fl,
                            instance=w, plan=plan, model=model))
                    msg += (f"; device at length {span}: kernel {ms:.5f} ms, "
                            f"plain {plain} ms, SDPA {lib:.5f} ms; bound "
                            f"{bnd:.6f} ms ({by}; floor {fl:.6f} ms)")
                say(msg + f" [{card}]")
                del q, kp, vp
    torch.cuda.empty_cache()


def phase1_any_head_dim(dev, card: str, out: dict, compare,
                        planned) -> None:
    """The three attention kernels at head dims whose rows are not whole
    16-byte chunks, on a view off 16-byte boundaries and past 256
    (``ANY_D``; ROADMAP C4) against their plain versions at every mask
    (``compare``; the backward within ``BWD_TOL``, fed the kernel
    forward's f32 output and lse, and the same bits again), every launch
    on the plan ``plan_of`` gives by the launchers' reports
    (``counter_instance``, ``counter_bwd_instance``; paged's element loads
    by ``counter_narrow``) and on its design's entries by the profiler.
    Kernel, plain, SDPA (forward, backward, dense decode) and bound times
    at one mask (causal) and the 40-row slot's length 40.  The bf16 rows
    of ``HEAD_DIM_RUNS``' dims fill their kernel-table rows; the others go
    under each kernel's row as ``any_head_dim``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    def keep(kernel, d, dname, view, row):
        name = f"{kernel}_d{d}"
        if name in ATTN_META and dname == "bfloat16" and not view:
            out[name].update(row)
        else:
            key = f"d{d}_{dname}" + ("_view" if view else "")
            out[kernel].setdefault("any_head_dim", {})[key] = row

    b, s, h, kh, window = ANY_D_SHAPE
    masks = ((True, 0), (False, 0), (True, window))
    bt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    t_start = time.perf_counter()
    for d, dname, view in ANY_D:
        dtype = getattr(torch, dname)

        def make(shape, seed):
            if not view:
                return _randn(shape, dtype, dev, seed)
            wide = _randn(shape[:-1] + (d + 2,), dtype, dev, seed)
            return wide[..., 1:d + 1]

        q, do = (make((b, h, s, d), i) for i in (51, 54))
        k, v = (make((b, kh, s, d), i) for i in (52, 53))
        plan = fa.plan_of(d, dtype, q, k, v)
        check(plan.padded == (view or d * q.element_size() % 16 != 0)
              and plan.passes == max(1, -(-d // 256)),
              f"flash_attention D {d} {dname}: plan {plan}")
        design = fwd_design(fa, dtype, d)
        bdesign = bwd_design(dname, d)
        name = (f"flash_attention_d{d}" if f"flash_attention_d{d}"
                in ATTN_META and dname == "bfloat16" and not view
                else "flash_attention")
        bname = name.replace("flash_attention", "flash_attention_bwd")
        errs, berrs = [], []
        for causal, win in masks:
            kw = dict(causal=causal, window=win)
            what = f"D {d} {dname}{' view' if view else ''} {plan} {kw}"
            i0 = dict(fa.counter_instance.by_size)
            got = fwd_checked(fa, design, q, k, v, kw)
            check(new_tallies(fa.counter_instance, i0) == {plan: 1},
                  f"flash_attention {what}: the launcher ran "
                  f"{new_tallies(fa.counter_instance, i0)}")
            errs.append(compare(name, got, fa.flash_attention_ref(
                q, k, v, **kw), dtype, what))
            _, lse, o = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                **kw)
            _, lse_ref, o_ref = fa.flash_attention_ref(q, k, v,
                                                       return_lse=True, **kw)
            lerr = float((lse - lse_ref).abs().max())
            oerr = float((o - o_ref).abs().max())
            check(lerr <= 1e-4 and oerr <= ATT_TOL[dname],
                  f"flash_attention {what}: lse off by {lerr}, the f32 "
                  f"output by {oerr}")
            i0 = dict(fa.counter_bwd_instance.by_size)
            c0 = fa.counter_bwd_cols.count
            got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            ran = new_tallies(fa.counter_bwd_instance, i0)
            cols = fa.counter_bwd_cols.count - c0
            check(ran == {plan: 1} and cols == (plan.passes > 1),
                  f"flash_attention_bwd {what}: ran {ran}, {cols} on the "
                  f"column passes")
            again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"flash_attention_bwd {what}: another run gave other "
                  f"bits")
            bad, err = grads_beyond(got, fa.flash_attention_bwd_ref(
                q, k, v, o, do, lse, **kw), dname)
            check(bad == [0, 0, 0], f"flash_attention_bwd {what}: "
                                    f"(dq, dk, dv) beyond BWD_TOL {bad}")
            out[bname]["max_abs_err"] = max(out[bname]["max_abs_err"], err)
            berrs.append(err)
            del got, again
        # timed causal
        kw = dict(causal=True, window=0)
        es = q.element_size()
        pairs = flash_pairs(s, True, 0)
        nbytes = 2 * (b * h * s * d + b * kh * s * d) * es
        flops = 4 * b * h * d * pairs
        fl = floor_ms(nbytes, flops)
        ms, call, top = timed(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                              3, events=True, floor=fl)
        check_entries("flash_attention", top, FWD_ENTRIES[design], design,
                      f"D {d} {dname}", GLUE if plan.padded else ())
        plain, plain_call = timed(
            lambda: fa.flash_attention_ref(q, k, v, **kw), 2, floor=fl)
        # the library on dense copies: its kernels assume aligned rows
        dense = [x.contiguous() for x in (q, k, v)]
        lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
            *dense, is_causal=True, enable_gqa=True), 3, floor=fl)
        del dense
        bnd, by = attention_bound(nbytes, flops, dtype)
        keep("flash_attention", d, dname, view, dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
            call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
            floor_ms=fl, plan=list(plan), design=design,
            masks=[list(m) for m in masks]))
        _, lse, o = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        args = (q, k, v, o, do, lse)
        bbytes = (3 * b * h * s * d + 4 * b * kh * s * d) * es \
            + 4 * b * h * s * d + 4 * b * h * s
        bflops = 10 * b * h * d * pairs
        bfl = floor_ms(bbytes, bflops)
        bms, bcall, btop = timed(
            lambda: fa.flash_attention_bwd_cuda(*args, **kw), 2, events=True,
            floor=bfl)
        # the five longest events: the delta launch may fall out of them
        check_entries("flash_attention_bwd", btop, BWD_ENTRIES[bdesign][1:],
                      bdesign, f"D {d} {dname}",
                      BWD_ENTRIES[bdesign][:1] + (GLUE if plan.padded
                                                  else ()))
        bplain, bplain_call = timed(
            lambda: fa.flash_attention_bwd_ref(*args, **kw), 2, floor=bfl)
        # SDPA's backward on dense copies (cuDNN's refuses the views)
        kk, vv = (x.repeat_interleave(h // kh, 1) for x in (k, v))
        leaves = [x.detach().contiguous().requires_grad_(True)
                  for x in (q, kk, vv)]
        ref_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        dod = do.contiguous()
        blib, blib_call = timed(lambda: torch.autograd.grad(
            ref_out, leaves, dod, retain_graph=True), 2, floor=bfl)
        del leaves, ref_out, kk, vv
        bbnd, bby = attention_bound(bbytes, bflops, dtype)
        keep("flash_attention_bwd", d, dname, view, dict(
            ms=bms, plain_ms=bplain, library_ms=blib, bound_ms=bbnd,
            bound_by=bby, call_ms=bcall, plain_call_ms=bplain_call,
            library_call_ms=blib_call, floor_ms=bfl, plan=list(plan),
            design=bdesign, masks=[list(m) for m in masks]))
        viewed = " (a view off 16-byte rows)" if view else ""
        say(f"  flash_attention D {d} {dname}{viewed} plan {tuple(plan)} on "
            f"the {design}, B{b} S{s} H{h} KH{kh}, "
            f"masks {masks}: max |diff| {[round(e, 6) for e in errs]}; "
            f"causal: kernel {ms:.5f} ms, plain {plain:.5f} ms, SDPA "
            f"{lib:.5f} ms, bound {bnd:.6f} ms ({by}); backward on the "
            f"{bdesign}: max |diff| {[round(e, 6) for e in berrs]}, kernel "
            f"{bms:.5f} ms, plain {bplain:.5f} ms, SDPA backward "
            f"{blib:.5f} ms, bound {bbnd:.6f} ms ({bby}) [{card}]")
        del q, k, v, do, o, lse, args

        # paged: the 40-row slot at every length, then a 4,096-row page
        pplan = pa.plan_of(d, dtype)
        qd = make((1, h, d), 55)
        pname = (f"paged_attention_d{d}" if f"paged_attention_d{d}"
                 in ATTN_META and dname == "bfloat16" and not view
                 else "paged_attention")
        for span in (40, 4096):
            kp, vp = (make((1, span, kh, d), i) for i in (56, 57))
            narrow = not (build.rows16(kp) and build.rows16(vp))
            i0, n0 = dict(pa.counter_instance.by_size), pa.counter_narrow.count
            err = 0.0
            lengths = range(1, 41) if span == 40 else (4096,)
            for n in lengths:
                ln = torch.full((1,), n, dtype=torch.int32, device=dev)
                got, pl = planned(
                    f"D {d} {dname} span {span}",
                    lambda: pa.paged_attention_cuda(qd, kp, vp, bt, ln),
                    1, kh, h // kh, span, pplan.passes)
                err = max(err, compare(
                    pname, got, pa.paged_attention_ref(qd, kp, vp, bt, ln),
                    dtype, f"D {d} {dname} span {span} length {n}"))
            ran = new_tallies(pa.counter_instance, i0)
            check(ran == {pplan: len(lengths)}
                  and pa.counter_narrow.count - n0 == narrow * len(lengths),
                  f"paged_attention D {d} {dname} span {span}: the launcher "
                  f"ran {ran}, {pa.counter_narrow.count - n0} with element "
                  f"loads (expected {narrow})")
            paged_lse_check((qd, kp, vp, bt, ln),
                            f"D {d} {dname} span {span}")
            msg = (f"  paged_attention D {d} {dname} plan {tuple(pplan)}"
                   f"{', element loads' if narrow else ''}, B1 H{h} KH{kh} "
                   f"page {span} x 1 ({pl}), lengths "
                   f"{'1-40' if span == 40 else span}: max |diff| {err:.3g}")
            if span == 40:
                args = (qd, kp, vp, bt, ln)
                es = qd.element_size()
                nbytes = 2 * span * kh * d * es + 2 * h * d * es + 8
                flops = 4 * span * h * d
                fl = floor_ms(nbytes, flops)
                ms, call, top = timed(lambda: pa.paged_attention_cuda(*args),
                                      10, events=True, floor=fl)
                check_entries("paged_attention", top, ("paged_cols_kernel",),
                              "column passes", f"D {d} {dname}")
                plain, plain_call = timed(
                    lambda: pa.paged_attention_ref(*args), 3, floor=fl)
                dense = [qd[:, :, None].contiguous(),
                         kp.transpose(1, 2).contiguous(),
                         vp.transpose(1, 2).contiguous()]
                lib, lib_call = timed(
                    lambda: F.scaled_dot_product_attention(
                        *dense, enable_gqa=True), 10, floor=fl)
                del dense
                bnd, by = attention_bound(nbytes, flops, dtype)
                keep("paged_attention", d, dname, view, dict(
                    ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                    bound_by=by, call_ms=call, plain_call_ms=plain_call,
                    library_call_ms=lib_call, floor_ms=fl, plan=list(pplan),
                    grid=pl, narrow=narrow))
                msg += (f"; at length 40: kernel {ms:.5f} ms, plain "
                        f"{plain:.5f} ms, SDPA {lib:.5f} ms; bound "
                        f"{bnd:.6f} ms ({by})")
            say(msg + f" [{card}]")
            del kp, vp
    say(f"  (any head dim rows: {time.perf_counter() - t_start:.1f} s)")
    torch.cuda.empty_cache()


def c4_seeded(dev, card: str) -> None:
    """ROADMAP C4's seeded inputs through the model's attention on the
    card against the same calls on the CPU (the plain versions, which
    tests/test_torch_attention.py and tests/test_torch_head_dim_any.py
    hold to the reference): ``gqa_attention`` on bf16 q (1, 128, 4, D) and
    k/v (1, 128, 1, D) from ``default_rng(0)``, causal, within ``ATT_TOL``
    and two bf16 ulps; its gradients through ``_FlashFn`` within
    ``BWD_TOL``; ``decode_attention`` of the last query over the 128 rows;
    at D 20 and 264."""
    import numpy as np
    import torch
    from repro_torch.models import attention as att
    shapes = ((1, 128, 4), (1, 128, 1), (1, 128, 1), (1, 128, 4))
    for d in HEAD_DIM_RUNS["dims"]:
        rng = np.random.default_rng(0)
        arrs = [rng.standard_normal(sh + (d,)).astype(np.float32)
                for sh in shapes]
        res = {}
        for where in (dev, torch.device("cpu")):
            q, k, v, do = (torch.from_numpy(a).to(where, torch.bfloat16)
                           for a in arrs)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = att.gqa_attention(*leaves)
            grads = torch.autograd.grad(out, leaves, do)
            res[where.type] = (out.detach(), grads,
                               att.decode_attention(q[:, -1:], k, v, 128))
        (og, gg, dg), (oc, gc, dc) = res["cuda"], res["cpu"]
        errs = []
        for what, got, want in (("gqa_attention", og, oc),
                                ("decode_attention", dg, dc)):
            g, w = got.float().cpu(), want.float()
            diff = (g - w).abs()
            errs.append(float(diff.max()))
            check(got.shape == want.shape and got.dtype == torch.bfloat16
                  and not bool((diff > ATT_TOL["bfloat16"] * (1 + w.abs()))
                               .any())
                  and not bool((diff > 1e-5 + BF16_ULPS2 * w.abs()).any()),
                  f"C4 D {d} {what}: card vs CPU max |diff| {errs[-1]}")
        bad, gerr = grads_beyond([x.cpu() for x in gg], gc, "bfloat16")
        check(bad == [0, 0, 0], f"C4 D {d} gradients: {bad} beyond BWD_TOL")
        say(f"  C4's seeded inputs at D {d} (bf16, default_rng(0)), card vs "
            f"CPU: gqa_attention max |diff| {errs[0]:.3g}, its gradients "
            f"{gerr:.3g} (BWD_TOL), decode_attention {errs[1]:.3g} [{card}]")


# ---------------------------------------------------------------------------
# phases 2-3: the committed benchmark configurations, bit for bit
# ---------------------------------------------------------------------------

def modeled_row(runner, cfg, p, kinds, res, io, n_ops, scan_counts=None):
    d = io.as_dict()
    d.update(runner.modeled_throughput(io, p, n_ops=n_ops))
    lat = runner.modeled_latency(cfg, kinds, res, p, scan_counts=scan_counts)
    d.update({f"modeled_{k}": v
              for k, v in runner.latency_stats(lat).as_dict().items()})
    return d


def phase2_engine_json(dev, card: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import runner
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import SyncMode
    from repro_torch.kernels.wc_combine import ops as wcc
    from repro_torch.stores import PointerArray
    from repro_torch.workloads.ycsb import WORKLOADS, generate_window_stream

    ref = json.loads((ROOT / "BENCH_engine.json").read_text())
    c = ref["config"]
    n_slots, b, windows = c["n_slots"], c["batch"], c["windows"]
    p = SimParams()
    ops = generate_window_stream(WORKLOADS[c["workload"]], windows, b,
                                 n_slots, b)
    stream = runner.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                                n_cns=c["n_cns"], device=dev)
    keys = np.arange(n_slots)
    walls = {}
    for name in MODES:
        mode = SyncMode[name]
        runs = {}
        for backend in ("auto", "auto", "torch"):
            pa = PointerArray.create(n_slots, mode=mode, device=dev,
                                     kernel_backend=backend).populate(keys, keys)
            before = wcc.counter.count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pa, res, io = pa.apply_stream(stream)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launched = wcc.counter.count - before
            if backend == "auto":
                check(launched == windows, f"engine_json/{name}: wc_combine "
                      f"launched {launched} times, expected {windows}")
                walls[name] = dt        # the second (warm) run's time stays
            else:
                check(launched == 0, "kernel_backend='torch' launched kernels")
            runs[backend] = (res, modeled_row(runner, pa.cfg, p, ops.kinds,
                                              res, io, windows * b))
        row = runs["auto"][1]
        for k, v in ref[name].items():
            if k in ("throughput_mops", "wall_s"):
                continue            # the reference's CPU wall-clock
            check(row.get(k) == v, f"engine_json/{name}: {k} = {row.get(k)}, "
                                   f"BENCH_engine.json has {v}")
        check(runs["torch"][1] == row, f"engine_json/{name}: plain-version "
                                       f"bill differs from the kernels'")
        for f in dataclasses.fields(runs["auto"][0]):
            check(torch.equal(getattr(runs["auto"][0], f.name),
                              getattr(runs["torch"][0], f.name)),
                  f"engine_json/{name}: Results.{f.name} differs between the "
                  f"kernels and their plain versions")
        if name == "CIDER":
            pa = PointerArray.create(n_slots, mode=mode, device=dev).populate(
                keys, keys)
            busy, wall, top = profile_device(lambda: pa.apply_stream(stream),
                                             iters=3)
            plain_wall = walls[name] * 1e3
            idle = None if busy is None else 1.0 - busy / plain_wall
            say(f"  CIDER profile, {windows} windows: device busy {busy} ms; "
                f"wall {plain_wall} ms unprofiled, {wall} ms profiled; idle "
                f"share {idle} (busy over the unprofiled wall) [{card}]")
            for key, ms, count in top:
                say(f"    {ms:9.4f} ms  x{count // 3:5d}  {key}")
        say(f"  {name:6s} bill == BENCH_engine.json (modeled "
            f"{row['modeled_mops']} Mops/s, p50 {row['modeled_p50_us']} us, "
            f"p99 {row['modeled_p99_us']} us); wall {walls[name]:.4f} s = "
            f"{windows * b / walls[name]:.0f} ops/s [{card}]")
    return walls


def ycsb_rows(dev, c: dict, n_shards: int | None = None, profile=None):
    """``benchmarks/run.py::bench_ycsb_json``'s rows (workload -> mode ->
    row) for one topology: the single device (``n_shards`` None) or an
    ``n_shards``-way local mesh (``run_windows_sharded``).  Also returns
    each run's ``scan_probe`` launches, ``(workload, mode) -> count``.
    ``profile(label, fn)``, where given, is called once with a rerun of
    the A CIDER cell."""
    import numpy as np
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import EngineConfig, OpKind, SyncMode, to_numpy
    from repro_torch.dist import store as dstore
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.workloads.ycsb import YCSB, generate_ycsb_stream
    p = SimParams()
    pk = np.arange(c["n_keys"])
    rows, launches = {}, {}
    for wl, spec in YCSB.items():
        ops = generate_ycsb_stream(spec, c["windows"], c["batch"], c["n_keys"],
                                   c["n_clients"], seed=c["seed"])
        stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                    n_cns=c["n_cns"], device=dev)
        counts = np.where(ops.kinds == OpKind.SCAN, ops.values, 0)
        n_ops = int((ops.kinds != OpKind.NOP).sum())
        upd = ops.kinds == OpKind.UPDATE
        rows[wl] = {}
        for name in MODES:
            cfg = EngineConfig(n_slots=c["n_slots"], heap_slots=c["heap_slots"],
                               mode=SyncMode[name],
                               scan_max=c["scan_max"] if spec.scan > 0 else 0)
            cr = credit_init(c["credit_table"], dev)
            if n_shards is None:
                st = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
                run = functools.partial(runner.run_windows, cfg, st, cr,
                                        stream)
            else:
                run = functools.partial(
                    dstore.run_windows_sharded, cfg,
                    make_local_mesh(n_shards, dev),
                    _sharded_store(dev, cfg, n_shards, pk), cr, stream)
            before = sp.counter.count
            _, _, res, io = run()
            launches[(wl, name)] = sp.counter.count - before
            row = modeled_row(runner, cfg, p, ops.kinds, res, io, n_ops,
                              scan_counts=counts)
            row["rows"] = int(res.rows.sum().item())
            pess = to_numpy(res.pessimistic)
            row["pess_ratio"] = round(float((pess & upd).sum()
                                            / max(int(upd.sum()), 1)), 4)
            rows[wl][name] = row
            if profile and (wl, name) == ("A", "CIDER"):
                profile(f"YCSB A CIDER {run.func.__name__} ({n_shards or 1} "
                        f"shard(s), {c['windows']} windows)", run)
    return rows, launches


def check_ycsb(rows, launches, ref: dict, topo: str, n_shards: int) -> None:
    """``ycsb_rows`` against ``BENCH_ycsb.json``'s ``topo`` rows; E's runs
    launch ``scan_probe`` once a window on every shard, the others never."""
    windows = ref["config"]["windows"]
    for wl, by_mode in rows.items():
        for name, row in by_mode.items():
            _check_rows(row, ref["workloads"][wl][topo][name],
                        f"ycsb/{wl}/{topo}/{name}")
            want = windows * n_shards if wl == "E" else 0
            check(launches[(wl, name)] == want,
                  f"ycsb/{wl}/{topo}/{name}: scan_probe launched "
                  f"{launches[(wl, name)]} times, expected {want}")


def phase3_ycsb(dev, card: str) -> None:
    import torch
    ref = json.loads((ROOT / "BENCH_ycsb.json").read_text())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, launches = ycsb_rows(dev, ref["config"])
    torch.cuda.synchronize()
    check_ycsb(rows, launches, ref, "single", 1)
    say(f"  A-F x 4 modes == BENCH_ycsb.json single rows "
        f"({time.perf_counter() - t0:.3f} s for 24 x "
        f"{ref['config']['windows']} windows) [{card}]")


# ---------------------------------------------------------------------------
# phase 4: deployment scale against the oracle
# ---------------------------------------------------------------------------

def touched_keys(ops, scan_max: int):
    """Every key a stream reads or writes, scan ranges included."""
    import numpy as np
    from repro_torch.core.types import OpKind
    keys = [ops.keys.ravel()]
    is_scan = ops.kinds == OpKind.SCAN
    for j in range(1, scan_max):
        keys.append((ops.keys + j)[is_scan & (ops.values > j)])
    return np.unique(np.concatenate(keys))


@functools.lru_cache(maxsize=None)
def deployment_oracle(wl: str, n_keys: int, windows: int, batch: int,
                      n_cns: int):
    """YCSB ``wl``'s stream at deployment scale (seed 11, keys ``< n_keys``
    populated with themselves) and the sequential oracle's answers:
    ``(ops, touched keys, final key -> value map, ok, value, rows)``."""
    import numpy as np
    from repro_torch.core.oracle import OracleStore
    from repro_torch.workloads.ycsb import YCSB, generate_ycsb_stream
    spec = YCSB[wl]
    scan_max = spec.scan_max if spec.scan > 0 else 0
    ops = generate_ycsb_stream(spec, windows, batch, n_keys, n_cns, seed=11)
    keys = touched_keys(ops, spec.scan_max)
    oracle = OracleStore()
    pop = keys[keys < n_keys]
    oracle.populate(pop, pop)
    want = [oracle.apply(ops.kinds[w], ops.keys[w], ops.values[w],
                         scan_max=scan_max) + (oracle.rows.copy(),)
            for w in range(windows)]
    return (ops, keys, oracle.kv, np.stack([x[0] for x in want]),
            np.stack([x[1] for x in want]), np.stack([x[2] for x in want]))


def check_oracle(what: str, res, exists, val, oracle) -> None:
    """Every op's ``ok``/``value``/``rows`` and the final value of every
    touched key equal the oracle's (``deployment_oracle``)."""
    import numpy as np
    import torch
    from repro_torch.core.types import to_numpy
    _, keys, kv, want_ok, want_val, want_rows = oracle
    check(np.array_equal(to_numpy(res.ok), want_ok),
          f"{what}: ok differs from the oracle")
    check(np.array_equal(to_numpy(res.value), want_val),
          f"{what}: value differs from the oracle")
    check(np.array_equal(to_numpy(res.rows), want_rows),
          f"{what}: rows differ from the oracle")
    kt = keys[keys < exists.shape[0]]
    ki = torch.as_tensor(kt, device=exists.device).long()
    want_e = np.array([int(k) in kv for k in kt])
    want_v = np.array([kv.get(int(k), -1) for k in kt])
    check(np.array_equal(to_numpy(exists[ki]), want_e)
          and np.array_equal(to_numpy(val[ki]), want_v),
          f"{what}: final store differs from the oracle")


def phase4_deployment(dev, card: str, n_keys: int, windows: int, batch: int,
                      n_cns: int, credit_table: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import combine, engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.kernels.wc_combine import ops as wcc
    from repro_torch.core.types import EngineConfig, OpKind, SyncMode
    from repro_torch.workloads.ycsb import YCSB

    counters = {"wc_combine": wcc.counter, "scan_probe": sp.counter}
    n_slots = n_keys + windows * batch          # room for E's inserts
    heap_slots = n_slots + windows * batch
    out = {}
    for wl in ("A", "E"):
        spec = YCSB[wl]
        scan_max = spec.scan_max if spec.scan > 0 else 0
        oracle = deployment_oracle(wl, n_keys, windows, batch, n_cns)
        ops, keys = oracle[:2]
        stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                    n_cns=n_cns, device=dev)
        for name in ("CIDER", "MCS"):
            cfg = EngineConfig(n_slots=n_slots, heap_slots=heap_slots,
                               mode=SyncMode[name], scan_max=scan_max)
            torch.cuda.reset_peak_memory_stats()
            st = engine.populate(cfg, engine.store_init(cfg, dev),
                                 np.arange(n_keys), np.arange(n_keys))
            cr = credit_init(credit_table, dev)
            before = {k: c.count for k, c in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st1, cr1, res, io = runner.run_windows(cfg, st, cr, stream)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launched = {k: c.count - before[k] for k, c in counters.items()}
            busy, wall, top = profile_device(
                lambda: runner.run_windows(cfg, st, cr, stream), iters=1)
            check_oracle(f"deploy/{wl}/{name}", res,
                         *engine.store_view(st1), oracle)
            n_ops = int((ops.kinds != OpKind.NOP).sum())
            out[(wl, name)] = dict(s=dt, ops_per_s=n_ops / dt, peak=peak,
                                   mn_iops=io.as_dict()["mn_iops"])
            say(f"  {wl} {name:5s} {n_keys} keys, {windows}x{batch} ops: "
                f"{len(keys)} touched keys and every result == oracle; "
                f"{dt:.3f} s = {n_ops / dt:.0f} ops/s, peak "
                f"{peak / 2**30:.2f} GiB allocated, launches {launched} "
                f"[{card}]")
            say(f"    profiled rerun: device busy {busy} ms; wall {dt * 1e3} ms "
                f"unprofiled, {wall} ms profiled; idle share "
                f"{None if busy is None else 1 - busy / (dt * 1e3)} (busy over "
                f"the unprofiled wall)")
            for key, ms, count in top:
                say(f"    {ms:9.4f} ms  x{count:5d}  {key}")
    # the (n_slots * n_cns,) cell table of local write combining, alone
    lanes = torch.arange(batch, dtype=torch.int32, device=dev)
    wkeys = torch.as_tensor(ops.keys[0].astype(np.int32), device=dev)
    wcn = lanes // (batch // n_cns)
    mask = torch.ones(batch, dtype=torch.bool, device=dev)

    def table():
        return combine.local_executors_scatter(wkeys, wcn, lanes, mask,
                                               n_slots, n_cns)
    def fill():
        return torch.full((n_slots * n_cns,), -1, dtype=torch.int32,
                          device=dev)
    t_call = cuda_ms(table, iters=5, warmup=1)
    t_fill = cuda_ms(fill, iters=5, warmup=1)
    t_prof, _, _ = profile_device(table, iters=5)
    gib = n_slots * n_cns * 4 / 2**30
    say(f"  local-WC cell table {n_slots} slots x {n_cns} CNs = {gib:.2f} GiB "
        f"int32: {t_call} ms per call and {t_fill} ms for the fill alone "
        f"(CUDA events around back-to-back calls), {t_prof} ms summed by "
        f"the profiler; fill bound "
        f"{n_slots * n_cns * 4 / HBM_BYTES_PER_S * 1e3} ms; calls per "
        f"window: CIDER/OSYNC 1, MCS/SPIN 3 [{card}]")
    return out


# ---------------------------------------------------------------------------
# phases 5-6: the serving slice at the full width of qwen3-0.6b
# ---------------------------------------------------------------------------

def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _logits_close(got, want, what: str, argmax: bool = True):
    """Card logits against CPU (or prefill against decode) logits: within
    MODEL_RTOL / MODEL_ATOL, and, with ``argmax``, argmax agreeing on at
    least 90 % of rows.  Random weights give flat logits, and a few percent
    of the argmaxes are near-ties that rounding flips, so that share means
    something over 128 rows or more, not over a handful."""
    import torch
    g, w = got.float().cpu(), want.float().cpu()
    check(g.shape == w.shape, f"{what}: shapes {g.shape} vs {w.shape}")
    check(bool(torch.isfinite(g).all()), f"{what}: not finite")
    err = float((g - w).abs().max())
    bad = int(((g - w).abs() > MODEL_ATOL + MODEL_RTOL * w.abs()).sum())
    agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    check(bad == 0, f"{what}: {bad} logits beyond rtol {MODEL_RTOL} / atol "
                    f"{MODEL_ATOL} (max |diff| {err})")
    check(not argmax or agree >= 0.9, f"{what}: argmax agreement {agree}")
    return err, agree


def phase5_model(dev, card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model

    cfg = get_config("qwen3-0.6b")
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    say(f"  qwen3-0.6b at full width (L {cfg.n_layers}, d {cfg.d_model}, H "
        f"{cfg.n_heads}, KH {cfg.n_kv}, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}): random init on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}

    # prefill at B 2, S 4096
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 4096), generator=g, device=dev)
    f0 = fa.counter.count
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, toks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(fa.counter.count - f0 == 2 * cfg.n_layers,
          f"prefill launched flash_attention {fa.counter.count - f0} times")
    check(tuple(logits.shape) == (2, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    check(tuple(caches[0].shape) == (cfg.n_layers, 2, 4096, cfg.n_kv, cfg.hd),
          "prefill caches")
    del logits, caches
    busy, pwall, top = profile_device(lambda: model.prefill(params, toks),
                                      iters=1)
    out["prefill_s"] = walls[-1]
    say(f"  prefill B 2 x S 4096: {walls[-1] * 1e3:.1f} ms (first call "
        f"{walls[0] * 1e3:.1f} ms), {2 * 4096 / walls[-1]:.0f} tokens/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"profiled: device busy {busy} ms, wall {pwall} ms profiled; idle "
        f"share {None if busy is None else 1 - busy / (walls[-1] * 1e3)} "
        f"(busy over the unprofiled wall) [{card}]")
    for key, ms, count in top:
        say(f"    {ms:9.4f} ms  x{count:5d}  {key}")
    del toks
    torch.cuda.empty_cache()

    # the card against the same weights on the CPU: prefill of 64 tokens
    # of 8 sequences (its last logits, 8 rows, held to the tolerance
    # alone), then 16 decode steps from its caches, fed the same tokens
    # (128 rows, argmax agreement too)
    cpu = Model(cfg, device="cpu")
    params_cpu = _tree_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab, (8, 80), generator=g, device=dev)
    results = {}
    t0 = time.perf_counter()
    for name, m, p, tk in (("card", model, params, toks),
                           ("cpu", cpu, params_cpu, toks.cpu())):
        last, (ck, cv) = m.prefill(p, tk[:, :64])
        st = m.init_decode_state(8, 80)
        st["k"][:, :, :64] = ck
        st["v"][:, :, :64] = cv
        steps = []
        for t in range(64, 80):
            lg, st = m.decode_step(p, st, tk[:, t:t + 1], t)
            steps.append(lg[:, 0].cpu())
        results[name] = (last.cpu(), torch.stack(steps, 1))
    err_p, agree_p = _logits_close(results["card"][0], results["cpu"][0],
                                   "prefill(64) card vs CPU", argmax=False)
    err_d, agree_d = _logits_close(results["card"][1], results["cpu"][1],
                                   "16 decode steps card vs CPU")
    say(f"  card vs CPU (same weights; prefill 64 tokens + 16 decode steps, "
        f"B 8): max |diff| {err_p:.4f} / {err_d:.4f}, argmax agreement "
        f"{agree_p:.3f} / {agree_d:.3f} (rtol {MODEL_RTOL}, atol "
        f"{MODEL_ATOL}); {time.perf_counter() - t0:.1f} s")
    del params_cpu, cpu

    # prefill logits against token-by-token decode logits, on the card
    full, _, _ = tfm.forward(cfg, params, toks[:, :64])
    st = model.init_decode_state(8, 64)
    dec = []
    for t in range(64):
        lg, st = model.decode_step(params, st, toks[:, t:t + 1], t)
        dec.append(lg[:, 0])
    err, agree = _logits_close(torch.stack(dec, 1), full,
                               "decode vs prefill on the card")
    say(f"  decode vs prefill logits on the card (64 tokens, B 8): max "
        f"|diff| {err:.4f}, argmax agreement {agree:.3f}")

    # decode step time at the serve shape (B 1, Smax 40) and B 2
    for b in (1, 2):
        st = model.init_decode_state(b, 40)
        tk = toks[:b, :1]
        model.decode_step(params, st, tk, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(39):
            lg, st = model.decode_step(params, st, tk, t)
        int(lg.argmax())
        step = (time.perf_counter() - t0) / 39
        busy, pwall, top = profile_device(
            lambda: model.decode_step(params, st, tk, 20), iters=10)
        out[f"decode_ms_b{b}"] = step * 1e3
        say(f"  decode step B {b}, Smax 40: {step * 1e3:.3f} ms per step "
            f"(host clock, 39 steps); profiled: device busy {busy} ms, wall "
            f"{pwall} ms per step profiled; idle share "
            f"{None if busy is None else 1 - busy / (step * 1e3)} [{card}]")
        for key, ms, count in top:
            say(f"    {ms:9.4f} ms  x{count // 10:5d}  {key}")
    del params
    torch.cuda.empty_cache()
    return out


def phase6_serve(dev, card: str) -> dict:
    import torch
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.wc_combine import ops as wcc
    from repro_torch.launch import serve

    argv = ["--arch", "qwen3-0.6b"]
    p0, w0 = pa.counter.count, wcc.counter.count
    t0 = time.perf_counter()
    stats = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(stats == SERVE_STATS, f"serve stats {stats}, the reference's are "
                                f"{SERVE_STATS}")
    steps = 16 * (32 + 8 - 1)            # every prompt token + 7 decodes
    paged = pa.counter.count - p0
    check(paged == steps * 28, f"serve launched paged_attention {paged} "
                               f"times, expected {steps * 28}")
    check(wcc.counter.count - w0 > 0, "serve ran no wc_combine")
    say(f"  serve qwen3-0.6b (16 requests, 4 slots, prompt 32, shared 16, "
        f"max-new 8): stats {stats} == the reference's; {wall:.3f} s "
        f"(weights init included), {steps} decode steps = "
        f"{wall / steps * 1e3:.3f} ms per step, {16 * 8 / wall:.1f} generated"
        f" tokens/s; launches: paged_attention {paged}, wc_combine "
        f"{wcc.counter.count - w0} [{card}]")
    # the idle share on a 2-request stream (a trace of the whole serve
    # holds millions of events), against that stream's unprofiled wall
    # (host time varies between runs on a shared host: the least of three
    # unprofiled walls stands for the run)
    short = argv + ["--requests", "2"]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        serve.main(short)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy, pwall, top = profile_device(lambda: serve.main(short), iters=1)
    say(f"  serve, 2 requests: {walls} ms unprofiled, {pwall:.1f} ms "
        f"profiled; device busy {busy} ms; idle share "
        f"{None if busy is None else 1 - busy / min(walls)} (busy over the "
        f"least unprofiled wall) [{card}]")
    for key, ms, count in top:
        say(f"    {ms:9.4f} ms  x{count:5d}  {key}")
    serve_tokens_vs_cpu(dev, card)
    return {"serve_s": wall, "steps": steps}


def serve_tokens_vs_cpu(dev, card: str, n: int = 4) -> None:
    """The serve's greedy tokens against the CPU.  The serve loop runs the
    first ``n`` requests of ``serve.main``'s stream on the card with
    ``serve.main``'s weights (the seeded init; one request per B-1 slot, so
    these are the tokens ``serve.main`` generated for them).  The CPU runs
    the same weights over each prompt and its generated tokens (teacher
    forcing, one forward); at every generated position the card's token
    must be the CPU's argmax, or within the card-vs-CPU logit tolerance
    of it (a near-tie), and the argmax must agree on at least 90 %."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("qwen3-0.6b")
    prompt, max_new = 32, 8
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    sched = Scheduler(n_slots=4, n_pages=1024, page_size=serve.PAGE,
                      device=dev)
    reqs = serve.make_requests(cfg.vocab, 16, prompt, 16, max_new)[:n]
    for req in reqs:
        sched.submit(req)
    outs = serve.serve(model, params, sched, prompt + max_new)
    seqs = torch.as_tensor(np.stack([
        np.concatenate([r.tokens, outs[r.rid][:-1]]) for r in reqs]))
    t0 = time.perf_counter()
    logits, _, _ = tfm.forward(cfg, _tree_to(params, "cpu"), seqs)
    lg = logits[:, prompt - 1:].float()              # (n, max_new, V)
    chosen = torch.as_tensor([outs[r.rid] for r in reqs])
    top = lg.max(-1).values
    mine = lg.gather(-1, chosen[..., None])[..., 0]
    gap = top - mine
    allowed = 2 * MODEL_ATOL + MODEL_RTOL * (top.abs() + mine.abs())
    agree = float((gap == 0).float().mean())
    check(bool((gap <= allowed).all()),
          f"serve tokens: a card token is {float(gap.max())} below the CPU's "
          f"best logit, beyond the card-vs-CPU tolerance")
    check(agree >= 0.9, f"serve tokens: CPU argmax agreement {agree}")
    say(f"  serve greedy tokens of {n} requests x {max_new} vs the CPU "
        f"(same weights, teacher-forced): argmax agreement {agree:.3f}, "
        f"largest gap {float(gap.max()):.4f} (spread of the CPU logits: std "
        f"{float(lg.std(-1).mean()):.3f}); CPU forward "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


# ---------------------------------------------------------------------------
# phases 7-11: recovery, replication, dynamic scenarios, open loop, and
# crash recovery with MN replication at deployment scale
# ---------------------------------------------------------------------------
# The committed benchmarks' configurations (benchmarks/{recovery,replication,
# scenarios,scale}.py); the helpers below take ``dev`` so the CPU tests can
# run them at the benchmarks' FAST sizes against the reference.

RECOVERY_FULL = dict(windows=24, warm=8, batch=2048, n_keys=4096,
                     n_clients=64, n_cns=64, credit_table=4096, seed=7)
REPLICATION_FULL = dict(n_slots=65_536, batch=4096, windows=16)
SCENARIOS_FULL = dict(windows=32, batch=2048, n_keys=4096, n_clients=64,
                      n_cns=64, credit_table=4096, seed=3)
OPEN_LOOP_FULL = dict(slots1=131_072, lanes1=512, cns1=64, windows=12,
                      warmup=4, theta=0.99, seed=11, ol_mesh=8, ol_windows=16,
                      rhos=[0.5, 0.7, 0.85, 0.95, 1.05], mmpp_rho=0.85)
REF_SHARDS = 4      # the reference benchmarks' sharded4 mesh (heap_slots
                    # is rounded to it)
SURVIVORS = (0, 2)  # benchmarks/recovery.py: shards 1 and 3 die at the crash
CRASH_R, CRASH_DEAD = 3, (2,)   # benchmarks/replication.py's MN-crash cell


def _round4(x) -> list:
    import numpy as np
    return [round(float(v), 4) for v in np.asarray(x)]


def _io_host(io, sl=slice(None)):
    """A (W,)-leaf bill as an ``IOMetrics`` of numpy arrays, windows ``sl``."""
    from repro_torch.core.types import IOMetrics, to_numpy
    return IOMetrics(*(to_numpy(getattr(io, f.name))[sl]
                       for f in dataclasses.fields(IOMetrics)))


def _io_map(fn, io):
    from repro_torch.core.types import IOMetrics
    return IOMetrics(*(fn(getattr(io, f.name))
                       for f in dataclasses.fields(IOMetrics)))


def _check_trees(a, b, what: str) -> None:
    """Every tensor field of two dataclasses of tensors equal."""
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"{what}.{f.name} differs")


def _check_views(a, b, what: str) -> None:
    """Two stores' logical views (``engine.store_view``) equal."""
    from repro_torch.core import engine
    for x, y in zip(engine.store_view(a), engine.store_view(b)):
        check(bool((x == y).all()), f"{what}: store view differs")


def _check_rows(got: dict, want: dict, what: str, skip=()) -> None:
    """Every key of the committed row ``want`` (recursively) in ``got``."""
    for k, v in want.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            check(isinstance(got.get(k), dict), f"{what}: {k} missing")
            _check_rows(got[k], v, f"{what}/{k}")
        else:
            check(got.get(k) == v, f"{what}: {k} = {got.get(k)}, the "
                                   f"committed file has {v}")


def recovery_overrides(name: str, c: dict) -> dict:
    """``benchmarks/recovery.py::_overrides``: membership events placed
    past the warm-up windows."""
    warm, meas = c["warm"], c["windows"]
    if name == "crash_storm":
        return {"crash_window": warm + meas // 3}
    if name == "rolling_restart":
        return {"start": warm + 1}
    if name == "elastic_scale":
        return {"join_window": warm + meas // 3,
                "leave_window": warm + 2 * meas // 3}
    return {}


def recovery_metrics(cfg, c: dict, ops, run, crash_w, p) -> dict:
    """``benchmarks/recovery.py::_metrics`` over the port's ``RecoveryRun``:
    modeled metrics of the measured (post-warm) windows, the repair
    timeline and the per-window trajectories."""
    import numpy as np
    from repro_torch.core import runner
    from repro_torch.recovery import time_to_repair
    warm = c["warm"]
    kinds = np.asarray(ops.kinds)
    io_m = _io_host(run.io, slice(warm, None))
    io_sum = _io_map(lambda x: x.sum(), io_m)
    valid_m = run.valid[warm:]
    lat = runner.modeled_latency(cfg, kinds, run.results, p, valid=run.valid)
    lat_m = lat[warm:]
    n_w = valid_m.sum(-1)
    out = runner.modeled_throughput(io_sum, p, n_ops=int(n_w.sum()))
    out.update(runner.latency_stats(lat_m).as_dict())
    out.update(time_to_repair(run.io, crash_w))
    out["mn_iops"] = int(np.asarray(io_sum.mn_iops))
    out["recovery_overhead"] = round(
        int(io_sum.repair_cas) / max(int(np.asarray(io_sum.mn_iops)), 1), 6)
    post = lat[crash_w:] if crash_w is not None else lat_m
    out["p99_post_crash_us"] = round(float(np.nanpercentile(post, 99)), 2)
    mops_w = [runner.modeled_throughput(_io_map(lambda x, w=w: x[w], io_m), p,
                                        n_ops=int(n_w[w]))["modeled_mops"]
              for w in range(len(n_w))]
    out["windows"] = {
        "repair_cas": [int(v) for v in io_m.repair_cas],
        "orphan_windows": [int(v) for v in io_m.orphan_windows],
        "modeled_mops": _round4(mops_w),
        "p99_us": _round4(np.nanpercentile(lat_m, 99, axis=-1)),
    }
    return out


def recovery_setup(dev, c: dict, name: str, mode):
    """``(cfg, ops, schedule, stream, populated state, credits)`` of one
    recovery cell, as ``benchmarks/recovery.py`` builds it."""
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.types import EngineConfig
    from repro_torch.workloads.recovery import RECOVERY_SCENARIOS
    sc = RECOVERY_SCENARIOS[name]
    total = c["warm"] + c["windows"]
    ops, sched = sc.generate(total, c["batch"], c["n_keys"], c["n_clients"],
                             c["n_cns"], seed=c["seed"],
                             **recovery_overrides(name, c))
    heap = c["n_keys"] + total * c["batch"]
    heap += -heap % REF_SHARDS
    cfg = EngineConfig(n_slots=c["n_keys"], heap_slots=heap, mode=mode)
    stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                n_cns=c["n_cns"], alive=sched.alive,
                                device=dev)
    pk = sc.populate_keys(c["n_keys"])
    st = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
    return cfg, ops, sched, stream, st, credit_init(c["credit_table"], dev)


def recovery_failover(dev, c: dict, cfg, stream, single, crash_w: int,
                      what: str) -> dict:
    """``benchmarks/recovery.py``'s shard failover on the crash storm: a
    ``REF_SHARDS``-way store whose shards outside ``SURVIVORS`` die at the
    crash window, through ``run_recovery_sharded``; raises unless its
    results, every window's bill and the store view equal the
    single-device drop-mask run ``single``.  Returns the ``failover``
    sub-dict."""
    from repro_torch.core import engine
    from repro_torch.core.credits import credit_init
    from repro_torch.dist import store as dstore
    from repro_torch.recovery import FailoverEvent, run_recovery_sharded
    from repro_torch.workloads.recovery import RECOVERY_SCENARIOS
    pk = RECOVERY_SCENARIOS["crash_storm"].populate_keys(c["n_keys"])
    sst = dstore.sharded_populate(
        cfg, REF_SHARDS, dstore.sharded_store_init(cfg, REF_SHARDS, dev),
        pk, pk)
    run = run_recovery_sharded(cfg, REF_SHARDS, sst,
                               credit_init(c["credit_table"], dev), stream,
                               failovers=[FailoverEvent(crash_w, SURVIVORS)])
    _check_trees(run.io, single.io, f"{what}: failover IOMetrics vs the "
                                    f"single-device drop-mask run")
    _check_trees(run.results, single.results, f"{what}: failover Results")
    for x, y in zip(dstore.sharded_store_view(cfg, len(SURVIVORS), run.state),
                    engine.store_view(single.state)):
        check(bool((x == y).all()), f"{what}: failover store view differs")
    return {"asserted_equal": True, **run.recovery_io[0]}


def recovery_rows(dev, c: dict, profile=None) -> dict:
    """Every scenario x mode row of ``BENCH_recovery.json``'s schema from
    ``run_recovery`` on ``dev``, with the crash storm's ``failover``
    sub-dict from ``run_recovery_sharded`` (``recovery_failover``).
    ``profile(label, fn)``, where given, is called once with a rerun of the
    crash_storm CIDER cell."""
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import SyncMode
    from repro_torch.recovery import run_recovery
    from repro_torch.workloads.recovery import RECOVERY_SCENARIOS
    p = SimParams()
    out = {}
    for name in RECOVERY_SCENARIOS:
        modes = {}
        for mode in MODES:
            cfg, ops, sched, stream, st, cr = recovery_setup(
                dev, c, name, SyncMode[mode])
            run = run_recovery(cfg, st, cr, stream)
            modes[mode] = recovery_metrics(cfg, c, ops, run,
                                           sched.first_crash_window(), p)
            if name == "crash_storm":
                modes[mode]["failover"] = recovery_failover(
                    dev, c, cfg, stream, run, sched.first_crash_window(),
                    f"recovery/{name}/{mode}")
            if profile and (name, mode) == ("crash_storm", "CIDER"):
                profile(f"{name} {mode} run_recovery ({stream.shape[0]} "
                        f"windows)", functools.partial(run_recovery, cfg, st,
                                                       cr, stream))
        out[name] = {"crash_window": sched.first_crash_window(),
                     "modes": modes}
    return out


def replication_cell(cfg, kinds, res, io, p, n_ops: int) -> dict:
    """``benchmarks/replication.py::_cell`` over the summed bill ``io``:
    the bill, modeled throughput and latency percentiles."""
    from repro_torch.core import runner
    d = io.as_dict()
    d.update(runner.modeled_throughput(io, p, n_ops=n_ops))
    lat = runner.modeled_latency(cfg, kinds, res, p)
    d.update({f"modeled_{k}": v
              for k, v in runner.latency_stats(lat).as_dict().items()})
    return d


def replication_rows(dev, c: dict, modes=MODES, profile=None) -> dict:
    """The ``single`` rows of ``BENCH_replication.json`` for R in {1, 2, 3}
    x ``modes``, and its ``mn_crash`` cell through
    ``run_recovery_replicated``, held on the way to the segmented
    ``n_replicas``-swap run (results, bill, store view) and to the
    crash-free R = 3 run's pre-crash windows.  ``profile(label, fn)``, where
    given, is called once with a rerun of the CIDER ``mn_crash`` cell."""
    import numpy as np
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import SyncMode, per_replica_bill
    from repro_torch.recovery import mn_crash, run_recovery_replicated
    from repro_torch.stores import PointerArray
    from repro_torch.workloads.ycsb import WORKLOADS, generate_window_stream
    n_slots, b, windows = c["n_slots"], c["batch"], c["windows"]
    ops = generate_window_stream(WORKLOADS["write-intensive"], windows, b,
                                 n_slots, b)
    stream = runner.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                                n_cns=16, device=dev)
    pk = np.arange(n_slots)
    rows = {str(r): {} for r in (1, 2, 3)}
    io_one, io_r3 = {}, {}
    for r in (1, 2, 3):
        p = dataclasses.replace(SimParams(), n_replicas=r)
        for mode in modes:
            pa = PointerArray.create(n_slots, mode=SyncMode[mode], n_replicas=r,
                                     device=dev).populate(pk, pk)
            pa, res, io_w = pa.apply_stream(stream, io_per_window=True)
            io = _io_map(lambda x: x.sum(0), io_w)
            d = replication_cell(pa.cfg, ops.kinds, res, io, p, windows * b)
            if r == 1:
                io_one[mode] = io
            else:
                d["per_replica"] = per_replica_bill(io_one[mode], io, r)
            if r == CRASH_R:
                io_r3[mode] = io_w
            rows[str(r)][mode] = d
    crash = {}
    wc = windows // 2
    mn = mn_crash(windows, CRASH_R, dead_replicas=CRASH_DEAD, at_window=wc)
    p = dataclasses.replace(SimParams(), n_replicas=CRASH_R)
    for mode in modes:
        cfg = dataclasses.replace(
            PointerArray.create(n_slots, mode=SyncMode[mode], device=dev).cfg,
            n_replicas=CRASH_R)
        st = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
        run = run_recovery_replicated(cfg, st, credit_init(4096, dev), stream,
                                      mn)
        ref = segmented_swap_run(cfg, st, credit_init(4096, dev), stream, mn)
        what = f"mn_crash/{mode}"
        _check_trees(run.results, ref[2], f"{what}: Results")
        _check_trees(run.io, ref[3], f"{what}: IOMetrics")
        _check_views(run.state, ref[0], f"{what} vs the segmented run")
        _check_trees(_io_map(lambda x: x[:wc], run.io),
                     _io_map(lambda x: x[:wc], io_r3[mode]),
                     f"{what}: pre-crash windows vs crash-free R=3")
        io = _io_map(lambda x: x.sum(0), run.io)
        d = io.as_dict()
        d.update(runner.modeled_throughput(io, p, n_ops=windows * b))
        d["asserted_equal"] = True
        d["recovery_io"] = run.recovery_io[0]
        d["windows"] = {"mn_iops": [int(v) for v in run.io.mn_iops.cpu()]}
        crash[mode] = d
        if profile and mode == "CIDER":
            profile(f"mn_crash {mode} run_recovery_replicated ({windows} "
                    f"windows)", functools.partial(
                        run_recovery_replicated, cfg, st,
                        credit_init(4096, dev), stream, mn))
    return {"replicas": rows, "mn_crash": crash}


def segmented_swap_run(cfg, state, credits, stream, mn):
    """The reference ``run_recovery_replicated`` is held to: the same
    segments through ``runner.run_windows`` with ``n_replicas`` swapped and
    no promotion.  Returns ``(state, credits, results, io)`` with per-window
    leaves concatenated."""
    import torch
    from repro_torch.core import runner
    from repro_torch.recovery import slice_stream
    ress, ios, prev_alive = [], [], None
    for lo, hi, surv in mn.segments():
        seg = slice_stream(stream, lo, hi)
        state, credits, res, io = runner.run_windows(
            dataclasses.replace(cfg, n_replicas=len(surv)), state, credits,
            seg, io_per_window=True, prev_alive=prev_alive)
        prev_alive = seg.alive[-1]
        ress.append(res)
        ios.append(io)

    def cat(items):
        cls = type(items[0])
        return cls(*(torch.cat([getattr(x, f.name) for x in items])
                     for f in dataclasses.fields(cls)))
    return state, credits, cat(ress), cat(ios)


def scenario_cfg(mode, c: dict):
    from repro_torch.core.types import EngineConfig
    # benchmarks/scenarios.py::_cfg: the populate load plus one commit per
    # op and window, rounded to the reference's 4-way mesh
    heap = c["n_keys"] + c["windows"] * c["batch"]
    heap += -heap % REF_SHARDS
    return EngineConfig(n_slots=c["n_keys"], heap_slots=heap, mode=mode)


def scenario_row(cfg, ops, res, ios, mass, p) -> dict:
    """``benchmarks/scenarios.py::_run_one``'s row out of a traced run."""
    import numpy as np
    from repro_torch.core import runner
    from repro_torch.core.types import OpKind, to_numpy
    kinds = np.asarray(ops.kinds)
    valid = kinds != OpKind.NOP
    upd = (kinds == OpKind.UPDATE) & valid
    writes_w = np.maximum(upd.sum(-1), 1)
    pess_w = (to_numpy(res.pessimistic) & upd).sum(-1)
    comb_w = (to_numpy(res.combined) & valid).sum(-1)
    lat = runner.modeled_latency(cfg, kinds, res, p, valid=valid)
    n_w = valid.sum(-1)
    io_np = _io_host(ios)
    io_sum = _io_map(lambda x: x.sum(), io_np)
    mops_w = [runner.modeled_throughput(_io_map(lambda x, w=w: x[w], io_np),
                                        p, n_ops=int(n_w[w]))["modeled_mops"]
              for w in range(len(n_w))]
    overall = runner.modeled_throughput(io_sum, p, n_ops=int(n_w.sum()))
    overall.update(runner.latency_stats(lat).as_dict())
    overall["pess_ratio"] = round(float(pess_w.sum() / writes_w.sum()), 4)
    overall["wc_rate"] = round(float(comb_w.sum() / writes_w.sum()), 4)
    overall["mn_iops"] = int(np.asarray(io_sum.mn_iops))
    overall["retries"] = int(np.asarray(io_sum.retries))
    overall["windows"] = {
        "pess_ratio": _round4(pess_w / writes_w),
        "credit_mass": [int(v) for v in to_numpy(mass)],
        "wc_rate": _round4(comb_w / writes_w),
        "modeled_mops": _round4(mops_w),
        "p99_us": _round4(np.nanpercentile(lat, 99, axis=-1)),
    }
    return overall


def scenario_rows(dev, c: dict, names=None, profile=None,
                  n_shards: int | None = None) -> dict:
    """The ``single`` rows of ``BENCH_scenarios.json`` (every scenario, or
    ``names``, x 4 modes) from ``runner.run_windows_traced`` on ``dev``, or
    with ``n_shards`` its ``sharded<n_shards>`` rows from
    ``run_windows_sharded_traced`` on a local mesh.  ``profile(label,
    fn)``, where given, is called once with a rerun of the hotspot_shift
    CIDER cell."""
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import SyncMode
    from repro_torch.dist import store as dstore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.workloads.dynamic import SCENARIOS
    p = SimParams()
    out = {}
    for name in names or SCENARIOS:
        sc = SCENARIOS[name]
        ops = sc.generate(c["windows"], c["batch"], c["n_keys"],
                          c["n_clients"], seed=c["seed"])
        stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                    n_cns=c["n_cns"], device=dev)
        pk = sc.populate_keys(c["n_keys"])
        out[name] = {}
        for mode in MODES:
            cfg = scenario_cfg(SyncMode[mode], c)
            cr = credit_init(c["credit_table"], dev)
            if n_shards is None:
                st = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
                run = functools.partial(runner.run_windows_traced, cfg, st,
                                        cr, stream)
            else:
                run = functools.partial(
                    dstore.run_windows_sharded_traced, cfg,
                    make_local_mesh(n_shards, dev),
                    _sharded_store(dev, cfg, n_shards, pk), cr, stream)
            _, _, res, ios, mass = run()
            out[name][mode] = scenario_row(cfg, ops, res, ios, mass, p)
            if profile and (name, mode) == ("hotspot_shift", "CIDER"):
                profile(f"{name} {mode} {run.func.__name__} "
                        f"({c['windows']} windows)", run)
    return out


def open_loop_window_us(scale: dict) -> float:
    """``benchmarks/scale.py``'s open-loop clock: the slowest mode's
    full-window service time at the open-loop mesh, from the committed
    weak-scaling rows (a sharded-path figure the clock is defined by)."""
    c = scale["config"]
    weak = scale["weak_scaling"][str(c["ol_mesh"])]
    return max(weak[m]["modeled_ticks_us"] for m in MODES) / (
        c["windows"] - c["warmup"])


def open_loop_setup(c: dict):
    """``(n_slots, n_cns, lanes, heap)`` of the open-loop cell: the
    ``ol_mesh``-way problem of ``benchmarks/scale.py`` on one device."""
    n = c["ol_mesh"]
    n_slots, n_cns = c["slots1"] * n, c["cns1"] * n
    lanes = c["lanes1"] // c["cns1"]
    heap = n_slots + c["ol_windows"] * n_cns * lanes
    heap += -heap % n
    return n_slots, n_cns, lanes, heap


def open_loop_run(dev, c: dict, mode, ol, window_us: float):
    """One open-loop stream through ``run_windows`` on ``dev``; returns
    ``(cfg, state, credits, results, io, record)``."""
    import numpy as np
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import EngineConfig
    from repro_torch.workloads.openloop import open_loop_latency
    n_slots, n_cns, lanes, heap = open_loop_setup(c)
    cfg = EngineConfig(n_slots=n_slots, heap_slots=heap, mode=mode)
    pk = np.arange(n_slots)
    st = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
    stream = runner.make_stream(ol.kinds, ol.keys % n_slots, ol.values,
                                n_cns=n_cns, lanes_per_cn=lanes,
                                valid=ol.valid, cn=ol.cn, device=dev)
    st, cr, res, io = runner.run_windows(cfg, st, credit_init(n_slots, dev),
                                         stream)
    lat = runner.modeled_latency(cfg, ol.kinds, res, SimParams(),
                                 valid=ol.valid)
    stats = runner.latency_stats(open_loop_latency(ol, lat, window_us))
    rec = {"p50_us": stats.p50_us, "p99_us": stats.p99_us,
           "offered": ol.offered, "delivered": ol.delivered,
           "mean_delay_windows": round(
               float(ol.delay_windows[ol.valid].mean()), 3)
           if ol.delivered else 0.0}
    return cfg, st, cr, res, io, rec


def open_loop_rows(dev, c: dict, window_us: float, profile=None) -> dict:
    """``BENCH_scale.json``'s ``open_loop`` curves (every rho x 4 modes),
    the MMPP row, and the dense re-pack identity on the CIDER cell: bill,
    credits, store and every valid lane's results at its permuted lane.
    ``profile(label, fn)``, where given, is called once with a rerun of the
    MMPP CIDER cell."""
    import numpy as np
    from repro_torch.core.types import SyncMode, to_numpy
    from repro_torch.workloads.openloop import (OpenLoopSpec, dense_repack,
                                                generate_openloop_stream)
    from repro_torch.workloads.ycsb import WORKLOADS
    spec = WORKLOADS["write-intensive"]
    n_slots, n_cns, lanes, _ = open_loop_setup(c)

    def stream(rho, seed, arrival="poisson"):
        return generate_openloop_stream(OpenLoopSpec(
            n_cns=n_cns, lanes_per_cn=lanes, windows=c["ol_windows"],
            rho=rho, n_keys=n_slots, mix=spec, theta=c["theta"],
            arrival=arrival, seed=seed))

    out = {"curves": {m: [] for m in MODES}, "mmpp": {}}
    for rho in c["rhos"]:
        ol = stream(rho, c["seed"] + int(rho * 100))
        for mode in MODES:
            rec = open_loop_run(dev, c, SyncMode[mode], ol, window_us)[-1]
            out["curves"][mode].append({"rho": rho, **rec})
    olm = stream(c["mmpp_rho"], c["seed"] + 5000, "mmpp")
    for mode in MODES:
        rec = open_loop_run(dev, c, SyncMode[mode], olm, window_us)[-1]
        out["mmpp"][mode] = {"rho": c["mmpp_rho"], **rec,
                             "burst_windows_frac": round(
                                 float(olm.phases.mean()), 3)}
    if profile:
        profile(f"open loop MMPP CIDER ({c['ol_windows']} windows, set-up "
                f"included)", functools.partial(open_loop_run, dev, c,
                                                SyncMode.CIDER, olm,
                                                window_us))
    ol = stream(0.8, c["seed"] + 9000)
    rp = dense_repack(ol)
    _, st_a, cr_a, res_a, io_a, _ = open_loop_run(dev, c, SyncMode.CIDER, ol,
                                                  window_us)
    _, st_b, cr_b, res_b, io_b, _ = open_loop_run(dev, c, SyncMode.CIDER, rp,
                                                  window_us)
    _check_trees(io_a, io_b, "open_loop/dense_repack: IOMetrics")
    _check_trees(cr_a, cr_b, "open_loop/dense_repack: credits")
    _check_views(st_a, st_b, "open_loop/dense_repack")
    for f in dataclasses.fields(res_a):
        moved = np.take_along_axis(to_numpy(getattr(res_a, f.name)),
                                   rp.order, axis=1)
        check(np.array_equal(moved[rp.valid],
                             to_numpy(getattr(res_b, f.name))[rp.valid]),
              f"open_loop/dense_repack: Results.{f.name} at the permuted "
              f"lanes")
    out["dense_repack"] = {"delivered": rp.delivered,
                           "mn_iops": io_a.as_dict()["mn_iops"]}
    return out


def replicated_deployment(dev, n_keys: int, windows: int, batch: int,
                          n_cns: int, n_clients: int, credit_table: int,
                          seed: int, modes=("CIDER", "MCS"), timer=None,
                          profile=None) -> dict:
    """Crash recovery with MN replication at ``n_keys`` populated keys:
    ``crash_storm``'s stream (a quarter of the CNs fail-stop at window
    ``windows // 3``) over ``n_replicas = 3``, replica 2 dying at window
    ``2 * windows // 3`` (``mn_crash``), through ``run_recovery_replicated``.
    Raises unless, per mode: every post-drop-valid op's ``ok``/``value`` and
    the final value of every touched key equal the sequential oracle applied
    with that validity; results, bill, state and credits equal the
    segmented ``n_replicas``-swap run; results, state and credits equal an
    R = 1 run of the same stream, and each constant-membership segment's
    bill decomposes into per-replica bills (``per_replica_bill``) that sum
    back to it.  ``timer(label, fn)`` runs ``fn`` and returns its result
    (the phase times it there); ``profile(label, fn)``, where given, is
    called once with a rerun of the first mode's replicated run.  Returns
    the per-mode summaries."""
    import numpy as np
    import torch
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.oracle import OracleStore
    from repro_torch.core.types import (EngineConfig, SyncMode,
                                        per_replica_bill, to_numpy)
    from repro_torch.recovery import (mn_crash, run_recovery,
                                      run_recovery_replicated, time_to_repair)
    from repro_torch.workloads.recovery import crash_storm
    timer = timer or (lambda label, fn: fn())
    ops, sched = crash_storm(windows, batch, n_keys, n_clients, n_cns,
                             seed=seed)
    mn = mn_crash(windows, CRASH_R, dead_replicas=CRASH_DEAD,
                  at_window=2 * windows // 3)
    stream = runner.make_stream(ops.kinds, ops.keys, ops.values, n_cns=n_cns,
                                alive=sched.alive, device=dev)
    valid = np.asarray(sched.drop_mask(batch))
    keys = np.unique(ops.keys)
    oracle = OracleStore()
    oracle.populate(keys, keys)
    want = [oracle.apply(ops.kinds[w], ops.keys[w], ops.values[w],
                         valid=valid[w]) for w in range(windows)]
    want_ok = np.stack([x[0] for x in want])
    want_val = np.stack([x[1] for x in want])
    kt = torch.as_tensor(keys, device=dev).long()
    want_e = np.array([int(k) in oracle.kv for k in keys])
    want_v = np.array([oracle.kv.get(int(k), -1) for k in keys])
    out = {}
    for name in modes:
        cfg = EngineConfig(n_slots=n_keys, heap_slots=n_keys + windows * batch,
                           mode=SyncMode[name], n_replicas=CRASH_R)
        st = engine.populate(cfg, engine.store_init(cfg, dev),
                             np.arange(n_keys), np.arange(n_keys))
        cr = credit_init(credit_table, dev)
        run = timer(f"{name} run_recovery_replicated",
                    lambda: run_recovery_replicated(cfg, st, cr, stream, mn))
        if profile and name == modes[0]:
            profile(f"{name} run_recovery_replicated ({windows} windows)",
                    lambda: run_recovery_replicated(cfg, st, cr, stream, mn))
        what = f"replicated deployment/{name}"
        check(np.array_equal(run.valid, valid),
              f"{what}: post-drop validity differs from the schedule's")
        check(np.array_equal(to_numpy(run.results.ok), want_ok),
              f"{what}: ok differs from the oracle")
        check(np.array_equal(to_numpy(run.results.value), want_val),
              f"{what}: value differs from the oracle")
        exists, val = engine.store_view(run.state)
        check(np.array_equal(to_numpy(exists[kt]), want_e)
              and np.array_equal(to_numpy(val[kt]), want_v),
              f"{what}: final store differs from the oracle")
        ref = timer(f"{name} segmented n_replicas-swap run",
                    lambda: segmented_swap_run(cfg, st, cr, stream, mn))
        _check_trees(run.state, ref[0], f"{what}: state vs segmented run")
        _check_trees(run.credits, ref[1], f"{what}: credits vs segmented run")
        _check_trees(run.results, ref[2], f"{what}: Results vs segmented run")
        _check_trees(run.io, ref[3], f"{what}: IOMetrics vs segmented run")
        one = timer(f"{name} R = 1 run_recovery",
                    lambda: run_recovery(dataclasses.replace(cfg, n_replicas=1),
                                         st, cr, stream))
        _check_trees(run.results, one.results, f"{what}: Results vs R = 1")
        _check_trees(run.state, one.state, f"{what}: state vs R = 1")
        _check_trees(run.credits, one.credits, f"{what}: credits vs R = 1")
        per_seg = []
        for lo, hi, surv in mn.segments():
            io_r = _io_map(lambda x: x[lo:hi].sum(0), run.io)
            bills = per_replica_bill(_io_map(lambda x: x[lo:hi].sum(0),
                                             one.io), io_r, len(surv))
            total = io_r.as_dict()
            total.pop("mn_iops")
            check({k: sum(b[k] for b in bills) for k in total} == total,
                  f"{what}: per-replica bills of windows [{lo}, {hi}) do "
                  f"not sum to the bill")
            per_seg.append({"windows": [lo, hi], "replicas": len(surv),
                            "mn_iops": [b["reads"] + b["writes"] + b["cas"]
                                        + b["faa"] for b in bills]})
        out[name] = {"time_to_repair": time_to_repair(
                         run.io, sched.first_crash_window()),
                     "segments": per_seg, "recovery_io": run.recovery_io,
                     "n_valid": int(valid.sum()),
                     "mn_iops": run.io_sum().as_dict()["mn_iops"]}
    out["crash_window"] = sched.first_crash_window()
    out["touched_keys"] = int(keys.size)
    return out


def race_hash_deployment(dev, capacity: int, n_pop: int, windows: int,
                         batch: int, n_cns: int, seed: int, timer=None,
                         profile=None) -> dict:
    """``RaceHash`` of ``capacity`` slots: populate ``n_pop`` keys (every
    key found must hold its value, and every key not found must have a full
    candidate bucket: the bucket its batch overflowed), run ``windows``
    YCSB-A windows of
    ``batch`` ops against the oracle (``ok``/``value`` of every op, the
    overflow lanes masked out), and require a SCAN batch to raise
    ``UnsupportedOpError``.  ``timer`` and ``profile`` as in
    ``replicated_deployment`` (the profiled run is the YCSB-A windows)."""
    import numpy as np
    from repro_torch.core import engine
    from repro_torch.core.oracle import OracleStore
    from repro_torch.core.types import OpKind, UnsupportedOpError, to_numpy
    from repro_torch.stores import RaceHash
    from repro_torch.workloads.ycsb import YCSB, generate_ycsb_stream
    timer = timer or (lambda label, fn: fn())
    rng = np.random.default_rng(seed)
    # distinct keys spread over the int32 range (an odd multiplier is a
    # bijection modulo 2^31); none is the -1 empty marker
    keys = np.arange(n_pop, dtype=np.int64) * 2654435761 % 2**31
    values = rng.integers(1, 2**31 - 1, n_pop)
    rh0 = RaceHash.create(capacity, device=dev)
    rh = timer("RaceHash.populate", lambda: rh0.populate(keys, values))
    slot, found = rh.locate(keys)
    exists, val = engine.store_view(rh.state)
    slot, found = slot[found].long(), to_numpy(found)
    check(bool(exists[slot].all()) and np.array_equal(
        to_numpy(val[slot]), values[found].astype(np.int32)),
        "RaceHash: populated values differ")
    full = (rh.slot_keys.reshape(rh.n_buckets, rh.ways) != -1).all(1)
    b1, b2 = rh._buckets(rh.slot_keys.new_tensor(keys[~found]))
    check(bool((full[b1.long()] | full[b2.long()]).all()),
          "RaceHash: a populated key is missing, and neither of its buckets "
          "is full")
    oracle = OracleStore()
    oracle.populate(keys[found], values[found])
    ops = generate_ycsb_stream(YCSB["A"], windows, batch, n_pop, n_cns,
                               seed=seed)
    ops.keys[:] = keys[ops.keys]                 # key ids -> stored keys

    def run(store):
        outs = []
        for w in range(windows):
            store, res, io, ovf = store.apply(ops.kinds[w], ops.keys[w],
                                              ops.values[w], n_cns=n_cns)
            outs.append((res, io, ovf))
        return store, outs

    rh1, outs = timer(f"RaceHash {windows} YCSB-A windows", lambda: run(rh))
    if profile:
        profile(f"RaceHash {windows} YCSB-A windows", lambda: run(rh))
    n_ovf = 0
    for w, (res, _, ovf) in enumerate(outs):
        ovf = to_numpy(ovf)
        n_ovf += int(ovf.sum())
        ok, value = oracle.apply(ops.kinds[w], ops.keys[w], ops.values[w],
                                 valid=~ovf)
        check(np.array_equal(to_numpy(res.ok), ok)
              and np.array_equal(to_numpy(res.value), value),
              f"RaceHash window {w}: results differ from the oracle")
    kinds = np.full(batch, OpKind.SEARCH, np.int32)
    kinds[batch // 2] = OpKind.SCAN
    try:
        rh1.apply(kinds, ops.keys[0], ops.values[0], n_cns=n_cns)
    except UnsupportedOpError:
        pass
    else:
        raise RuntimeError("RaceHash accepted a SCAN batch")
    return {"overflow": n_ovf, "populate_overflow": int((~found).sum())}


# ---------------------------------------------------------------------------
# phase 12: the sharded store
# ---------------------------------------------------------------------------
# The reference benchmarks' sharded runs (the sharded4 rows of benchmarks/
# {run,replication,scenarios}.py, benchmarks/scale.py's weak scaling) on a
# local mesh: every shard a partition in this process, on one device
# (launch.mesh.make_local_mesh); then a 2^24-key store over 4 shards.

SCALE_FULL = dict(meshes=[1, 4, 8, 16], **OPEN_LOOP_FULL)


def _sharded_store(dev, cfg, n_shards: int, keys):
    """An ``n_shards``-way store holding ``keys`` (each its own value)."""
    from repro_torch.dist import store as dstore
    return dstore.sharded_populate(
        cfg, n_shards, dstore.sharded_store_init(cfg, n_shards, dev), keys,
        keys)


def replication_sharded_rows(dev, c: dict, n_shards: int,
                             modes=MODES) -> dict:
    """``BENCH_replication.json``'s ``sharded<n_shards>`` rows, R -> mode
    -> cell, through ``run_windows_sharded`` on a local mesh of ``dev``."""
    import numpy as np
    from repro_torch.core import runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import SyncMode
    from repro_torch.dist import store as dstore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.stores import PointerArray
    from repro_torch.workloads.ycsb import WORKLOADS, generate_window_stream
    n_slots, b, windows = c["n_slots"], c["batch"], c["windows"]
    ops = generate_window_stream(WORKLOADS["write-intensive"], windows, b,
                                 n_slots, b)
    stream = runner.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                                n_cns=16, device=dev)
    mesh = make_local_mesh(n_shards, dev)
    rows = {}
    for r in (1, 2, 3):
        p = dataclasses.replace(SimParams(), n_replicas=r)
        rows[str(r)] = {}
        for mode in modes:
            cfg = PointerArray.create(n_slots, mode=SyncMode[mode],
                                      n_replicas=r, device=dev).cfg
            _, _, res, io = dstore.run_windows_sharded(
                cfg, mesh, _sharded_store(dev, cfg, n_shards,
                                          np.arange(n_slots)),
                credit_init(4096, dev), stream)
            rows[str(r)][mode] = replication_cell(cfg, ops.kinds, res, io, p,
                                                  windows * b)
    return rows


def weak_scaling_rows(dev, c: dict, modes=MODES):
    """``benchmarks/scale.py::_weak_scaling`` on local meshes of ``dev``:
    mesh -> mode -> record, and the efficiency table.  The 1-way mesh's
    per-shard bill must sum to the single-device run's, window by window."""
    import numpy as np
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import EngineConfig, SyncMode, to_numpy
    from repro_torch.dist import store as dstore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.workloads.ycsb import WORKLOADS, generate_window_stream
    p = SimParams()
    spec = WORKLOADS["write-intensive"]
    weak = {}
    for n in c["meshes"]:
        n_slots, b, n_cns = c["slots1"] * n, c["lanes1"] * n, c["cns1"] * n
        heap = n_slots + c["windows"] * b
        heap += -heap % n
        ops = generate_window_stream(spec, c["windows"], b, n_slots, n_cns,
                                     seed=c["seed"], theta=c["theta"])
        stream = runner.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                                    n_cns=n_cns, device=dev)
        mesh = make_local_mesh(n, dev)
        pk = np.arange(n_slots)
        wu = c["warmup"]
        n_steady = (c["windows"] - wu) * b
        weak[str(n)] = {}
        for mode in modes:
            cfg = EngineConfig(n_slots=n_slots, heap_slots=heap,
                               mode=SyncMode[mode])
            run = functools.partial(
                dstore.run_windows_sharded, cfg, mesh,
                _sharded_store(dev, cfg, n, pk), credit_init(n_slots, dev),
                stream, per_shard_io=True, io_per_window=True)
            _, _, res, io = run()
            # benchmarks/scale.py::_window_ticks: shards serve their
            # partitions concurrently, so a window takes its hottest
            # shard's time
            win_ticks = np.maximum(
                to_numpy(io.mn_iops).astype(np.float64) / p.mn_cap,
                to_numpy(io.mn_bytes).astype(np.float64) / p.mn_bw).max(-1)
            ticks = float(win_ticks[wu:].sum())
            lat = runner.modeled_latency(cfg, ops.kinds, res, p)[wu:]
            iops = to_numpy(io.mn_iops)[wu:]
            weak[str(n)][mode] = {
                "modeled_mops": round(n_steady / ticks, 4),
                "modeled_ticks_us": round(ticks, 2),
                "modeled_mops_with_warmup": round(
                    c["windows"] * b / float(win_ticks.sum()), 4),
                "shard_mn_iops": [int(x) for x in iops.sum(0)],
                "hot_shard_imbalance": round(
                    float(iops.sum(0).max() / max(iops.sum(0).mean(), 1e-9)),
                    3),
                "mn_iops": int(iops.sum()),
                "mn_bytes": int(to_numpy(io.mn_bytes)[wu:].sum()),
                "combined": int(to_numpy(io.combined)[wu:].sum()),
                "modeled_p99_us": runner.latency_stats(lat).p99_us,
            }
            if n == 1:
                st1 = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
                io1 = runner.run_windows(cfg, st1, credit_init(n_slots, dev),
                                         stream, io_per_window=True)[3]
                _check_trees(_io_map(lambda x: x.sum(-1, dtype=x.dtype), io),
                             io1, f"weak scaling/mesh 1/{mode}: per-shard "
                                  f"bill vs the single device")
    eff = {m: {} for m in modes}
    base = weak.get("1", {})
    for n_str, rows in weak.items():
        for m in modes:
            if int(n_str) > 1 and m in base:
                eff[m][n_str] = round(rows[m]["modeled_mops"]
                                      / (int(n_str)
                                         * base[m]["modeled_mops"]), 4)
    return weak, eff


def sharded_deployment(dev, n_keys: int, windows: int, batch: int,
                       n_cns: int, credit_table: int, n_shards: int,
                       modes=("CIDER", "MCS"), timer=None) -> dict:
    """YCSB A and E over ``n_keys`` populated keys on an ``n_shards``-way
    local mesh (phase 4's streams and store size): raises unless, per
    workload and mode, the sharded run's results, bill, credit table and
    store view equal the single-device run's on the same stream, and every
    op's result and every touched key's final value equal the oracle's.
    ``timer(label, fn)`` runs and times ``fn``.  Returns per-cell
    summaries."""
    import numpy as np
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.types import EngineConfig, SyncMode
    from repro_torch.dist import store as dstore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.workloads.ycsb import YCSB
    timer = timer or (lambda label, fn: fn())
    n_slots = n_keys + windows * batch          # room for E's inserts
    heap_slots = n_slots + windows * batch
    mesh = make_local_mesh(n_shards, dev)
    pk = np.arange(n_keys)
    out = {}
    for wl in ("A", "E"):
        spec = YCSB[wl]
        oracle = deployment_oracle(wl, n_keys, windows, batch, n_cns)
        ops = oracle[0]
        stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                    n_cns=n_cns, device=dev)
        for name in modes:
            cfg = EngineConfig(n_slots=n_slots, heap_slots=heap_slots,
                               mode=SyncMode[name],
                               scan_max=spec.scan_max if spec.scan > 0 else 0)
            st = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
            one = timer(f"{wl} {name} single device",
                        lambda: runner.run_windows(
                            cfg, st, credit_init(credit_table, dev), stream))
            del st
            run = functools.partial(
                dstore.run_windows_sharded, cfg, mesh,
                _sharded_store(dev, cfg, n_shards, pk),
                credit_init(credit_table, dev), stream)
            shd = timer(f"{wl} {name} {n_shards} shards", run)
            what = f"sharded deployment/{wl}/{name}"
            _check_trees(shd[1], one[1], f"{what}: credits vs single device")
            _check_trees(shd[2], one[2], f"{what}: Results vs single device")
            _check_trees(shd[3], one[3], f"{what}: IOMetrics vs single device")
            view = dstore.sharded_store_view(cfg, n_shards, shd[0])
            for x, y in zip(view, engine.store_view(one[0])):
                check(bool((x == y).all()),
                      f"{what}: store view differs from the single device's")
            check_oracle(what, shd[2], *view, oracle)
            out[(wl, name)] = {"mn_iops": shd[3].as_dict()["mn_iops"],
                               "touched_keys": int(oracle[1].size)}
            del one, shd
    return out


class PhaseClock:
    """Wall time and peak device memory of a phase's runs, and the idle
    share of profiled reruns (``profile``), which wait until the run that
    asks for them has been timed."""

    def __init__(self, card: str):
        import torch
        self.card = card
        self.pending = None
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def run(self, label: str, fn):
        """``fn()`` timed by the host clock, ended by a synchronize, with
        the peak memory allocated while it ran; then the reruns it asked to
        profile."""
        import torch
        self.pending = []
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        say(f"    {label}: {dt:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated "
            f"(ends {time.perf_counter() - self.t0:.1f} s into the phase) "
            f"[{self.card}]")
        pending, self.pending = self.pending, None
        for args in pending:
            self.profile(*args)
        return out

    def profile(self, label: str, fn) -> None:
        """The idle share of one run of ``fn``: device busy time of a
        profiled rerun over the wall of an unprofiled one."""
        import torch
        if self.pending is not None:
            self.pending.append((label, fn))
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        busy, pwall, top = profile_device(fn, iters=1)
        say(f"  profiled {label}: device busy {busy} ms; wall {wall} ms "
            f"unprofiled, {pwall} ms profiled; idle share "
            f"{None if busy is None else 1 - busy / wall} (busy over the "
            f"unprofiled wall); the profiled run and its trace took "
            f"{time.perf_counter() - t1:.1f} s [{self.card}]")
        for key, ms, count in top:
            say(f"    {ms:9.4f} ms  x{count:5d}  {key}")

    def done(self, n: int) -> None:
        import torch
        torch.cuda.synchronize()
        say(f"  phase {n}: {time.perf_counter() - self.t0:.3f} s [{self.card}]")


def _config_matches(committed: dict, ours: dict, what: str) -> None:
    for k, v in ours.items():
        check(committed.get(k) == v, f"{what}: config {k} = {v}, the "
                                     f"committed file has {committed.get(k)}")


def phase7_recovery(dev, card: str) -> None:
    ref = json.loads((ROOT / "BENCH_recovery.json").read_text())
    _config_matches(ref["config"], RECOVERY_FULL, "recovery")
    clock = PhaseClock(card)
    rows = clock.run("3 scenarios x 4 modes, run_recovery",
                     lambda: recovery_rows(dev, RECOVERY_FULL,
                                           profile=clock.profile))
    for name, sc in ref["scenarios"].items():
        check(rows[name]["crash_window"] == sc["crash_window"],
              f"recovery/{name}: crash window {rows[name]['crash_window']}")
        for mode, want in sc["modes"].items():
            _check_rows(rows[name]["modes"][mode], want,
                        f"recovery/{name}/{mode}")
        r = rows[name]["modes"]
        say(f"  {name}: 4 modes == BENCH_recovery.json (modeled "
            + ", ".join(f"{m} {r[m]['modeled_mops']} Mops/s repair_cas "
                        f"{r[m]['repair_cas']} ttr {r[m]['windows_to_repair']}"
                        for m in MODES) + ")")
    say(f"  crash_storm failover ({REF_SHARDS} shards, survivors "
        f"{SURVIVORS} from window {rows['crash_storm']['crash_window']}, "
        f"run_recovery_sharded on a local mesh): results, every window's "
        f"bill and the store view == the single-device drop-mask run, and "
        f"the failover sub-dicts == BENCH_recovery.json "
        f"({rows['crash_storm']['modes']['CIDER']['failover']})")
    clock.done(7)


def phase8_replication(dev, card: str) -> None:
    ref = json.loads((ROOT / "BENCH_replication.json").read_text())
    eng = json.loads((ROOT / "BENCH_engine.json").read_text())
    _config_matches(ref["config"], REPLICATION_FULL, "replication")
    clock = PhaseClock(card)
    rows = clock.run("R 1-3 x 4 modes + the mn_crash cell",
                     lambda: replication_rows(dev, REPLICATION_FULL,
                                              profile=clock.profile))
    for r in ("1", "2", "3"):
        for mode, want in ref["replicas"][r]["single"].items():
            _check_rows(rows["replicas"][r][mode], want,
                        f"replication/R{r}/{mode}")
    for mode in MODES:
        _check_rows(rows["replicas"]["1"][mode], eng[mode],
                    f"replication/R1/{mode} vs BENCH_engine.json",
                    skip=("throughput_mops", "wall_s"))
        _check_rows(rows["mn_crash"][mode], ref["mn_crash"]["modes"][mode],
                    f"replication/mn_crash/{mode}")
    say("  single rows R 1-3 == BENCH_replication.json (R 1 == "
        "BENCH_engine.json); modeled Mops/s by R: "
        + "; ".join(f"R{r} " + ", ".join(
            f"{m} {rows['replicas'][r][m]['modeled_mops']}" for m in MODES)
            for r in ("1", "2", "3")))
    say("  mn_crash (R 3, replica 2 dies at window 8) through "
        "run_recovery_replicated == the segmented n_replicas-swap run and "
        "the crash-free R 3 prefix, and == BENCH_replication.json: "
        + ", ".join(f"{m} {rows['mn_crash'][m]['modeled_mops']} Mops/s"
                    for m in MODES))
    clock.done(8)


def phase9_scenarios(dev, card: str) -> None:
    ref = json.loads((ROOT / "BENCH_scenarios.json").read_text())
    _config_matches(ref["config"], SCENARIOS_FULL, "scenarios")
    clock = PhaseClock(card)
    rows = clock.run("4 scenarios x 4 modes, run_windows_traced",
                     lambda: scenario_rows(dev, SCENARIOS_FULL,
                                           profile=clock.profile))
    for name, sc in ref["scenarios"].items():
        for mode, want in sc["single"].items():
            _check_rows(rows[name][mode], want, f"scenarios/{name}/{mode}")
        say(f"  {name}: 4 modes == BENCH_scenarios.json single rows, "
            f"trajectories and credit_mass included (modeled "
            + ", ".join(f"{m} {rows[name][m]['modeled_mops']}"
                        for m in MODES) + " Mops/s)")
    clock.done(9)


def phase10_open_loop(dev, card: str) -> None:
    scale = json.loads((ROOT / "BENCH_scale.json").read_text())
    ref = scale["open_loop"]
    _config_matches(scale["config"], OPEN_LOOP_FULL, "scale")
    window_us = open_loop_window_us(scale)
    check(round(window_us, 2) == ref["window_us"],
          f"open-loop window {window_us} us, BENCH_scale.json has "
          f"{ref['window_us']}")
    n_slots, n_cns, lanes, _ = open_loop_setup(OPEN_LOOP_FULL)
    clock = PhaseClock(card)
    rows = clock.run(
        f"{len(OPEN_LOOP_FULL['rhos'])} rho x 4 modes + MMPP x 4 + dense "
        f"re-pack x 2, {n_slots} slots, {n_cns} CNs x {lanes} lanes",
        lambda: open_loop_rows(dev, OPEN_LOOP_FULL, window_us,
                               profile=clock.profile))
    for mode in MODES:
        check(len(rows["curves"][mode]) == len(ref["curves"][mode]),
              f"open_loop/{mode}: curve length")
        for got, want in zip(rows["curves"][mode], ref["curves"][mode]):
            _check_rows(got, want, f"open_loop/{mode}/rho {want['rho']}")
        _check_rows(rows["mmpp"][mode], ref["mmpp"][mode],
                    f"open_loop/mmpp/{mode}")
    say("  open-loop curves (p50, p99, offered, delivered, mean delay), the "
        "MMPP row == BENCH_scale.json; p99 by rho: "
        + "; ".join(f"{m} " + ", ".join(str(r["p99_us"])
                                        for r in rows["curves"][m])
                    for m in MODES))
    say(f"  dense re-pack (CIDER, rho 0.8, {rows['dense_repack']['delivered']}"
        f" ops): bill, credits, store view and every valid lane's results "
        f"equal at the permuted lanes")
    clock.done(10)


def phase11_deployment(dev, card: str, n_keys: int, windows: int, batch: int,
                       n_cns: int, credit_table: int) -> None:
    clock = PhaseClock(card)
    out = replicated_deployment(dev, n_keys, windows, batch, n_cns,
                                n_clients=n_cns, credit_table=credit_table,
                                seed=5, timer=clock.run, profile=clock.profile)
    for name in ("CIDER", "MCS"):
        o = out[name]
        say(f"  {name} {n_keys} keys, {windows} x {batch} ops, R 3 (replica "
            f"2 dies at window {2 * windows // 3}), a quarter of {n_cns} CNs "
            f"crash at window {out['crash_window']}: {o['n_valid']} "
            f"post-drop-valid ops and {out['touched_keys']} touched keys == "
            f"oracle; == segmented run; == R 1 run; per-replica bills "
            f"conserve, MN IOPS by replica per segment {o['segments']}; "
            f"time_to_repair {o['time_to_repair']}; recovery_io "
            f"{o['recovery_io']}")
    cap, n_pop = n_keys >> 2, n_keys >> 3
    rh = race_hash_deployment(dev, cap, n_pop, windows=16, batch=batch,
                              n_cns=n_cns, seed=5, timer=clock.run,
                              profile=clock.profile)
    say(f"  RaceHash capacity {cap}: {n_pop} keys populated "
        f"({rh['populate_overflow']} overflowed a full bucket), every other "
        f"one found with its value; 16 YCSB-A windows x {batch} ops "
        f"== oracle ({rh['overflow']} overflow lanes); a SCAN batch raises "
        f"UnsupportedOpError")
    clock.done(11)


def phase12_sharded(dev, card: str, n_keys: int, windows: int, batch: int,
                    n_cns: int, credit_table: int) -> None:
    ycsb = json.loads((ROOT / "BENCH_ycsb.json").read_text())
    repl = json.loads((ROOT / "BENCH_replication.json").read_text())
    scen = json.loads((ROOT / "BENCH_scenarios.json").read_text())
    scale = json.loads((ROOT / "BENCH_scale.json").read_text())
    n = REF_SHARDS
    topo = f"sharded{n}"
    for what, ref in (("ycsb", ycsb), ("replication", repl),
                      ("scenarios", scen)):
        check(ref["config"]["n_shards"] == n,
              f"{what}: the committed file's mesh is {ref['config']['n_shards']}")
    _config_matches(scale["config"], SCALE_FULL, "scale")
    clock = PhaseClock(card)
    rows, launches = clock.run(
        f"YCSB A-F x 4 modes, {n} shards",
        lambda: ycsb_rows(dev, ycsb["config"], n, profile=clock.profile))
    check_ycsb(rows, launches, ycsb, topo, n)
    check_ycsb(rows, launches, ycsb, "single", n)
    say(f"  YCSB A-F {topo} rows == BENCH_ycsb.json and == the single rows "
        f"(E's cross-shard SCANs: {rows['E']['CIDER']['rows']} rows)")
    rows = clock.run(f"replication R 1-3 x 4 modes, {n} shards",
                     lambda: replication_sharded_rows(dev, REPLICATION_FULL,
                                                      n))
    for r, by_mode in rows.items():
        for mode, row in by_mode.items():
            ref = repl["replicas"][r]
            _check_rows(row, ref[topo][mode], f"replication/R{r}/{topo}/{mode}")
            _check_rows(row, {k: v for k, v in ref["single"][mode].items()
                              if k != "per_replica"},
                        f"replication/R{r}/{topo}/{mode} vs the single row")
    say(f"  replication R 1-3 {topo} rows == BENCH_replication.json and == "
        f"the single rows")
    rows = clock.run(f"4 scenarios x 4 modes, {n} shards, "
                     f"run_windows_sharded_traced",
                     lambda: scenario_rows(dev, SCENARIOS_FULL,
                                           profile=clock.profile, n_shards=n))
    for name, sc in scen["scenarios"].items():
        for mode in MODES:
            _check_rows(rows[name][mode], sc[topo][mode],
                        f"scenarios/{name}/{topo}/{mode}")
            _check_rows(rows[name][mode], sc["single"][mode],
                        f"scenarios/{name}/{topo}/{mode} vs the single row")
    say(f"  scenarios {topo} rows == BENCH_scenarios.json and == the single "
        f"rows, trajectories and credit_mass included")
    weak, eff = clock.run(
        f"weak scaling, meshes {SCALE_FULL['meshes']} x 4 modes, "
        f"{SCALE_FULL['slots1']} slots and {SCALE_FULL['cns1']} CNs a shard",
        lambda: weak_scaling_rows(dev, SCALE_FULL))
    for m, by_mode in scale["weak_scaling"].items():
        for mode, want in by_mode.items():
            _check_rows(weak[m][mode], want, f"weak_scaling/{m}/{mode}")
    _check_rows(eff, scale["efficiency"], "efficiency")
    say("  weak_scaling (per-shard bills, hottest-shard ticks, p99) and "
        "efficiency == BENCH_scale.json; efficiency at 16 shards: "
        + ", ".join(f"{m} {eff[m]['16']}" for m in MODES)
        + "; mesh 1's per-shard bill == the single device's")
    out = sharded_deployment(dev, n_keys, windows, batch, n_cns, credit_table,
                             n, timer=clock.run)
    say(f"  deployment: YCSB A and E over {n_keys} keys on {n} shards, "
        f"{windows} x {batch} ops, CIDER and MCS: results, bill, credits and "
        f"store view == the single-device run, every result and touched key "
        f"== oracle; MN IOPS "
        + ", ".join(f"{wl} {name} {o['mn_iops']}"
                    for (wl, name), o in out.items()))
    clock.done(12)


# ---------------------------------------------------------------------------
# phase 13: the protocol simulator
# ---------------------------------------------------------------------------
# The pinned runs of the port's run_sim (1,000,000 keys, seed 0, write-
# intensive unless said): the default SimParams (full width: 1,024 lanes,
# 2^14 key slots) for 8,192 ticks; benchmarks/run.py's BASE (Figs 11-12) in
# all four modes at 48 and 512 clients; BASE CIDER at 512 clients with
# wc_off, with cas_off (Fig 20) and with 3 MN replicas; and the two crash
# configurations of tests/test_substrates.py (MCS, one key, 16 clients).
# tests/test_torch_sim_pins.py proves that the JAX reference gives SIM_PINS.

SIM_BASE = dict(n_lanes=512, ticks=8192, max_ops=1024)
# the default SimParams' run cut to 8,192 of its 32,768 ticks (its 1,024
# lanes and 2^14 key slots kept): the whole script took 1,037.9 s with the
# 32,768 (run 28d, H100 80GB HBM3 at 700 W), past its 1,000 s target
SIM_DEFAULT_TICKS = 8192
SIM_CRASH = dict(n_lanes=64, ticks=6144, max_ops=512, fail_tick=600,
                 max_wait=512, lanes_per_cn=1, local_wc=False)
SIM_WI = ("write-intensive", 1_000_000)
# name -> (SimParams overrides, mode, (workload, keys), clients)
SIM_RUNS = {
    "default_CIDER_512": (dict(ticks=SIM_DEFAULT_TICKS), "CIDER", SIM_WI,
                          512),
    **{f"base_{m}_{nc}": (SIM_BASE, m, SIM_WI, nc)
       for m in MODES for nc in (48, 512)},
    "base_CIDER_512_wc_off": (dict(SIM_BASE, wc_off=True), "CIDER", SIM_WI,
                              512),
    "base_CIDER_512_cas_off": (dict(SIM_BASE, cas_off=True), "CIDER",
                               SIM_WI, 512),
    "base_CIDER_512_r3": (dict(SIM_BASE, n_replicas=3), "CIDER", SIM_WI,
                          512),
    "crash_MCS_lane3": (dict(SIM_CRASH, fail_lane=3), "MCS",
                        ("write-only", 1), 16),
    "crash_MCS_lanes": (dict(SIM_CRASH, fail_lanes=(3, 5, 9)), "MCS",
                        ("write-only", 1), 16),
}
SIM_PINS = {
    'default_CIDER_512': dict(
        mode='CIDER', n_clients=512, ticks=8192, ops_done=98722,
        throughput_mops=12.051025390625, p50_us=32.0, p99_us=152.0,
        retries=11387, mn_iops_used=262505, cn_msgs=6966,
        wc_rate=0.10597490014800397, wc_rate_local=0.0,
        wc_rate_global=0.10597490014800397, avg_batch=8.93202416918429,
        pess_ratio=0.1294527907872595, ideal_pess_ratio=0.0451716237860633,
        deadlocks=0),
    'base_OSYNC_48': dict(
        mode='OSYNC', n_clients=48, ticks=8192, ops_done=64573,
        throughput_mops=7.8824462890625, p50_us=6.0, p99_us=8.0, retries=2574,
        mn_iops_used=163625, cn_msgs=0, wc_rate=0.010605594835536428,
        wc_rate_local=0.010605594835536428, wc_rate_global=0.0, avg_batch=0.0,
        pess_ratio=0.0, ideal_pess_ratio=0.014233015677835845, deadlocks=0),
    'base_OSYNC_512': dict(
        mode='OSYNC', n_clients=512, ticks=8192, ops_done=27054,
        throughput_mops=3.302490234375, p50_us=6.0, p99_us=2047.0,
        retries=35909, mn_iops_used=103222, cn_msgs=0,
        wc_rate=0.03452675823763417, wc_rate_local=0.03452675823763417,
        wc_rate_global=0.0, avg_batch=0.0, pess_ratio=0.0,
        ideal_pess_ratio=0.05179013735645125, deadlocks=0),
    'base_SPIN_48': dict(
        mode='SPIN', n_clients=48, ticks=8192, ops_done=37474,
        throughput_mops=4.574462890625, p50_us=10.0, p99_us=48.0,
        retries=3240, mn_iops_used=133110, cn_msgs=0,
        wc_rate=0.0258442999841446, wc_rate_local=0.0258442999841446,
        wc_rate_global=0.0, avg_batch=0.0, pess_ratio=1.0,
        ideal_pess_ratio=0.03937424026214259, deadlocks=0),
    'base_SPIN_512': dict(
        mode='SPIN', n_clients=512, ticks=8192, ops_done=60888,
        throughput_mops=7.4326171875, p50_us=10.0, p99_us=1277.0,
        retries=25801, mn_iops_used=233324, cn_msgs=0,
        wc_rate=0.04569972533836328, wc_rate_local=0.04569972533836328,
        wc_rate_global=0.0, avg_batch=0.0, pess_ratio=1.0,
        ideal_pess_ratio=0.06803666567391377, deadlocks=0),
    'base_MCS_48': dict(
        mode='MCS', n_clients=48, ticks=8192, ops_done=44806,
        throughput_mops=5.469482421875, p50_us=10.0, p99_us=34.0, retries=0,
        mn_iops_used=155640, cn_msgs=4259, wc_rate=0.022125066242713303,
        wc_rate_local=0.022125066242713303, wc_rate_global=0.0, avg_batch=0.0,
        pess_ratio=1.0, ideal_pess_ratio=0.0, deadlocks=0),
    'base_MCS_512': dict(
        mode='MCS', n_clients=512, ticks=8192, ops_done=77390,
        throughput_mops=9.447021484375, p50_us=15.0, p99_us=1139.0, retries=0,
        mn_iops_used=262188, cn_msgs=9625, wc_rate=0.05798908807482463,
        wc_rate_local=0.05798908807482463, wc_rate_global=0.0, avg_batch=0.0,
        pess_ratio=1.0, ideal_pess_ratio=0.0, deadlocks=0),
    'base_CIDER_48': dict(
        mode='CIDER', n_clients=48, ticks=8192, ops_done=63446,
        throughput_mops=7.744873046875, p50_us=6.0, p99_us=12.0, retries=2225,
        mn_iops_used=162489, cn_msgs=820, wc_rate=0.006074268895985973,
        wc_rate_local=0.0, wc_rate_global=0.006074268895985973,
        avg_batch=2.2847682119205297, pess_ratio=0.024923288872189867,
        ideal_pess_ratio=0.012618197758156428, deadlocks=0),
    'base_CIDER_512': dict(
        mode='CIDER', n_clients=512, ticks=8192, ops_done=98750,
        throughput_mops=12.054443359375, p50_us=32.0, p99_us=152.0,
        retries=11287, mn_iops_used=262507, cn_msgs=7009,
        wc_rate=0.10683881952326901, wc_rate_local=0.0,
        wc_rate_global=0.10683881952326901, avg_batch=8.78267254038179,
        pess_ratio=0.13029025458083346, ideal_pess_ratio=0.04426787741203178,
        deadlocks=0),
    'base_CIDER_512_wc_off': dict(
        mode='CIDER', n_clients=512, ticks=8192, ops_done=85039,
        throughput_mops=10.3807373046875, p50_us=6.0, p99_us=1602.0,
        retries=6754, mn_iops_used=224141, cn_msgs=3389, wc_rate=0.0,
        wc_rate_local=0.0, wc_rate_global=0.0, avg_batch=0.0,
        pess_ratio=0.042834890965732085,
        ideal_pess_ratio=0.028509392995374305, deadlocks=0),
    'base_CIDER_512_cas_off': dict(
        mode='CIDER', n_clients=512, ticks=8192, ops_done=77980,
        throughput_mops=9.51904296875, p50_us=33.0, p99_us=143.0, retries=0,
        mn_iops_used=262503, cn_msgs=14383, wc_rate=0.16901661658576675,
        wc_rate_local=0.0, wc_rate_global=0.16901661658576675,
        avg_batch=4.986094316807739, pess_ratio=1.0, ideal_pess_ratio=0.0,
        deadlocks=0),
    'base_CIDER_512_r3': dict(
        mode='CIDER', n_clients=512, ticks=8192, ops_done=51432,
        throughput_mops=6.2783203125, p50_us=64.0, p99_us=293.0, retries=8444,
        mn_iops_used=262830, cn_msgs=3398, wc_rate=0.09922800998128509,
        wc_rate_local=0.0, wc_rate_global=0.09922800998128509,
        avg_batch=9.268608414239482, pess_ratio=0.11930754834684966,
        ideal_pess_ratio=0.06019962570180911, deadlocks=0),
    'crash_MCS_lane3': dict(
        mode='MCS', n_clients=16, ticks=6144, ops_done=817,
        throughput_mops=0.13297526041666666, p50_us=104.0, p99_us=524.0,
        retries=0, mn_iops_used=4115, cn_msgs=1648, wc_rate=0.0,
        wc_rate_local=0.0, wc_rate_global=0.0, avg_batch=0.0, pess_ratio=1.0,
        ideal_pess_ratio=0.0, deadlocks=15),
    'crash_MCS_lanes': dict(
        mode='MCS', n_clients=16, ticks=6144, ops_done=814,
        throughput_mops=0.13248697916666666, p50_us=90.0, p99_us=531.0,
        retries=0, mn_iops_used=4100, cn_msgs=1642, wc_rate=0.0,
        wc_rate_local=0.0, wc_rate_global=0.0, avg_batch=0.0, pess_ratio=1.0,
        ideal_pess_ratio=0.0, deadlocks=13),
}
SIM_EAGER_TICKS = 128      # ticks run eagerly and graphed from one state


def sim_streams(dev, over: dict, workload: tuple, cache: dict):
    """``make_streams`` of one pinned run, shared by runs of one shape."""
    from repro_torch.core import sim
    from repro_torch.core.simnet import SimParams
    from repro_torch.workloads.ycsb import WORKLOADS
    p = SimParams(**over)
    key = (p.n_lanes, p.max_ops, p.h_bits, p.hc_bits, p.hl_bits, workload)
    if key not in cache:
        cache[key] = sim.make_streams(p, WORKLOADS[workload[0]], workload[1],
                                      seed=0, device=dev)
    return p, cache[key]


def graph_launches(record: list, out: dict) -> dict:
    """Add to ``out[(kernel, N)]`` each kernel's launches in the replays of
    a run's graphs beyond the one the launch counter recorded at capture
    (every sort sweep of a tick runs at N = the lanes)."""
    for g in record:
        n_lanes = g.state.phase.shape[0]
        for name, n in g.captured.items():
            key = (name, n_lanes)
            out[key] = out.get(key, 0) + n * (g.replays - 1)
    return out


def sim_pinned_runs(dev, card: str, streams: dict) -> dict:
    """Every SIM_RUNS run through ``examples_torch/cider_sim_figures.py``'s
    ``sweep`` (``run_sim``, CUDA graphs) at its one client count and mode,
    each result equal to its pin; returns the replays' extra launches by
    kernel."""
    import torch
    from repro_torch.core import sim
    from repro_torch.core.types import SyncMode
    figures = load_driver("examples_torch/cider_sim_figures.py")
    check(figures.params() == sim.SimParams(**SIM_BASE)
          and (figures.WORKLOAD, figures.N_KEYS) == SIM_WI,
          "cider_sim_figures' size is not SIM_BASE's")
    extra: dict = {}
    for name, (over, mode, workload, clients) in SIM_RUNS.items():
        p, st = sim_streams(dev, over, workload, streams)
        record = []
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = figures.sweep(p, st, clients=(clients,), modes=(SyncMode[mode],),
                          record=record)[clients][mode]
        wall = time.perf_counter() - t0
        got, want = dataclasses.asdict(r), SIM_PINS[name]
        for field, v in want.items():
            check(got[field] == v, f"sim {name}: {field} {got[field]!r}, "
                                   f"pinned {v!r}")
        graph_launches(record, extra)
        say(f"  sim {name}: == SIM_PINS ({r.row()}); {p.n_lanes} lanes x "
            f"{p.ticks} ticks in {wall:.2f} s wall = "
            f"{wall / p.ticks * 1e3:.4f} ms a tick (capture included), "
            f"{len(record)} graph(s), peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{card}]")
    return extra


def sim_states_equal(a, b, what: str) -> None:
    from repro_torch import interop
    import numpy as np
    x, y = interop.sim_state_to_numpy(a), interop.sim_state_to_numpy(b)
    for name in x:
        if name == "net":
            for g in x["net"]:
                check(np.array_equal(x["net"][g], y["net"][g]),
                      f"{what}: net.{g} differs")
        else:
            check(np.array_equal(x[name], y[name]), f"{what}: {name} differs")


def sim_graph_vs_eager(dev, card: str, streams: dict) -> dict:
    """From one full-width state, ``SIM_EAGER_TICKS`` ticks eagerly and
    through the graphs, in all four modes: every ``SimState`` field equal.
    Returns the replays' extra launches by kernel."""
    import torch
    from repro_torch.core import sim
    from repro_torch.core.types import SyncMode
    over, _, workload, clients = SIM_RUNS["default_CIDER_512"]
    p, st = sim_streams(dev, over, workload, streams)
    n = SIM_EAGER_TICKS
    extra: dict = {}
    for mode in MODES:
        s0 = sim.initial_state(p, st, clients)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eager = sim.advance(p, SyncMode[mode], st, s0, 0, n, graph=False)
        torch.cuda.synchronize(dev)
        t_eager = time.perf_counter() - t0
        record = []
        t0 = time.perf_counter()
        graphed = sim.advance(p, SyncMode[mode], st, s0, 0, n, graph=True,
                              record=record)
        torch.cuda.synchronize(dev)
        t_graph = time.perf_counter() - t0
        sim_states_equal(eager, graphed, f"sim {mode}: graph vs eager")
        graph_launches(record, extra)
        say(f"  sim {mode}: {n} ticks graphed == eager, every SimState "
            f"field; eager {t_eager / n * 1e3:.4f} ms a tick, graphed "
            f"{t_graph:.2f} s with its capture [{card}]")
    return extra


def sim_replay_profile(dev, card: str, streams: dict, replays: int = 20):
    """The default run's program as one ``TickGraph``: ms a tick by
    replay, replays under ``set_sync_debug_mode("error")``, and one
    profiled replay (kernels a tick, device busy, idle share).  Returns
    the graph."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import sim
    from repro_torch.core.types import SyncMode
    over, mode, workload, clients = SIM_RUNS["default_CIDER_512"]
    p, st = sim_streams(dev, over, workload, streams)
    state = sim.initial_state(p, st, clients)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    k = sim.GRAPH_TICKS
    g = sim.TickGraph(p, SyncMode[mode], st, state, t, k)
    g.replay()
    ms = cuda_ms(g.replay, iters=replays, warmup=1) / k
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            g.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    g.replay()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in events)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    check(n_kernels > 0, "the profiler saw no kernel of a graph replay")
    idle = 1.0 - busy / wall
    say(f"  sim graph: {k} ticks a replay, {g.replays} replays; "
        f"{ms:.4f} ms a tick by replay (CUDA events over {replays} "
        f"replays); 4 replays under set_sync_debug_mode('error'): no host "
        f"sync; one profiled replay: {n_kernels / k:.1f} kernels a tick, "
        f"device busy {busy:.3f} ms of {wall:.3f} ms unprofiled wall, idle "
        f"share {idle:.4f}; launches captured a replay: {g.captured} "
        f"[{card}]")
    return g


def window_loop_sync_free(dev, card: str) -> None:
    """A window loop (YCSB E, SCAN on, all four modes) on the card under
    ``set_sync_debug_mode("error")``."""
    import torch
    from repro_torch.analysis import device_check
    from repro_torch.core.types import SyncMode
    for mode in SyncMode:
        fn, *args = device_check._window_loop_case(mode, dev)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    say(f"  runner.run_windows (YCSB E, SCAN on, 4 modes) under "
        f"set_sync_debug_mode('error'): no host sync [{card}]")


def phase13_sim(dev, card: str) -> dict:
    """The protocol simulator on the card; returns each kernel's launches
    in graph replays beyond the captures the counters recorded, by
    ``(kernel, N)``."""
    from repro_torch.analysis import race_check
    streams: dict = {}
    t0 = time.perf_counter()
    extra = sim_pinned_runs(dev, card, streams)
    say(f"  (pinned runs: {time.perf_counter() - t0:.1f} s)")
    for k, v in sim_graph_vs_eager(dev, card, streams).items():
        extra[k] = extra.get(k, 0) + v
    graph_launches([sim_replay_profile(dev, card, streams)], extra)
    window_loop_sync_free(dev, card)
    notes: list = []
    record: list = []
    viols = race_check._sim_conformance(notes, device=dev, record=record)
    check(not viols, f"race_check tick conformance: {viols}")
    graph_launches(record, extra)
    say(f"  {notes[0]}: no violation")
    return extra

# ---------------------------------------------------------------------------
# phase 14: the other model families at full width
# ---------------------------------------------------------------------------
# One registered model of each family beside dense, at its published width
# and depth (random weights from a seeded generator on the card), and
# kimi-k2-1t-a32b, the registry's one head dim 112, loaded one at a time
# and freed before the next: arch -> the prefill's batch and length (text
# tokens; hubert's are frames, phi-3-vision's follow its 576 patches) and
# the depth run: None for the published one, else the deepest whose
# weights and prefill peak under TRAIN_PEAK_GIB (kimi: one layer's 19.4 B
# parameters are 36.2 GiB in bf16, two 68.0 GiB before activations;
# PERF.md's cut list).
PHASE14 = {"deepseek-moe-16b": dict(batch=1, seq=2048, n_layers=None),
           "kimi-k2-1t-a32b": dict(batch=1, seq=2048, n_layers=1),
           "mamba2-1.3b": dict(batch=2, seq=4096, n_layers=None),
           "recurrentgemma-9b": dict(batch=1, seq=4096, n_layers=None),
           "hubert-xlarge": dict(batch=2, seq=1024, n_layers=None),
           "phi-3-vision-4.2b": dict(batch=1, seq=64, n_layers=None)}
# the reference serve's stats for each decoder's default stream (16
# requests over that model's vocabulary), pinned by
# tests/test_torch_serving.py from the JAX scheduler
SERVE_STATS_14 = {arch: dict(SERVE_STATS) for arch in PHASE14
                  if arch != "hubert-xlarge"}
# decode against prefill at full depth: held to the tolerance for the
# attention families; printed for mamba2 and the hybrid, whose recurrent
# decode drifts from their chunked or scanned prefill with depth under
# random bf16 weights, in the reference too (tests/test_torch_ssm_rglru.py)
DECODE_HELD_AT_DEPTH = ("moe", "vlm")
# card vs CPU depth: 2 layers, the hybrid two (rec, rec, attn) triples
CPU_LAYERS = {"hybrid": 6}
# card vs CPU where the host cannot run a layer at full width: the config's
# fields replaced (kimi keeps its attention and expert widths, d 7,168, 64
# x 112 heads, KH 8, d_ff 2,048, top-8 + 1 shared, over 16 experts and a
# 4,096-token vocabulary, 1 layer) and the forward's batch and length
CPU_CUT = {"kimi-k2-1t-a32b": dict(
    cfg=dict(n_layers=1, n_experts=16, vocab=4096), batch=1, seq=256)}
# a replayed MoE routing: the share of token-layer expert choices the run
# would have made otherwise may not pass this (1.2-4 % measured on the
# card at full width)
FLIP_MAX = 0.1
RING = dict(n_layers=3, window=32, steps=80)   # the hybrid's ring wrap
# recurrentgemma-9b's smoke config (head dim 16, 4 query heads on one kv
# head, window 16, 5 layers: one attention layer), which every attention
# kernel runs on its 32-column instance: served on the card (``serve.main
# --smoke``, the default 16 requests), card against CPU at its own depth,
# and its 16-row ring past the window (64 decode steps at 3 layers)
SMOKE_ARCH = "recurrentgemma-9b"
RING_SMOKE = dict(n_layers=3, window=16, steps=64)


def _family_inputs(cfg, b: int, n: int, gen):
    """Tokens and frontend features of a forward: the encoder's ``n``
    frames (no tokens), the vlm's ``n_patches`` patches and ``n`` tokens,
    else ``n`` tokens."""
    import torch
    from repro_torch.models.frontend import fake_frontend_batch
    dev = gen.device
    n_tok = 0 if cfg.family == "encoder" else n
    toks = torch.randint(0, cfg.vocab, (b, n_tok), generator=gen, device=dev)
    return toks, fake_frontend_batch(cfg, gen, b, n)


def _n_attn(cfg) -> int:
    return {"ssm": 0, "hybrid": cfg.n_layers // 3}.get(cfg.family,
                                                       cfg.n_layers)


def _text_only(cfg, b, dev):
    """The vlm's decode is the dense path over text: its forward for the
    decode comparisons takes no patches."""
    import torch
    if cfg.frontend != "vision":
        return None
    return torch.zeros((b, 0, cfg.frontend_dim), dtype=torch.bfloat16,
                       device=dev)


def _per_token(choices, b, s, t0, t1):
    """Each layer's recorded (B * S, k) choices cut to positions
    [t0, t1)."""
    return [c.reshape(b, s, -1)[:, t0:t1].reshape(-1, c.shape[-1])
            for c in choices]


def check_flips(flips, what: str) -> None:
    """A replayed routing (``moe.pinned_routing``): the run's own expert
    choices may differ from the replayed ones at near-ties only, in at
    most ``FLIP_MAX`` of the token-layer choices."""
    check(flips[1] > 0, f"{what}: no routing choice was replayed")
    check(flips[0] <= FLIP_MAX * flips[1],
          f"{what}: {flips[0]} of {flips[1]} expert choices differ from the "
          f"replayed ones (more than {FLIP_MAX:.0%})")


def decode_vs_prefill(cfg, model, params, dev, card: str,
                      checked: bool = True) -> None:
    """On the card, 64 positions of 8 sequences: attention families (moe,
    vlm text) prefill 48 and decode 16 from that prefill's caches; ssm and
    hybrid (whose prefill hands over no recurrent state) decode all 64
    from a zero state; the decode logits (128 or 512 positions) against
    the forward's, held to the model tolerance when ``checked``, else
    printed with the share of logits beyond it.  Random weights give flat
    logits, and a few percent of the argmaxes are near-ties that rounding
    flips, so the argmax agreement is taken over at least 128 positions.
    The MoE forward's expert choices are replayed in the prefill and the
    decode, and the choices they would have made are held to
    ``check_flips``.  An MoE layer over more than 128 tokens may drop
    tokens past an expert's capacity (128 rows), which a decode step of 8
    tokens never does, so the MoE forward and prefill take one sequence
    at a time: 64 tokens, nothing dropped."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import pinned_routing
    b = 8
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (b, 64), generator=g, device=dev)
    none = _text_only(cfg, b, dev)
    moe = cfg.family == "moe"
    rec = []
    if moe:
        fulls, recs = [], []
        for i in range(b):
            recs.append([])
            with pinned_routing(record=recs[-1]):
                fulls.append(tfm.forward(cfg, params, toks[i:i + 1])[0])
        full = torch.cat(fulls)
        rec = [torch.cat([r[layer].reshape(64, -1) for r in recs])
               for layer in range(len(recs[0]))]
    else:
        full, _, _ = tfm.forward(cfg, params, toks, none)
    st = model.init_decode_state(b, 64)
    t0 = 0
    flips = [0, 0]
    if moe:
        t0 = 48
        for i in range(b):
            with pinned_routing(
                    replay=_per_token(recs[i], 1, 64, 0, 48)) as f:
                _, (ck, cv) = model.prefill(params, toks[i:i + 1, :48])
            flips = [flips[0] + f[0], flips[1] + f[1]]
            st["k"][:, i:i + 1, :48] = ck
            st["v"][:, i:i + 1, :48] = cv
    elif cfg.family == "vlm":
        t0 = 48
        _, (ck, cv) = model.prefill(params, toks[:, :48], none)
        st["k"][:, :, :48] = ck
        st["v"][:, :, :48] = cv
    outs = []
    for t in range(t0, 64):
        with (pinned_routing(replay=_per_token(rec, b, 64, t, t + 1)) if moe
              else contextlib.nullcontext()) as f:
            lg, st = model.decode_step(params, st, toks[:, t:t + 1], t)
        if f:
            flips = [flips[0] + f[0], flips[1] + f[1]]
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    what = f"{cfg.name} L {cfg.n_layers} decode vs prefill on the card"
    if moe:
        check_flips(flips, what)
    g, w = dec.float(), full[:, t0:].float()
    beyond = float(((g - w).abs() > MODEL_ATOL + MODEL_RTOL * w.abs())
                   .float().mean())
    if checked:
        err, agree = _logits_close(dec, full[:, t0:], what)
    else:
        check(bool(torch.isfinite(dec).all()), f"{what}: not finite")
        err = float((g - w).abs().max())
        agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    say(f"  decode vs prefill on the card, L {cfg.n_layers}, "
        f"{'held to' if checked else 'printed against'} the tolerance, "
        f"{beyond:.4f} of the logits beyond it ({64 - t0} decode steps of "
        f"{b} sequences"
        f"{' after a 48-token prefill' if t0 else ' from a zero state'}): "
        f"max |diff| {err:.4f}, argmax agreement {agree:.3f}"
        + (f"; routing replayed from the forward, {flips[0]} of {flips[1]} "
           f"token-layer choices would have flipped" if moe else ""))


def card_vs_cpu(cfg, dev, card: str) -> None:
    """At full width, depth cut to 2 layers (the hybrid to two triples,
    6), or as ``CPU_CUT`` says (a smoke config at its own depth): decode
    against prefill on the card, held
    to the tolerance; then the same weights on the card and on the CPU: a
    forward of 32 positions of 4 sequences (hubert: frames; phi-3-vision:
    one sequence of its 576 patches + 32 tokens; ``CPU_CUT``'s batch and
    length) and 4 decode steps of 64 sequences from a zero state, the CPU
    run's MoE routing replayed on the card and the card's own choices held
    to ``check_flips``.  At least 128 positions each (see
    ``decode_vs_prefill``): on the CPU an MoE layer costs its experts' full
    capacity of 128 rows whatever the batch."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    from repro_torch.models.moe import pinned_routing
    over = CPU_CUT.get(cfg.name, {}) if not cfg.smoke else {}
    depth = cfg.n_layers if cfg.smoke else CPU_LAYERS.get(cfg.family, 2)
    cut = dataclasses.replace(cfg, **{"n_layers": depth,
                                      **over.get("cfg", {})})
    mg = Model(cut, device=dev)
    pg = mg.init(torch.Generator(device=dev).manual_seed(5))
    mc, pc = Model(cut, device="cpu"), _tree_to(pg, "cpu")
    toks, feats = _family_inputs(
        cut, over.get("batch", 1 if cut.frontend == "vision" else 4),
        over.get("seq", 32), torch.Generator(device=dev).manual_seed(6))
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    rec = []
    with pinned_routing(record=rec) if moe else contextlib.nullcontext():
        lc, _, _ = tfm.forward(cut, pc, toks.cpu(),
                               None if feats is None else feats.cpu())
    with (pinned_routing(replay=rec) if moe
          else contextlib.nullcontext()) as flips:
        lg, _, _ = tfm.forward(cut, pg, toks, feats)
    if cut.has_decode:
        decode_vs_prefill(cut, mg, pg, dev, card)
    err, agree = _logits_close(lg, lc, f"{cfg.name} forward card vs CPU")
    cuts = {k: (getattr(cfg, k), v) for k, v in over.get("cfg", {}).items()
            if k != "n_layers"}
    width = "the smoke config" if cfg.smoke else "full width"
    msg = (f"  card vs CPU (n_layers cut {cfg.n_layers} -> {cut.n_layers}, "
           f"{width}{f' but {cuts}' if cuts else ''}; forward of "
           f"{lg.shape[0]} x {lg.shape[1]} positions)"
           f": max |diff| "
           f"{err:.4f}, argmax agreement {agree:.3f}")
    if cut.has_decode:
        sg, sc = mg.init_decode_state(64, 4), mc.init_decode_state(64, 4)
        dtoks = torch.randint(0, cut.vocab, (64, 4), device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(9))
        got, want = [], []
        for t in range(4):
            tok = dtoks[:, t:t + 1]
            rec = []
            with pinned_routing(record=rec) if moe else contextlib.nullcontext():
                lcd, sc = mc.decode_step(pc, sc, tok.cpu(), t)
            with (pinned_routing(replay=rec) if moe
                  else contextlib.nullcontext()) as f:
                lgd, sg = mg.decode_step(pg, sg, tok, t)
            if moe:
                flips = [flips[0] + f[0], flips[1] + f[1]]
            got.append(lgd[:, 0])
            want.append(lcd[:, 0])
        err, agree = _logits_close(torch.stack(got, 1), torch.stack(want, 1),
                                   f"{cfg.name} 4 decode steps card vs CPU")
        msg += (f"; 4 decode steps, B 64: max |diff| {err:.4f}, argmax "
                f"agreement {agree:.3f}")
    if moe:
        check_flips(flips, f"{cfg.name} card vs CPU")
        msg += (f" (the card's own routing would have flipped {flips[0]} of "
                f"{flips[1]} choices)")
    say(msg + f" (rtol {MODEL_RTOL}, atol {MODEL_ATOL}); "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    del pg, pc


def ring_wrap(cfg, dev, card: str, ring: dict = RING) -> None:
    """The hybrid at its width (full, or the smoke config's) with
    ``ring``'s layers and window (``RING``: one triple and a 32-token
    window): ``ring["steps"]`` decode steps (80: the ring of 32 rows wraps
    twice) against the forward over the same tokens, both on the card: the
    windowed flash_attention and the ring-cache paged_attention at the
    config's head dim held to each other past the window."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    cut = dataclasses.replace(cfg, n_layers=ring["n_layers"],
                              window=ring["window"])
    m = Model(cut, device=dev)
    p = m.init(torch.Generator(device=dev).manual_seed(7))
    n = ring["steps"]
    toks = torch.randint(0, cut.vocab, (1, n), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(8))
    full, _, _ = tfm.forward(cut, p, toks)
    st = m.init_decode_state(1, n)
    check(st["k"].shape[2] == ring["window"], "the ring is not window rows")
    outs = []
    for t in range(n):
        lg, st = m.decode_step(p, st, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    err, agree = _logits_close(torch.stack(outs, 1), full,
                               f"{cfg.name} ring decode vs windowed prefill")
    say(f"  ring wrap (n_layers cut to {cut.n_layers}, window "
        f"{cut.window}, {'the smoke config' if cfg.smoke else 'full width'}"
        f", hd {cut.hd}): {n} decode steps against the windowed forward: "
        f"max |diff| {err:.4f}, argmax agreement {agree:.3f} [{card}]")


def phase14_family(dev, card: str, arch: str, spec: dict) -> dict:
    """One model of ``PHASE14`` at full width and the depth ``spec`` names:
    prefill, decode against prefill, decode step time and idle share,
    serve, card against CPU (and the hybrid's ring wrap); returns its
    numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.wc_combine import ops as wcc
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    published = get_config(arch)
    cfg = (dataclasses.replace(published, n_layers=spec["n_layers"])
           if spec["n_layers"] else published)
    model = Model(cfg, device=dev)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t_model = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"  {arch} ({cfg.family}; L {cfg.n_layers}"
        + (f" of {published.n_layers}" if spec["n_layers"] else "")
        + f", d {cfg.d_model}, H {cfg.n_heads}, KH {cfg.n_kv}, hd "
        f"{cfg.hd}, vocab {cfg.vocab}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared} "
           f"shared" if cfg.family == "moe" else "")
        + f"): {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({before:.2f} "
        f"GiB allocated before), random init on "
        f"the card in {time.perf_counter() - t_model:.2f} s, peak "
        f"{init_peak:.2f} GiB (an f32 slab of the largest leaf beside the "
        f"weights) [{card}]")
    out = {"params_b": n_params / 1e9, "n_layers": cfg.n_layers,
           "init_peak_gib": init_peak}
    check(init_peak <= TRAIN_PEAK_GIB,
          f"{arch}: the random init peaked at {init_peak:.2f} GiB")

    # prefill at the full shape
    b, n = spec["batch"], spec["seq"]
    toks, feats = _family_inputs(cfg, b, n,
                                 torch.Generator(device=dev).manual_seed(1))
    f0, tc0 = dict(fa.counter.by_size), dict(fa.counter_tc.by_size)
    m0 = wcc.counter.by_tag.get("moe_dispatch", 0)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, toks, feats)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    positions = n + (cfg.n_patches if cfg.frontend == "vision" else 0)
    check(tuple(logits.shape) == (b, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), f"{arch} prefill logits")
    n_attn = _n_attn(cfg)
    if n_attn:
        check(tuple(caches[0].shape) == (n_attn, b, positions, cfg.n_kv,
                                         cfg.hd), f"{arch} prefill caches")
    launched = fa.counter.by_size.get(cfg.hd, 0) - f0.get(cfg.hd, 0)
    check(launched == 2 * n_attn, f"{arch}: 2 prefills launched "
                                  f"flash_attention D {cfg.hd} {launched} "
                                  f"times, expected {2 * n_attn}")
    # the models run in bf16: their forward's design is phase 1's
    design = fwd_design(fa, "torch.bfloat16", cfg.hd)
    launched_tc = fa.counter_tc.by_size.get(cfg.hd, 0) - tc0.get(cfg.hd, 0)
    check(launched_tc == (launched if design == "tensor cores" else 0),
          f"{arch}: {launched_tc} of {launched} flash_attention launches at "
          f"D {cfg.hd} ran on the tensor cores, expected the {design}")
    moe_launches = wcc.counter.by_tag.get("moe_dispatch", 0) - m0
    check((moe_launches == 2 * cfg.n_layers) == (cfg.family == "moe"),
          f"{arch}: 2 prefills launched wc_combine {moe_launches} times "
          f"from the MoE dispatch")
    del logits, caches
    busy, pwall, top = profile_device(
        lambda: model.prefill(params, toks, feats), iters=1)
    out["prefill_ms"] = walls[-1] * 1e3
    out["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(out["prefill_peak_gib"] <= TRAIN_PEAK_GIB,
          f"{arch}: the prefill peaked at {out['prefill_peak_gib']:.2f} GiB")
    say(f"  prefill B {b} x {positions} positions: {walls[-1] * 1e3:.1f} ms "
        f"(first call {walls[0] * 1e3:.1f} ms), "
        f"{b * positions / walls[-1]:.0f} tokens/s, flash_attention D "
        f"{cfg.hd} launches {launched // 2} a prefill "
        f"({launched_tc // 2} on the tensor cores), wc_combine (MoE "
        f"dispatch) {moe_launches // 2}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; profiled: "
        f"device busy {busy} ms, idle share "
        f"{None if busy is None else 1 - busy / (walls[-1] * 1e3)} [{card}]")
    for key, ms, count in top:
        say(f"    {ms:9.4f} ms  x{count:5d}  {key}")
    del toks, feats
    torch.cuda.empty_cache()

    if not cfg.has_decode:
        try:
            model.init_decode_state(1, 8)
        except ValueError as e:
            say(f"  no decode, as in the reference: {e}")
        else:
            raise RuntimeError(f"{arch}: init_decode_state did not raise")
    else:
        decode_vs_prefill(cfg, model, params, dev, card,
                          checked=cfg.family in DECODE_HELD_AT_DEPTH)
        # decode step time at the serve shape (B 1, Smax 40)
        st = model.init_decode_state(1, 40)
        tk = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        model.decode_step(params, st, tk, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(1, 17):
            lg, st = model.decode_step(params, st, tk, t)
        int(lg.argmax())
        step = (time.perf_counter() - t0) / 16
        busy, pwall, top = profile_device(
            lambda: model.decode_step(params, st, tk, 20), iters=5)
        out["decode_ms"] = step * 1e3
        say(f"  decode step B 1, Smax 40: {step * 1e3:.3f} ms (host clock, "
            f"16 steps), {1 / step:.1f} tokens/s; profiled: device busy "
            f"{busy} ms, wall {pwall:.3f} ms a step profiled; idle share "
            f"{None if busy is None else 1 - busy / (step * 1e3)} [{card}]")
        for key, ms, count in top:
            say(f"    {ms:9.4f} ms  x{count // 5:5d}  {key}")
        del st
    del params
    torch.cuda.empty_cache()

    if cfg.has_decode:      # serve.main draws its own weights (seed 0)
        # at the card-vs-CPU depth, or the phase's where that is
        # shallower: the stats depend on the request stream alone, and
        # the phase's depth's decode step is timed above
        depth = min(CPU_LAYERS.get(cfg.family, 2), cfg.n_layers)
        n_attn = _n_attn(dataclasses.replace(cfg, n_layers=depth))
        p0 = dict(pa.counter.by_size)
        m0 = wcc.counter.by_tag.get("moe_dispatch", 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n_req = SERVE_STATS_14[arch]["admitted"]   # the default 16
        stats = serve.main(["--arch", arch, "--layers", str(depth)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(stats == SERVE_STATS_14[arch],
              f"{arch} serve stats {stats}, the reference's are "
              f"{SERVE_STATS_14[arch]}")
        steps = n_req * (32 + 8 - 1)
        paged = pa.counter.by_size.get(cfg.hd, 0) - p0.get(cfg.hd, 0)
        check(paged == steps * n_attn, f"{arch} serve launched "
                                       f"paged_attention D {cfg.hd} {paged} "
                                       f"times, expected {steps * n_attn}")
        moe_launches = wcc.counter.by_tag.get("moe_dispatch", 0) - m0
        check((moe_launches == steps * depth) == (cfg.family == "moe"),
              f"{arch} serve launched wc_combine {moe_launches} times from "
              f"the MoE dispatch")
        out["serve_s"] = wall
        say(f"  serve {arch} at {depth} layers of full width ({n_req} "
            f"requests, 4 slots, prompt 32, max-new 8): stats {stats} == the reference's; {wall:.3f} s "
            f"(weights init included), {steps} decode steps = "
            f"{wall / steps * 1e3:.3f} ms a step, {n_req * 8 / wall:.1f} "
            f"generated tokens/s; launches: "
            f"paged_attention D {cfg.hd} {paged}, wc_combine (MoE dispatch) "
            f"{moe_launches}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        torch.cuda.empty_cache()

    card_vs_cpu(cfg, dev, card)
    if cfg.family == "hybrid":
        ring_wrap(cfg, dev, card)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_model
    say(f"  {arch}: {out['wall_s']:.1f} s in all [{card}]")
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase14_smoke(dev, card: str) -> dict:
    """``SMOKE_ARCH``'s smoke config on the card, every attention launch
    at head dim 16 on the 32-column instance (the launchers' reports):
    ``serve.main --smoke`` (weights from seed 0) with the reference's
    stats, ``card_vs_cpu`` at its own depth (decode against prefill past
    the window on the card, then the card against the CPU) and
    ``ring_wrap`` past its 16-token window (``RING_SMOKE``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.launch import serve

    cfg = get_config(SMOKE_ARCH, smoke=True)
    t0 = time.perf_counter()
    f0, p0 = dict(fa.counter_instance.by_size), \
        dict(pa.counter_instance.by_size)
    stats = serve.main(["--arch", SMOKE_ARCH, "--smoke"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(stats == SERVE_STATS, f"{SMOKE_ARCH} --smoke serve stats {stats}, "
                                f"the reference's are {SERVE_STATS}")
    # the serve prefills token by token: every prompt and new token one
    # decode step, one paged launch an attention layer
    steps = SERVE_STATS["admitted"] * (32 + 8 - 1)
    paged = new_tallies(pa.counter_instance, p0)
    check(paged == {pa.plan_of(16, torch.bfloat16): steps * _n_attn(cfg)},
          f"{SMOKE_ARCH} --smoke serve: paged_attention launches by (head "
          f"dim, instance) {paged}")
    say(f"  serve {SMOKE_ARCH} --smoke (hd {cfg.hd}, H {cfg.n_heads}, KH "
        f"{cfg.n_kv}, window {cfg.window}, {cfg.n_layers} layers; 16 "
        f"requests): stats {stats} == the reference's; {wall:.3f} s "
        f"(weights init included), {wall / steps * 1e3:.3f} ms a decode "
        f"step; paged_attention launches by plan {paged} "
        f"[{card}]")
    card_vs_cpu(cfg, dev, card)
    ring_wrap(cfg, dev, card, RING_SMOKE)
    flash = new_tallies(fa.counter_instance, f0)
    check(set(flash) == {fa.plan_of(16, torch.bfloat16)},
          f"{SMOKE_ARCH} smoke forwards: flash_attention launches by (head "
          f"dim, instance) {flash}")
    say(f"  {SMOKE_ARCH} smoke forwards on the card: flash_attention "
        f"launches by plan {flash} [{card}]")
    return {"serve_s": wall, "wall_s": time.perf_counter() - t0}


def phase14_families(dev, card: str) -> dict:
    out = {arch: phase14_family(dev, card, arch, spec)
           for arch, spec in PHASE14.items()}
    out[f"{SMOKE_ARCH} (smoke)"] = phase14_smoke(dev, card)
    return out


# ---------------------------------------------------------------------------
# phase 15: training qwen3-0.6b at full width and depth
# ---------------------------------------------------------------------------
# The train entry point's run (phase 5's prefill shape, 8,192 tokens a
# step), the card-against-CPU check at 2 layers of full width, and the
# restart check's smaller batch (the checkpointed state is the full
# model's either way).  TRAIN_TOL: the loss's rtol and each gradient
# leaf's |g_card - g_cpu| / |g_cpu| (tests/test_torch_train.py's bounds:
# bf16 matmuls round at other places in cuBLAS and on the CPU).
TRAIN = dict(arch="qwen3-0.6b", batch=2, seq=4096, steps=8)
TRAIN_CPU = dict(n_layers=2, batch=1, seq=256)
TRAIN_CKPT = dict(batch=1, seq=512)
TRAIN_TOL = dict(loss_rtol=2e-3, grad_rel=2e-2)
# measured by this script on an H100 80GB HBM3 at 700 W before the
# backward's residual became the f32 attention output: train.main's peak
# and a step by the host clock
BF16_RESIDUAL = dict(peak_gib=29.32, step_ms=543.7)
# The other families' training steps (``launch.train.train_step``, the
# reference's step) at full width, random weights and Zipf tokens from
# seeds: arch -> batch, positions (phase 14's shapes: text tokens; hubert's
# frames; the vlm's text after its 576 stub patches) and the depth trained:
# None for the published depth, else the deepest whose step's peak stays
# under TRAIN_PEAK_GIB (the hybrid in whole triples), as this script
# measured it on an H100 80GB HBM3 (PERF.md's cut list).  A step's peak is
# about 24 bytes a parameter beside the activations: the functional AdamW
# holds the old and the new parameters and moments, the gradients and
# their clipped copy at once.
TRAIN_FAMILIES = {"hubert-xlarge": dict(batch=2, seq=1024, n_layers=None),
                  "mamba2-1.3b": dict(batch=2, seq=4096, n_layers=None),
                  "phi-3-vision-4.2b": dict(batch=1, seq=64, n_layers=28),
                  "deepseek-moe-16b": dict(batch=1, seq=2048, n_layers=5),
                  "recurrentgemma-9b": dict(batch=1, seq=4096, n_layers=6)}
TRAIN_PEAK_GIB = 72.0
TRAIN_FAMILY_STEPS = 4     # the first warms up, the other three are timed
# Every step takes the same seeded batch: on fresh batches the first steps'
# losses moved by more than they fell (phi-3-vision's 64 targets a step;
# every family's second step spiked: this script, an H100 80GB HBM3 at 700
# W), while one batch's loss falls as the model fits it.  The learning
# rate: Adam's first steps move every weight by about the rate, and the
# 48 layers of hubert-xlarge compound them: at train.main's 3e-4 its loss
# rose from 6.57 to 12.9, at 1e-4 on one batch it went 6.57, 5.88, 8.18,
# 6.85, 5.79, 6.66.
TRAIN_FAMILY_LR = 3e-5
# card vs CPU: the gradient leaves' bound by family where it is not
# TRAIN_TOL's (tests/test_torch_train_families.py's FAMILY_BOUND: the
# hybrid's bf16 forward differs by more across frameworks, and every leaf
# of its gradient carries that)
TRAIN_GRAD_REL = {"hybrid": 6e-2}
# kimi-k2-1t-a32b's head dim 112 in training: its smoke config (2 layers,
# d 128, 4 x 2 heads, 8 experts) with head_dim 112, card against CPU
# (``train_vs_cpu``): the attention backward's D-112 instance on the main
# path, since no step trains kimi at width on one card
TRAIN_D112 = dict(arch="kimi-k2-1t-a32b", head_dim=112)
# leaves a family's loss does not read: the encoder takes frames, not
# tokens, so its token embedding has no gradient, on the CPU either
UNUSED_LEAVES = {"encoder": ("embed",)}


def _train_args(**over) -> list:
    c = dict(TRAIN, **over)
    return ["--arch", c["arch"], "--batch", str(c["batch"]), "--seq",
            str(c["seq"]), "--steps", str(c["steps"]), "--log_every", "1"]


def _leaf_names(tree, prefix: str = ""):
    """The paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def family_batch(cfg, tokens, targets, gen) -> dict:
    """A training batch of ``tokens`` and ``targets`` ((b, n) ids) and stub
    features drawn from ``gen``: the encoder takes ``n`` frames and no
    tokens, the vlm its ``n_patches`` patches before the ``n`` text tokens
    (the patches carry no loss)."""
    from repro_torch.models.frontend import fake_frontend_batch
    batch = {"tokens": tokens, "targets": targets}
    feats = fake_frontend_batch(cfg, gen, *targets.shape)
    if feats is not None:
        batch["frontend"] = feats
    if cfg.family == "encoder":
        batch["tokens"] = batch["tokens"][:, :0]
    return batch


def train_vs_cpu(dev, card: str, arch: str = TRAIN["arch"],
                 cfg=None) -> None:
    """The loss and every gradient leaf of ``arch`` at 2 layers of full
    width (the hybrid two triples, 6), or of the config ``cfg`` at its own
    depth, B 1 x S 256 (``TRAIN_CPU``), on the
    card against the CPU, on the same weights and batch (within
    ``TRAIN_TOL``; a family's leaves within ``TRAIN_GRAD_REL``); every
    leaf's gradient present and nonzero on the card.  The MoE runs with
    ``remat="none"`` and the CPU run's expert choices replayed on the card
    (a checkpointed block would route again in the backward), the card's
    own choices held to ``check_flips``."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.moe import pinned_routing
    from repro_torch.train.optimizer import tree_leaves, tree_map

    if cfg is None:
        cfg = get_config(arch)
        cfg = dc.replace(cfg, n_layers=CPU_LAYERS.get(cfg.family,
                                                      TRAIN_CPU["n_layers"]))
    moe = cfg.family == "moe"
    cfg = dc.replace(cfg, remat="none" if moe else cfg.remat)
    params = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(3))
    g = torch.Generator(device=dev).manual_seed(4)
    b, n = TRAIN_CPU["batch"], TRAIN_CPU["seq"]
    toks = torch.randint(0, cfg.vocab, (b, n + 1), generator=g, device=dev)
    batch = family_batch(cfg, toks[:, :-1], toks[:, 1:], g)
    t0 = time.perf_counter()
    out, rec, flips = {}, [], None
    # the CPU first: its expert choices are the ones replayed
    for name, where in (("cpu", torch.device("cpu")), ("card", dev)):
        p = tree_map(lambda x: x.detach().to(where).requires_grad_(True),
                     params)
        pin = (contextlib.nullcontext() if not moe else
               pinned_routing(record=rec) if name == "cpu" else
               pinned_routing(replay=rec))
        with pin as f:
            loss, _ = Model(cfg, device=where).loss_fn(
                p, {k: v.to(where) for k, v in batch.items()})
        if name == "card":
            flips = f
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
        out[name] = (float(loss.detach()), [None if x is None else x.cpu()
                                            for x in grads])
    (lg, gg), (lc, gc) = out["card"], out["cpu"]
    what = f"train {arch} card vs CPU"
    if moe:
        check_flips(flips, what)
    check(abs(lg - lc) <= TRAIN_TOL["loss_rtol"] * abs(lc),
          f"{what}: loss {lg} vs {lc}")
    bound = TRAIN_GRAD_REL.get(cfg.family, TRAIN_TOL["grad_rel"])
    names = list(_leaf_names(params))
    check(len(names) == len(gg), f"{what}: {len(gg)} gradients for "
                                 f"{len(names)} leaves")
    worst = 0.0
    unused = UNUSED_LEAVES.get(cfg.family, ())
    for name, a, c in zip(names, gg, gc):
        if name in unused:
            check(a is None and c is None,
                  f"{what}: {name}, which the loss does not read, has a "
                  f"gradient")
            continue
        check(a is not None and bool(a.abs().sum() > 0),
              f"train {arch} on the card: {name} has no gradient or a zero "
              f"one")
        rel = float((a.float() - c.float()).norm() / c.float().norm())
        check(rel <= bound, f"{what}: {name} off by {rel:.3g}")
        worst = max(worst, rel)
    say(f"  {arch} card vs CPU at {cfg.n_layers} layers of "
        f"{'the smoke config' if cfg.smoke else 'full width'} (hd "
        f"{cfg.hd}), B {b} x S {n}: loss {lg:.6f} / {lc:.6f}, "
        f"{len(gg) - len(unused)} "
        f"gradient leaves all present and nonzero on the card"
        + (f" (and {', '.join(unused)} unread, none on either side)"
           if unused else "")
        + f", worst leaf |diff| / |cpu| "
        f"{worst:.3g} (bound {bound})"
        + (f"; the CPU's routing replayed, {flips[0]} of {flips[1]} "
           f"choices would have flipped" if moe else "")
        + f"; {time.perf_counter() - t0:.1f} s [{card}]")


def train_family(dev, card: str, arch: str, spec: dict) -> dict:
    """``TRAIN_FAMILY_STEPS`` + 2 steps of ``launch.train.train_step`` on
    ``arch`` at full width and ``spec``'s depth and batch, all on one
    seeded batch (one warm-up, three timed by the synchronized host clock,
    one profiled after its own warm-up): losses finite and falling; the
    memory allocated before the model (what earlier phases left), and the
    step's peak under ``TRAIN_PEAK_GIB``; flash forward and backward
    launches a step (the forward twice a layer under ``remat="block"``)
    and the backwards the launcher ran on the tensor cores, which must be
    every one at the backward's tensor-core head dims and none at the
    others; busy time, idle share and the attention backward's share of
    one profiled step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init

    cfg = get_config(arch)
    if spec["n_layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    b, n = spec["batch"], spec["seq"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    t_all = time.perf_counter()
    model = Model(cfg, device=dev)
    state = [model.init(torch.Generator(device=dev).manual_seed(0)), None]
    state[1] = adamw_init(state[0])
    zipf = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=n, global_batch=b),
                    device=dev).batch_at(0)
    batch = family_batch(cfg, zipf["tokens"], zipf["targets"],
                         torch.Generator(device=dev).manual_seed(0))
    losses = []

    def one():
        p, o, loss, _, _ = train.train_step(model, state[0], state[1], batch,
                                            (), TRAIN_FAMILY_LR, False)
        state[:] = [p, o]
        losses.append(float(loss))       # one host sync a step
        return loss

    one()
    torch.cuda.synchronize()
    f0, b0, tc0 = fa.counter.count, fa.counter_bwd.count, \
        fa.counter_bwd_tc.count
    plans0 = dict(fa.counter_bwd_plan.by_size)
    t0 = time.perf_counter()
    per = TRAIN_FAMILY_STEPS - 1
    for _ in range(per):
        one()
    step_s = (time.perf_counter() - t0) / per
    fwd = (fa.counter.count - f0) / per
    bwd = (fa.counter_bwd.count - b0) / per
    bwd_tc = (fa.counter_bwd_tc.count - tc0) / per
    n_attn = _n_attn(cfg)
    design = bwd_design("bfloat16", cfg.head_dim)
    check(fwd == 2 * n_attn and bwd == n_attn,
          f"train {arch}: flash launches a step: forward {fwd}, backward "
          f"{bwd}, for {n_attn} attention layers")
    check(bwd_tc == (bwd if design == "tensor cores" else 0),
          f"train {arch}: {bwd_tc} of {bwd} backwards a step on the tensor "
          f"cores at D {cfg.head_dim}, expected the {design}")
    # every layer's backward has the step's shape, so one dK/dV plan
    plans = list(new_tallies(fa.counter_bwd_plan, plans0))
    check(len(plans) == (1 if n_attn else 0),
          f"train {arch}: dK/dV plans {plans}")
    plan = plans[0] if plans else None

    entries = bwd_entries(design, plan) if plan else BWD_ENTRIES[design]
    # a session that records no GPU events, or drops some, is run again
    for _ in range(3):
        busy, _, events = profile_device(one, iters=1, n_top=None)
        n_by = {w: sum(c for key, _, c in events if w in key)
                for w in entries}
        if busy is not None and all(v == n_attn for v in n_by.values()):
            break
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"train {arch}: losses {losses}")
    check(peak < TRAIN_PEAK_GIB, f"train {arch} at {cfg.n_layers} layers: "
                                 f"peak {peak:.2f} GiB")
    positions = b * (n + (cfg.n_patches if cfg.frontend == "vision" else 0))
    res = dict(n_layers=cfg.n_layers, losses=losses, step_ms=step_s * 1e3,
               positions_per_s=positions / step_s, peak_gib=peak,
               allocated_before_gib=before,
               busy_ms=busy, fwd_per_step=fwd, bwd_per_step=bwd,
               bwd_tc_per_step=bwd_tc, design=design,
               bwd_plan=plan._asdict() if plan else None,
               idle_share=None if busy is None else 1 - busy / (step_s * 1e3))
    if busy is not None and n_attn:
        other = BWD_ENTRIES["CUDA cores" if design == "tensor cores"
                            else "tensor cores"][1:]
        check(not any(w in key for key, _, _ in events for w in other),
              f"train {arch}: the profiled step ran {other} entries")
        ms_by = {w: sum(ms for key, ms, _ in events if w in key)
                 for w in entries}
        res.update(bwd_ms=sum(ms_by.values()),
                   bwd_share=sum(ms_by.values()) / busy,
                   bwd_ms_by_entry=ms_by, bwd_launches_by_entry=n_by)
    say(f"  train {arch} ({cfg.family}) at {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, full width, B {b} x "
        f"{positions // b} positions: losses "
        f"{[round(x, 4) for x in losses]}; {step_s * 1e3:.1f} ms a step "
        f"(host clock, {per} steps), {positions / step_s:.0f} positions/s; "
        f"peak {peak:.2f} GiB ({before:.2f} allocated before); profiled: "
        f"busy {busy} ms, idle share {res['idle_share']}; flash a step: "
        f"forward {fwd:g}, backward {bwd:g} (tensor cores {bwd_tc:g}, D "
        f"{cfg.head_dim}: {design}; dK/dV plan "
        f"{tuple(plan) if plan else None})"
        + (f"; backward {res['bwd_ms']:.3f} ms, {res['bwd_share']:.3f} of "
           f"busy, by entry (ms, launches) "
           f"{[(w, round(ms_by[w], 3), n_by[w]) for w in entries]}"
           if "bwd_ms" in res else "")
        + f"; {time.perf_counter() - t_all:.1f} s [{card}]")
    for key, ms, count in events[:5]:
        say(f"    {ms:9.4f} ms  x{count:5d}  {key}")
    del state, model
    torch.cuda.empty_cache()
    return res


def phase15_train(dev, card: str) -> dict:
    """``launch.train.main`` on ``TRAIN`` (losses finite and falling),
    launches, step time, tokens/s, peak memory and idle share; then the
    card against the CPU, ``--int8-grads`` and a checkpoint restart."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init, tree_leaves

    cfg = get_config(TRAIN["arch"])
    out = {}
    f0, b0 = fa.counter.count, fa.counter_bwd.count
    tc0 = fa.counter_bwd_tc.count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train.main(_train_args())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = TRAIN["steps"]
    fwd = (fa.counter.count - f0) / steps
    bwd = (fa.counter_bwd.count - b0) / steps
    bwd_tc = (fa.counter_bwd_tc.count - tc0) / steps
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(bwd == cfg.n_layers and fwd == 2 * cfg.n_layers,
          f"flash launches a step: forward {fwd}, backward {bwd}")
    check(bwd_tc == bwd, f"backwards a step on the tensor cores {bwd_tc} "
                         f"of {bwd}, as the launcher reports them")
    say(f"  train.main {TRAIN}: losses {[round(x, 4) for x in losses]}; "
        f"{wall:.2f} s with init, peak {peak:.2f} GiB allocated (with the "
        f"bf16 attention residual: {BF16_RESIDUAL['peak_gib']} GiB); "
        f"flash launches a step: forward {fwd:g}, backward {bwd:g} (on the "
        f"tensor cores: {bwd_tc:g}) [{card}]")
    out.update(losses=losses, peak_gib=peak, fwd_per_step=fwd,
               bwd_per_step=bwd)

    # ms a step on the host clock (synchronized), and one profiled step;
    # the memory the parameters and the AdamW state take (phase 16 holds
    # the dry-run's accounting to it)
    model = Model(cfg, device=dev)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    opt = adamw_init(params)
    torch.cuda.synchronize()
    out.update(params_allocated=m1 - m0,
               opt_allocated=torch.cuda.memory_allocated() - m1,
               params_nbytes=sum(t.nbytes for t in tree_leaves(params)),
               opt_nbytes=sum(t.nbytes for t in tree_leaves(
                   {"m": opt.m, "v": opt.v})) + opt.step.nbytes,
               n_leaves=len(list(_leaf_names(params))))
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                               global_batch=TRAIN["batch"]), device=dev)
    state = [params, opt]

    def one(step):
        p, o, loss, _, _ = train.train_step(model, state[0], state[1],
                                            pipe.batch_at(step), (), 3e-4,
                                            False)
        state[:] = [p, o]
        return loss

    one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        float(one(1 + i))
    step_s = (time.perf_counter() - t0) / 3
    entries = BWD_ENTRIES["tensor cores"] + BWD_ENTRIES["CUDA cores"][1:]

    def bwd_by_entry(events):
        n_by = {w: sum(n for key, _, n in events if w in key)
                for w in entries}
        ms_by = {w: sum(ms for key, ms, _ in events if w in key)
                 for w in entries}
        ok = all(n_by[w] == cfg.n_layers
                 for w in BWD_ENTRIES["tensor cores"]) and not any(
                     n_by[w] for w in BWD_ENTRIES["CUDA cores"][1:])
        return ok, n_by, ms_by

    # a session that records no GPU events, or drops some, is run again
    for _ in range(3):
        busy, pwall, events = profile_device(lambda: one(4), iters=1,
                                             n_top=None)
        ok, n_by, ms_by = bwd_by_entry(events)
        if busy is not None and ok:
            break
    tokens = TRAIN["batch"] * TRAIN["seq"]
    out.update(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
               busy_ms=busy,
               idle_share=None if busy is None else 1 - busy / (step_s * 1e3))
    say(f"  train step B {TRAIN['batch']} x S {TRAIN['seq']}: "
        f"{step_s * 1e3:.1f} ms (host clock, 3 steps; with the bf16 "
        f"residual {BF16_RESIDUAL['step_ms']} ms), {tokens / step_s:.0f} "
        f"tokens/s; "
        f"profiled: device busy {busy} ms, "
        f"wall {pwall} ms profiled; idle share {out['idle_share']} (busy "
        f"over the unprofiled step) [{card}]")
    for key, ms, count in events[:5]:
        say(f"    {ms:9.4f} ms  x{count:5d}  {key}")
    # the backward's device time ran in the tensor-core entries, once a
    # layer each: held wherever the profiler recorded the step (late in a
    # long process it may record nothing, or drop events: then no
    # CUDA-core entry may show, and the launcher's tally above stands)
    check(not any(n_by[w] for w in BWD_ENTRIES["CUDA cores"][1:]),
          f"the profiled step ran CUDA-core backward entries: {n_by}")
    if busy is None or not ok:
        say(f"  (the profiler did not record the whole step in three "
            f"sessions: backward entries seen {n_by}, device busy {busy})")
    if busy is not None:
        bwd_ms = sum(ms_by.values())
        out.update(bwd_ms=bwd_ms, bwd_share=bwd_ms / busy,
                   bwd_ms_by_entry=ms_by, bwd_launches_by_entry=n_by)
        say(f"  backward a step: {bwd_ms:.2f} ms of device time, "
            f"{bwd_ms / busy:.3f} of the busy time; by entry (ms, "
            f"launches): {[(w, round(ms_by[w], 3), n_by[w]) for w in ms_by]}"
            f" [{card}]")
    del state, params, opt, model
    torch.cuda.empty_cache()

    train_vs_cpu(dev, card)

    t0 = time.perf_counter()
    q8 = train.main(_train_args(steps=2) + ["--int8-grads"])
    check(len(q8) == 2 and all(map(math.isfinite, q8)), f"int8 {q8}")
    say(f"  --int8-grads, 2 steps: losses {q8} "
        f"({time.perf_counter() - t0:.1f} s)")

    ck = ROOT / "build" / "phase15_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    base = _train_args(steps=4, **TRAIN_CKPT)
    straight = train.main(base)
    small = _train_args(steps=2, **TRAIN_CKPT) + ["--ckpt", str(ck)]
    first = train.main(small)
    second = train.main(small)
    shutil.rmtree(ck, ignore_errors=True)
    restarted = first + second
    worst = max(abs(a - b) / abs(b) for a, b in zip(restarted, straight))
    check(len(restarted) == 4 and worst <= TRAIN_TOL["loss_rtol"],
          f"checkpoint restart {restarted} vs straight {straight}")
    say(f"  --ckpt 2 + 2 steps with a restart at B {TRAIN_CKPT['batch']} x "
        f"S {TRAIN_CKPT['seq']}: {restarted} vs 4 straight {straight} "
        f"(worst rtol {worst:.3g}, bound {TRAIN_TOL['loss_rtol']}); "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    torch.cuda.empty_cache()

    # the other families, one at a time, each freed before the next
    out["families"] = {}
    for arch, spec in TRAIN_FAMILIES.items():
        out["families"][arch] = train_family(dev, card, arch, spec)
        train_vs_cpu(dev, card, arch)

    # head dim 112 (kimi-k2-1t-a32b's) in training, at its smoke config
    b112, t112 = (fa.counter_bwd.by_size.get(112, 0),
                  fa.counter_bwd_tc.by_size.get(112, 0))
    arch = TRAIN_D112["arch"]
    train_vs_cpu(dev, card, arch, dataclasses.replace(
        get_config(arch, smoke=True), head_dim=TRAIN_D112["head_dim"]))
    ran = fa.counter_bwd.by_size.get(112, 0) - b112
    ran_tc = fa.counter_bwd_tc.by_size.get(112, 0) - t112
    check(ran > 0 and ran_tc == ran,
          f"{arch} D 112 training: {ran} flash_attention_bwd D 112 "
          f"launches on the card, {ran_tc} on the tensor cores")
    say(f"  {arch} D 112 training on the card: {ran} flash_attention_bwd "
        f"D 112 launches, all on the tensor cores [{card}]")

    # head dim 16 (recurrentgemma-9b's smoke config) in training: the
    # backward's 32-column instance, columns 16-31 zero-filled
    i0, t16 = (dict(fa.counter_bwd_instance.by_size),
               fa.counter_bwd_tc.by_size.get(16, 0))
    train_vs_cpu(dev, card, SMOKE_ARCH, get_config(SMOKE_ARCH, smoke=True))
    ran = new_tallies(fa.counter_bwd_instance, i0)
    ran_tc = fa.counter_bwd_tc.by_size.get(16, 0) - t16
    d16 = fa.plan_of(16, torch.bfloat16)
    check(set(ran) == {d16} and ran_tc == ran[d16],
          f"{SMOKE_ARCH} --smoke training: flash_attention_bwd launches by "
          f"plan {ran}, {ran_tc} on the tensor cores")
    say(f"  {SMOKE_ARCH} smoke (D 16) training on the card: "
        f"flash_attention_bwd launches by plan {ran}, all on the tensor "
        f"cores [{card}]")
    out["head_dims"] = head_dim_runs(dev, card)
    return out


def head_dim_runs(dev, card: str) -> dict:
    """``HEAD_DIM_RUNS``: qwen3-0.6b at full width, 2 layers, with
    ``head_dim`` 20 (bf16 rows of 40 bytes: flash on padded copies, paged
    loading them element by element) and then 264 (past the widest
    instance: column passes in all three kernels), card against CPU on
    the same weights: the prefill's last logits at B 2 x S 1,024, 16
    decode steps from a zero state (B 2), and one training step's loss
    and every gradient leaf (``train_vs_cpu``, B 1 x S 256); every launch
    on the plan ``plan_of`` gives, by the launchers' reports."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.models.model import Model

    spec = HEAD_DIM_RUNS
    b, n, steps = spec["batch"], spec["seq"], spec["steps"]
    out = {}
    for d in spec["dims"]:
        t0 = time.perf_counter()
        cfg = dc.replace(get_config(spec["arch"]), head_dim=d,
                         n_layers=spec["n_layers"])
        mg = Model(cfg, device=dev)
        pg = mg.init(torch.Generator(device=dev).manual_seed(7))
        mc, pc = Model(cfg, device="cpu"), _tree_to(pg, "cpu")
        gen = torch.Generator(device=dev).manual_seed(8)
        toks = torch.randint(0, cfg.vocab, (b, n), device=dev, generator=gen)
        dtoks = torch.randint(0, cfg.vocab, (b, steps), device=dev,
                              generator=gen)
        f0, p0 = (dict(c.by_size) for c in (fa.counter_instance,
                                            pa.counter_instance))
        lg, _ = mg.prefill(pg, toks)
        lc, _ = mc.prefill(pc, toks.cpu())
        perr, _ = _logits_close(lg, lc, f"{cfg.name} D {d} prefill card vs "
                                        f"CPU", argmax=False)
        sg, sc = mg.init_decode_state(b, steps), mc.init_decode_state(b,
                                                                      steps)
        got, want = [], []
        for t in range(steps):
            tok = dtoks[:, t:t + 1]
            lgd, sg = mg.decode_step(pg, sg, tok, t)
            lcd, sc = mc.decode_step(pc, sc, tok.cpu(), t)
            got.append(lgd[:, 0])
            want.append(lcd[:, 0])
        derr, _ = _logits_close(torch.stack(got, 1), torch.stack(want, 1),
                                f"{cfg.name} D {d} {steps} decode steps card "
                                f"vs CPU", argmax=False)
        flash = new_tallies(fa.counter_instance, f0)
        paged = new_tallies(pa.counter_instance, p0)
        check(flash == {fa.plan_of(d, torch.bfloat16): cfg.n_layers}
              and paged == {pa.plan_of(d, torch.bfloat16):
                            steps * cfg.n_layers},
              f"{cfg.name} D {d}: flash launches by plan {flash}, paged "
              f"{paged}")
        del mg, pg, mc, pc, sg, sc
        b0 = dict(fa.counter_bwd_instance.by_size)
        train_vs_cpu(dev, card, spec["arch"], cfg)
        bwd = new_tallies(fa.counter_bwd_instance, b0)
        check(bwd == {fa.plan_of(d, torch.bfloat16): cfg.n_layers},
              f"{cfg.name} D {d} training: backward launches by plan {bwd}")
        out[d] = dict(prefill_err=perr, decode_err=derr,
                      wall_s=time.perf_counter() - t0)
        say(f"  {cfg.name} head_dim {d} (full width, {cfg.n_layers} layers)"
            f" card vs CPU: prefill B {b} x S {n} last logits max |diff| "
            f"{perr:.4f}, {steps} decode steps B {b} max |diff| {derr:.4f} "
            f"(rtol {MODEL_RTOL}, atol {MODEL_ATOL}); launches by plan: "
            f"flash {flash}, paged {paged}, backward {bwd}; "
            f"{out[d]['wall_s']:.1f} s [{card}]")
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 16: the distribution and dry-run layer
# ---------------------------------------------------------------------------
# (a) split-sequence decode at decode_32k with qwen3-0.6b's heads: one
# length a sequence, on and around the parts' boundaries (4,096-row parts
# at n = 8, 8,192 at 4, 16,384 at 2), 0 among them; SPLIT_NS the splits
# (n = 1 is plain decode_attention, the reference's rule); the unsplit
# kernel took 0.294 ms at this shape with random lengths (this script, an
# H100 80GB HBM3 at 700 W)
SPLIT_DECODE = dict(b=8, h=16, kh=8, d=128, smax=32768)
SPLIT_LENGTHS = (32768, 16385, 16384, 8192, 4097, 4096, 1, 0)
SPLIT_NS = (1, 2, 4, 8)
UNSPLIT_MS_RANDOM = 0.294
# (b) combined embedding gradient at qwen3-0.6b's vocab and width: phase
# 15's step (2 x 4,096 tokens) and train_4k's tokens a data shard (256 x
# 4,096 / 16), Zipf ids (theta 0.99)
EMBED = dict(vocab=151_936, d=1024, tokens=(8192, 65536), theta=0.99,
             lr=0.1)
# (d) the CUDA caching allocator rounds every request up to a multiple of
# 512 bytes, and a block cut from a large segment keeps a remainder of up
# to 1 MiB that it does not split off (1,049,084 bytes over qwen3-0.6b's
# 27 AdamW blocks on an H100), so a tree of n tensors takes its bytes plus
# less than n (1 MiB + 512)
ALLOC_ROUND = (1 << 20) + 512


def split_decode(dev, card: str) -> dict:
    """``decode_attention_spmd`` at ``SPLIT_DECODE`` in bf16 for each of
    ``SPLIT_NS``, held to the unsplit kernel (``decode_attention``) within
    ``ATT_TOL`` and two bf16 ulps (both round once from f32); device time
    of each (n = 1 is the unsplit kernel)."""
    import torch
    from repro_torch.dist.decode_attn import decode_attention_spmd
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.attention import decode_attention

    c = SPLIT_DECODE
    b, h, kh, d, smax = c["b"], c["h"], c["kh"], c["d"], c["smax"]
    q = _randn((b, 1, h, d), torch.bfloat16, dev, 41)
    k = _randn((b, smax, kh, d), torch.bfloat16, dev, 42)
    v = _randn((b, smax, kh, d), torch.bfloat16, dev, 43)
    lens = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    want = decode_attention(q, k, v, lens)
    tol = ATT_TOL["bfloat16"]
    # the K and V rows every split reads (a length 0 reads every row)
    n_rows = sum(smax if n <= 0 else min(n, smax) for n in SPLIT_LENGTHS)
    fl = floor_ms(2 * n_rows * kh * d * 2, 4 * n_rows * h * d)
    out = {}
    for n in SPLIT_NS:
        mesh = make_local_mesh(1, dev, model=n)
        c0 = pa.counter.count
        got = decode_attention_spmd(mesh, q, k, v, lens)
        torch.cuda.synchronize()
        check(pa.counter.count == c0 + 1,
              f"split decode n {n}: {pa.counter.count - c0} paged launches")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        bad = int((diff > tol + tol * want.float().abs()).sum())
        bad_ulp = int((diff > 1e-5 + BF16_ULPS2 * want.float().abs()).sum())
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and bad == 0 and bad_ulp == 0,
              f"split decode n {n}: {bad} elements beyond {tol}, {bad_ulp} "
              f"beyond two bf16 ulps of the unsplit kernel (max |diff| "
              f"{err})")
        ms, call = timed(lambda: decode_attention_spmd(mesh, q, k, v, lens),
                         20, floor=fl)
        out[n] = dict(ms=ms, call_ms=call, max_abs_err=err)
        say(f"  decode_attention_spmd n {n} (parts of {smax // n} rows; "
            f"B {b} H {h} KH {kh} D {d} Smax {smax}, bf16, lengths "
            f"{list(SPLIT_LENGTHS)}): max |diff| {err:.3g} against the "
            f"unsplit kernel (within two bf16 ulps); device {ms:.4f} ms, "
            f"{call:.4f} ms a call (floor {fl:.4f} ms) "
            f"(n = 1: the unsplit kernel; {UNSPLIT_MS_RANDOM} ms earlier at "
            f"decode_32k's random lengths) [{card}]")
    return out


def embed_grad_paths(dev, card: str) -> dict:
    """``combined_embed_grad`` and ``apply_sparse_grad`` at ``EMBED`` in
    bf16 on Zipf ids, against the CPU (``hids`` and ``uniq`` bit for bit,
    ``rows`` within each row's f32 summation bound) and the SGD-applied
    table against the dense gradient's; unique ids and each path's time."""
    import torch
    from repro_torch.dist import embed_grad as eg
    from repro_torch.kernels.wc_combine import ops as wcc
    from repro_torch.workloads import zipf

    c = EMBED
    vocab, dim, lr = c["vocab"], c["d"], c["lr"]
    cdf = torch.from_numpy(zipf.zipf_cdf_table(vocab, c["theta"])).to(dev)
    table = (_randn((vocab, dim), torch.float32, dev, 51) * 0.02).to(
        torch.bfloat16)
    out = {}
    for t in c["tokens"]:
        ids = zipf.sample_zipf_torch(torch.Generator(device=dev).manual_seed(
            t), (t,), cdf, vocab)
        g = _randn((t, dim), torch.bfloat16, dev, t)
        c0 = wcc.counter.count
        hids, rows, uniq = eg.combined_embed_grad(ids, g)
        torch.cuda.synchronize()
        check(wcc.counter.count == c0 + 1,
              f"combined_embed_grad T {t}: {wcc.counter.count - c0} "
              f"wc_combine launches")
        ch, cr, cu = eg.combined_embed_grad(ids.cpu(), g.cpu())
        check(torch.equal(hids.cpu(), ch) and torch.equal(uniq.cpu(), cu),
              f"combined_embed_grad T {t}: hids/uniq differ from the CPU's")
        # each row: both sum its n tokens in f32 (in other orders) and round
        # once to bf16: within 2^-8 |row| of each other, plus 2 n 2^-24
        # sum |g| of f32 rounding
        n_id = torch.zeros(vocab, device=dev).index_add_(
            0, ids.long(), torch.ones(t, device=dev))
        abs_id = torch.zeros((vocab, dim), device=dev).index_add_(
            0, ids.long(), g.float().abs())
        sel = uniq.nonzero().squeeze(1)
        rid = hids[sel].long()
        got, want = rows[sel].float(), cr.to(dev)[sel].float()
        bound = 2.0 ** -8 * (got.abs() + want.abs()) \
            + 2 * n_id[rid, None] * 2.0 ** -24 * abs_id[rid] + 1e-6
        bad = int(((got - want).abs() > bound).sum())
        check(bad == 0, f"combined_embed_grad T {t}: {bad} row elements "
                        f"beyond the bound of the CPU's")
        sparse = eg.apply_sparse_grad(table.clone(), hids, rows, uniq, lr)
        dense32 = eg.dense_embed_grad(ids, g.float(), vocab)
        dense = table - (lr * eg.dense_embed_grad(ids, g, vocab)).to(
            torch.bfloat16)
        exact = table.float() - lr * dense32
        # the sparse step rounds three times in bf16 (the row, lr times
        # it, the sum), each within 2^-8 of a magnitude below |table| +
        # |step|, beside lr times the rows' f32 bound
        tol = 2.0 ** -6 * (exact.abs() + table.float().abs()) \
            + lr * 2 * n_id[:, None] * 2.0 ** -24 * abs_id + 1e-6
        bad_s = int(((sparse.float() - exact).abs() > tol).sum())
        check(bad_s == 0, f"apply_sparse_grad T {t}: {bad_s} elements "
                          f"beyond the bound of the dense f32 step")
        diff_d = float((sparse.float() - dense.float()).abs().max())
        n_uniq = int(uniq.sum())
        # floors: reading g and writing the rows; the representatives'
        # rows read, added and written back; the dense gradient's zeroed
        # (vocab, d) table written, the table read and the new one written
        es = g.element_size()
        comb_ms, _ = timed(lambda: eg.combined_embed_grad(ids, g), 10,
                           floor=floor_ms(2 * t * dim * es))
        work = table.clone()        # the step applied in place, repeatedly
        apply_ms, _ = timed(lambda: eg.apply_sparse_grad(
            work, hids, rows, uniq, lr), 10,
            floor=floor_ms(3 * n_uniq * dim * es))
        del work
        dense_ms, _ = timed(lambda: table - (lr * eg.dense_embed_grad(
            ids, g, vocab)).to(torch.bfloat16), 10,
            floor=floor_ms(3 * vocab * dim * es))
        out[t] = dict(unique=n_uniq, combined_ms=comb_ms, apply_ms=apply_ms,
                      dense_ms=dense_ms)
        say(f"  embed grad T {t} (vocab {vocab}, d {dim}, bf16, Zipf "
            f"{c['theta']}): {n_uniq} unique ids, {t - n_uniq} row writes "
            f"saved; hids/uniq == the CPU's, rows within their bound; SGD "
            f"table within the dense f32 step's bound (max |diff| to the "
            f"dense bf16 step {diff_d:.3g}); device: combined "
            f"{comb_ms:.4f} ms + apply {apply_ms:.4f} ms, dense gradient "
            f"and step {dense_ms:.4f} ms "
            f"[{card}]")
        del ids, g, hids, rows, uniq, sparse, dense, dense32, exact, abs_id
        torch.cuda.empty_cache()
    return out


DRYRUN_JOBS = 4     # the background grid's counting processes (8 cores)


class DryrunGrid:
    """``python -m repro_torch.launch.dryrun`` over the whole grid, in the
    background from its start on: ``DRYRUN_JOBS`` processes at nice 10
    count the cells' collectives (minutes of host CPU) while the card's
    phases run, and write the records under ``build/dryrun_torch``.  Its
    own session, so that ``stop`` ends its children too; a thread notes
    when it ends, on the script's clock (``t_start``)."""

    def __init__(self, t_start: float):
        self.outdir = ROOT / "build" / "dryrun_torch"
        shutil.rmtree(self.outdir, ignore_errors=True)
        self.outdir.parent.mkdir(parents=True, exist_ok=True)
        self.log_path = ROOT / "build" / "dryrun_torch.log"
        self.log = open(self.log_path, "w")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]))
        self.t_start = t_start
        self.t0 = time.perf_counter()
        self.t1 = None
        self.proc = subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-m",
             "repro_torch.launch.dryrun", "--out", str(self.outdir),
             "--jobs", str(DRYRUN_JOBS)],
            stdout=self.log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        atexit.register(self.stop)
        self.waiter = threading.Thread(target=self._note_end, daemon=True)
        self.waiter.start()

    def _note_end(self) -> None:
        self.proc.wait()
        self.t1 = time.perf_counter()

    def wait(self) -> int:
        self.waiter.join()
        return self.proc.returncode

    def span(self) -> tuple[float, float]:
        """The grid's start and end, seconds into the script."""
        return self.t0 - self.t_start, self.t1 - self.t_start

    def stop(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.log.close()


def dryrun_grid(card: str, grid: DryrunGrid) -> dict:
    """The dry-run of every (arch x cell) on both production meshes, on the
    host (``grid``, running since phase 14): 31 ok and 9 skipped a mesh,
    every ok cell's collectives counted and in its roofline; the report's
    tables and the collective-bound cells."""
    from repro_torch.launch import dryrun
    from repro_torch.rooflines import counter, report
    t0 = time.perf_counter()
    rc = grid.wait()
    waited = time.perf_counter() - t0
    grid.log.close()
    check(rc == 0, f"dry-run grid exited {rc}:\n"
                   f"{grid.log_path.read_text()[-4000:]}")
    say(f"  torch {counter.check_torch()} counts qwen3-0.6b's smoke steps "
        f"on a 2 x 4 mesh as {counter.SMOKE}, the count's pins")
    n = dryrun.main(["--out", str(grid.outdir)])   # reads the records back
    check(n == {"ok": 62, "skipped": 18}, f"dry-run grid {n}")
    recs = report.load(str(grid.outdir))
    ok = [r for r in recs if r["status"] == "ok"]
    bad = [(r["arch"], r["cell"], r["mesh"]) for r in ok
           if not (r["coll_bytes_per_chip"] > 0
                   and r["roofline"]["collective_s"] is not None)]
    check(not bad, f"dry-run cells without a collective term: {bad}")
    bound = {}
    for mesh in ("16x16", "2x16x16"):
        say(f"  dry-run {mesh} (host accounting, H100 constants):")
        say(report.table(recs, mesh))
        bound[mesh] = sorted(f"{r['arch']} {r['cell']}" for r in ok
                             if r["mesh"] == mesh
                             and r["roofline"]["bottleneck"] == "collective")
        say(f"  {mesh}: {len(bound[mesh])} of "
            f"{sum(r['mesh'] == mesh for r in ok)} ok cells "
            f"collective-bound: {bound[mesh]}")
    count_s = sum(r["coll_count_s"] for r in ok)
    flop_s = sum(r["count_s"] for r in ok)
    shutil.rmtree(grid.outdir, ignore_errors=True)
    start, end = grid.span()
    say(f"  dry-run grid: {n} in {end - start:.1f} s of host wall time in the "
        f"background ({DRYRUN_JOBS} processes at nice 10, from t = "
        f"{start:.1f} s to t = {end:.1f} s of the script), {waited:.1f} s of "
        f"it waited for in phase 16; collective counts {count_s:.1f} s and "
        f"FLOP counts {flop_s:.1f} s of process time [{card}]")
    return {"wall_s": end - start, "waited_s": waited,
            "coll_count_s": count_s,
            "collective_bound": {m: len(b) for m, b in bound.items()}, **n}


def memory_accounting(dev, card: str, mem15: dict) -> None:
    """The dry-run's parameter and AdamW-state bytes of qwen3-0.6b on a 1 x
    1 mesh against the bytes of the tensors phase 15 created, exactly; and
    the growth of ``memory_allocated()`` when it created them against
    those bytes, up to the allocator's rounding (``ALLOC_ROUND`` a
    block)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.rooflines.counter import argument_bytes
    acc = argument_bytes(Model(get_config(TRAIN["arch"]), "meta"), "train",
                         TRAIN["seq"], TRAIN["batch"],
                         make_local_mesh(1, "cpu"))
    n = mem15["n_leaves"]
    for key, nbytes, got, blocks in (
            ("params", mem15["params_nbytes"], mem15["params_allocated"], n),
            ("opt_state", mem15["opt_nbytes"], mem15["opt_allocated"],
             2 * n + 1)):
        check(acc[key] == nbytes,
              f"memory accounting {key}: {acc[key]} bytes accounted, the "
              f"tensors hold {nbytes}")
        check(nbytes <= got < nbytes + ALLOC_ROUND * blocks,
              f"memory accounting {key}: the tensors hold {nbytes} bytes, "
              f"{got} allocated ({blocks} blocks of up to {ALLOC_ROUND} "
              f"bytes of rounding)")
        say(f"  memory: {key} of {TRAIN['arch']} {acc[key]} bytes by the "
            f"dry-run's accounting (1 x 1 mesh) == the {nbytes} bytes of "
            f"the tensors phase 15 created; {got} allocated: {got - nbytes}"
            f" bytes of allocator rounding over {blocks} blocks [{card}]")


def phase16_dist(dev, card: str, mem15: dict, grid: DryrunGrid) -> dict:
    """(a) split-sequence decode, (b) the combined embedding gradient, (c)
    the dry-run grid, (d) the dry-run's memory accounting against the
    card's allocator."""
    out = {}
    for key, fn in (("split_decode", lambda: split_decode(dev, card)),
                    ("embed_grad", lambda: embed_grad_paths(dev, card)),
                    ("dryrun", lambda: dryrun_grid(card, grid)),
                    ("memory", lambda: memory_accounting(dev, card, mem15))):
        t0 = time.perf_counter()
        out[key] = fn()
        say(f"  phase 16 {key}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the reference's drivers (examples_torch/*.py and
# tools/analyze_torch.py, the counterparts of examples/*.py and
# tools/analyze.py), each main() on the card.  Their rows are pinned from
# the reference's examples by tests/test_torch_examples.py, which holds the
# port's rows on the CPU to the same values.  cider_sim_figures adds no run
# here: phase 13's pinned runs (its base_{mode}_{48,512} among them) go
# through its sweep.  Their attention shapes (the smoke qwen3-0.6b's D 32)
# are phase 1's SMOKE_PAGED, SMOKE_FLASH and BWD_CASES' "smoke_train".
# ---------------------------------------------------------------------------
# quickstart: workload -> (ops, modeled Mops/s of OSYNC, SPIN, MCS, CIDER)
QUICKSTART_MOPS = {"A": (3072, (8.4825, 7.5758, 9.4989, 10.4312)),
                   "B": (3072, (15.442, 14.6722, 14.8968, 15.4736)),
                   "C": (3072, (16.0, 16.0, 16.0, 16.0)),
                   "D": (3072, (15.6112, 15.6112, 15.6112, 15.6112)),
                   "E": (3072, (1.2319, 0.9338, 0.9338, 1.8097)),
                   "F": (3072, (10.5363, 9.2002, 10.8563, 12.0367))}
# dynamic_contention, a window a row: updates, pessimistic updates, combined
# updates, credit mass, p99 (us, to the printed 0.1)
DYNAMIC_ROWS = ((261, 0, 17, 0, 189.4), (262, 0, 16, 432, 175.1),
                (244, 153, 142, 339, 57.2), (262, 167, 156, 275, 57.5),
                (258, 174, 160, 266, 57.3), (266, 182, 166, 207, 57.4),
                (269, 188, 171, 206, 57.3), (240, 173, 156, 169, 55.5),
                (261, 61, 60, 140, 145.0), (245, 49, 52, 422, 136.6),
                (258, 159, 143, 307, 56.3), (245, 180, 164, 177, 55.4),
                (264, 176, 157, 103, 57.4), (251, 167, 151, 130, 55.3),
                (275, 188, 171, 101, 57.7), (273, 187, 169, 132, 57.5))
# crash_recovery: mode -> a window a row (repair CAS, p99 us to the printed
# 1); mode -> (repair CAS, windows to repair, post-crash p99); the failover
CRASH_WINDOWS = {
    "SPIN": ((0, 445), (0, 444), (0, 440), (0, 443), (0, 437), (0, 441),
             (0, 443), (0, 443), (900, 873), (6, 338), (24, 391), (0, 331),
             (12, 347), (0, 331), (0, 330), (0, 333)),
    "MCS": ((0, 531), (0, 532), (0, 529), (0, 531), (0, 528), (0, 530),
            (0, 530), (0, 530), (62, 8655), (1, 407), (5, 451), (0, 398),
            (2, 416), (0, 399), (0, 399), (0, 399)),
    "CIDER": ((0, 432), (0, 426), (0, 59), (0, 60), (0, 58), (0, 59),
              (0, 60), (0, 59), (15, 566), (0, 49), (0, 49), (0, 49),
              (0, 49), (0, 49), (0, 49), (0, 49))}
CRASH_SUMMARY = {"SPIN": (942, 8, 689), "MCS": (70, 8, 8413),
                 "CIDER": (15, 1, 561)}
CRASH_FAILOVER = {"dead_shards": [1], "reown_reads": 1024}
# serve_kv_cache: the reference example's scheduler stats
SERVE_KV_STATS = {"prefix_hits": 11, "prefix_misses": 13, "admitted": 12,
                  "completed": 12}
TRAIN_LM_CPU_STEPS = 3     # train_lm's first steps replayed on the CPU


def load_driver(rel: str):
    """A driver file of the checkout (``examples_torch/<name>.py``,
    ``tools/analyze_torch.py``) as a module."""
    import importlib.util
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "driver_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet_main(mod, argv: list):
    """``mod.main(argv)`` with its table kept for the log's tail."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    return out, buf.getvalue()


def drive_quickstart(dev, card: str) -> None:
    rows, text = quiet_main(load_driver("examples_torch/quickstart.py"),
                            ["--device", str(dev)])
    got = {r["workload"]: (r["n_ops"], tuple(r["mops"])) for r in rows}
    check(got == QUICKSTART_MOPS, f"quickstart {got} != {QUICKSTART_MOPS}")
    say("  quickstart: modeled Mops/s == QUICKSTART_MOPS (A-F x OSYNC, SPIN, "
        "MCS, CIDER):\n    " + "\n    ".join(text.strip().splitlines()[:7]))


def drive_dynamic(dev, card: str) -> None:
    rows, _ = quiet_main(load_driver("examples_torch/dynamic_contention.py"),
                         ["--device", str(dev)])
    check(len(rows) == len(DYNAMIC_ROWS), f"dynamic rows {len(rows)}")
    for r, pin in zip(rows, DYNAMIC_ROWS):
        got = (r["updates"], r["pess"], r["wc"], r["credits"])
        check(got == pin[:4] and f"{r['p99_us']:.1f}" == f"{pin[4]:.1f}",
              f"dynamic window {r['window']}: {got}, p99 {r['p99_us']:.1f}; "
              f"pinned {pin}")
    say(f"  dynamic_contention: 16 windows (pess, wc, credit mass, p99) == "
        f"DYNAMIC_ROWS; pess% {[round(100 * r['pess'] / r['updates'], 1) for r in rows]}")


def drive_crash(dev, card: str) -> None:
    out, _ = quiet_main(load_driver("examples_torch/crash_recovery.py"),
                        ["--device", str(dev)])
    for mode, pins in CRASH_WINDOWS.items():
        for w, ((rep, p99), cells) in enumerate(zip(pins, out["windows"])):
            got = cells[mode]
            check(got[0] == rep and f"{got[1]:.0f}" == f"{p99:.0f}",
                  f"crash_recovery {mode} window {w}: {got}, pinned "
                  f"{(rep, p99)}")
        s = out["summary"][mode]
        pin = CRASH_SUMMARY[mode]
        check((s["repair_cas"], s["windows_to_repair"]) == pin[:2]
              and f"{s['p99_us']:.0f}" == f"{pin[2]:.0f}",
              f"crash_recovery {mode} summary {s}, pinned {pin}")
    check(out["failover"] == CRASH_FAILOVER,
          f"crash_recovery failover {out['failover']}")
    say(f"  crash_recovery: repair CAS and p99 a window == CRASH_WINDOWS, "
        f"summaries == CRASH_SUMMARY {CRASH_SUMMARY}; 2-shard failover "
        f"{out['failover']}, its bill bit-equal to the single-device run")


def drive_serve(dev, card: str) -> None:
    stats, _ = quiet_main(load_driver("examples_torch/serve_kv_cache.py"),
                          ["--device", str(dev)])
    check(stats == SERVE_KV_STATS, f"serve_kv_cache {stats}")
    say(f"  serve_kv_cache: stats {stats} == SERVE_KV_STATS")


def drive_train(dev, card: str) -> None:
    """The example's 200 steps into a fresh checkpoint directory (losses
    finite, falling by the example's own assert), then its first
    ``TRAIN_LM_CPU_STEPS`` steps on the CPU from the card's initial weights
    and batches, losses within ``TRAIN_TOL``'s rtol."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init, tree_map
    ex = load_driver("examples_torch/train_lm.py")
    ckpt = ROOT / "build" / "phase17_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        losses, _ = quiet_main(ex, ["--device", str(dev), "--ckpt",
                                    str(ckpt)])
        saved = train.latest_step(str(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(len(losses) == 200 and all(map(math.isfinite, losses)),
          f"train_lm losses {losses[:3]}...")
    check(saved == 200, f"train_lm's last checkpoint is step {saved}")
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8),
                    device=dev)
    cpu = Model(cfg, device="cpu")
    params = tree_map(lambda p: p.cpu(), params)
    opt = adamw_init(params)
    got = []
    for step in range(TRAIN_LM_CPU_STEPS):
        batch = {k: v.cpu() for k, v in pipe.batch_at(step).items()}
        params, opt, loss, _, _ = train.train_step(cpu, params, opt, batch,
                                                   (), 3e-4, False)
        got.append(float(loss))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, got)]
    check(max(rel) <= TRAIN_TOL["loss_rtol"],
          f"train_lm card {losses[:TRAIN_LM_CPU_STEPS]} vs CPU {got}")
    say(f"  train_lm: 200 steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"checkpoints at 100 and 200; first {TRAIN_LM_CPU_STEPS} losses "
        f"within {max(rel):.2g} of the CPU's from the card's weights and "
        f"batches (rtol {TRAIN_TOL['loss_rtol']})")


def drive_analyze(dev, card: str) -> None:
    tool = load_driver("tools/analyze_torch.py")
    report = ROOT / "build" / tool.DEFAULT_REPORT
    report.parent.mkdir(parents=True, exist_ok=True)
    rc, text = quiet_main(tool, ["--device", str(dev), "--report",
                                 str(report)])
    rep = json.loads(report.read_text())
    check(rc == 0 and rep["ok"] and list(rep["passes"]) == [
        "device_check", "bill_lint", "race_check"],
        f"analyze_torch exited {rc}:\n{text}")
    say("  analyze_torch: " + "; ".join(
        f"{n} clean ({p['seconds']} s)" for n, p in rep["passes"].items())
        + " on " + str(dev) + "\n    " + "\n    ".join(
            ln for ln in text.splitlines() if "note:" in ln))


DRIVERS = (("quickstart", drive_quickstart),
           ("dynamic_contention", drive_dynamic),
           ("crash_recovery", drive_crash),
           ("serve_kv_cache", drive_serve), ("train_lm", drive_train),
           ("analyze_torch", drive_analyze))


def phase17_drivers(dev, card: str) -> dict:
    """Each driver's ``main`` on the card, its rows against the pins;
    returns the seconds each took."""
    import torch
    out = {}
    for name, fn in DRIVERS:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(dev, card)
        torch.cuda.synchronize(dev)
        out[name] = time.perf_counter() - t0
        say(f"  phase 17 {name}: {out[name]:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found next to this "
                         "script; run it from a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs "
                         "the port on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.kernels.wc_combine import ops as wcc
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    say("== phase 0: build")
    t0 = time.perf_counter()
    logs = build.build()
    say(f"  built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        spilled = ptxas_report(name, log)
        check(name not in KERNEL_META or spilled == 0,
              f"{name} spills {spilled} bytes (ptxas -v)")
    for name in KERNEL_META:
        if name not in logs:
            say(f"  {name}: library cached, no ptxas report in this run")
    attention_smem()
    for name in ("flash_attention", "flash_attention_bwd"):
        n_hgmma = hgmma_count(build.library_path(name))
        say(f"  cuobjdump -sass: {n_hgmma} HGMMA instructions in "
            f"{build.library_path(name).name}")
        check(n_hgmma > 0, f"{name}'s SASS holds no HGMMA: its bf16 path "
                           f"does not run on the tensor cores")
    counters = {"wc_combine": wcc.counter, "scan_probe": sp.counter,
                "paged_attention": pa.counter, "flash_attention": fa.counter,
                "flash_attention_bwd": fa.counter_bwd}

    def phase(n: int, what: str) -> None:
        say(f"== phase {n}: {what} [{card}] "
            f"(t = {time.perf_counter() - t_start:.1f} s)")

    phase(1, "kernels vs plain versions on the card")
    stats = phase1_kernels(dev, card)
    phase1_helpers(dev)
    say(f"  (t = {time.perf_counter() - t_start:.1f} s)")
    att = phase1_attention(dev, card)
    c4_seeded(dev, card)

    instances = {"flash_attention": fa.counter_instance,
                 "flash_attention_bwd": fa.counter_bwd_instance,
                 "paged_attention": pa.counter_instance}
    for c in (*counters.values(), *instances.values(), fa.counter_tc,
              fa.counter_bwd_tc, fa.counter_bwd_plan, fa.counter_cols,
              fa.counter_bwd_cols, pa.counter_narrow):
        c.reset()              # the main paths' runs start here
    per_phase = {1: {n: 0 for n in counters}}
    steps = (
        (2, "engine_json configuration", lambda: phase2_engine_json(dev, card)),
        (3, "YCSB A-F at the ycsb_json size", lambda: phase3_ycsb(dev, card)),
        (4, "deployment scale, YCSB A and E", lambda: phase4_deployment(
            dev, card, n_keys=1 << 24, windows=64, batch=4096, n_cns=64,
            credit_table=4096)),
        (5, "qwen3-0.6b prefill and decode at full width",
         lambda: phase5_model(dev, card)),
        (6, "serve qwen3-0.6b at full width", lambda: phase6_serve(dev, card)),
        (7, "crash recovery, BENCH_recovery.json",
         lambda: phase7_recovery(dev, card)),
        (8, "MN replication, BENCH_replication.json",
         lambda: phase8_replication(dev, card)),
        (9, "dynamic scenarios, BENCH_scenarios.json",
         lambda: phase9_scenarios(dev, card)),
        (10, "open-loop arrivals at BENCH_scale.json's open-loop size",
         lambda: phase10_open_loop(dev, card)),
        (11, "deployment scale: crash recovery with MN replication, "
             "RaceHash", lambda: phase11_deployment(
                 dev, card, n_keys=1 << 24, windows=64, batch=4096, n_cns=64,
                 credit_table=4096)),
        (12, "the sharded store: BENCH_*.json sharded rows, weak scaling, "
             "2^24 keys over 4 shards", lambda: phase12_sharded(
                 dev, card, n_keys=1 << 24, windows=64, batch=4096, n_cns=64,
                 credit_table=4096)),
        (13, "the protocol simulator: pinned runs through CUDA graphs, "
             "graph vs eager, replay, race_check conformance",
         lambda: phase13_sim(dev, card)),
        (14, "the other model families at full width: "
             + ", ".join(PHASE14), lambda: phase14_families(dev, card)),
        (15, "training every family at full width: qwen3-0.6b at full "
             "depth, then " + ", ".join(TRAIN_FAMILIES),
         lambda: phase15_train(dev, card)),
        (16, "the distribution and dry-run layer: split-sequence decode, "
             "the combined embedding gradient, the dry-run grid, memory "
             "accounting", lambda: phase16_dist(dev, card, results[15],
                                                grid)),
        (17, "the reference's drivers: examples_torch/*.py and "
             "tools/analyze_torch.py", lambda: phase17_drivers(dev, card)))
    grid = None
    results = {}
    # a graph's kernels are counted once, at capture: phase 13 returns its
    # replays' launches, added here
    replayed = {name: 0 for name in counters}

    def mark(n):
        per_phase[n] = {name: c.count + replayed[name]
                        for name, c in counters.items()}

    phase_s = {}
    for n, what, fn in steps:
        phase(n, what)
        t_phase = time.perf_counter()
        result = results[n] = fn()
        phase_s[n] = time.perf_counter() - t_phase
        say(f"  phase {n} took {phase_s[n]:.1f} s")
        if n == 14:
            # phase 16's dry-run, on the host beside phase 15's training
            # steps, which keep the card busy (phases 2-13 time host-bound
            # runs)
            grid = DryrunGrid(t_start)
        if n == 13:
            for (name, n_lanes), k in result.items():
                replayed[name] += k
                by_size = counters[name].by_size
                by_size[n_lanes] = by_size.get(n_lanes, 0) + k
            say(f"  phase 13 launches beyond the captures: {result}")
        mark(n)
    launches = dict(per_phase[17])
    say(f"  seconds by phase: {({n: round(t, 1) for n, t in phase_s.items()})}")
    say(f"  main-path launches: {launches}; cumulative after each phase: "
        f"{per_phase}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for name in KERNEL_META:
        by_n = dict(sorted(counters[name].by_size.items()))
        say(f"  {name} main-path launches by N: {by_n}; N not in "
            f"SWEEP_SIZES: {sorted(set(by_n) - set(SWEEP_SIZES))}")
    for name in ("flash_attention", "paged_attention", "flash_attention_bwd"):
        by_d = dict(sorted(counters[name].by_size.items()))
        say(f"  {name} main-path launches by head dim: {by_d}")
        # each head dim on the instance and passes its plan names; every
        # published config's head dim that runs this kernel launched, on
        # its own instance, unpadded, in one pass (no published path runs
        # zero columns or a padded copy); D 16 (the smoke
        # recurrentgemma-9b), 20 and 264 (HEAD_DIM_RUNS) on their plans
        ops = pa if name == "paged_attention" else fa
        by_inst = dict(sorted(instances[name].by_size.items()))
        say(f"  {name} main-path launches by plan (head dim, instance, "
            f"passes, padded): {by_inst}")
        check(sum(by_inst.values()) == counters[name].count,
              f"{name}: {sum(by_inst.values())} launches by instance, "
              f"{counters[name].count} in all")
        for plan, n in by_inst.items():
            want = ops.plan_of(plan.d, torch.float32)
            check((plan.w, plan.passes) == (want.w, want.passes),
                  f"{name} D {plan.d} ran on {plan}, its plan names the "
                  f"{want.w}-column instance in {want.passes} passes")
        published = published_head_dims(decode=name == "paged_attention")
        ran = {p for p in by_inst if p.d in published}
        check(ran == {(d, d, 1, False) for d in published},
              f"{name}: the published head dims {published} ran on the "
              f"plans {ran}")
        say(f"  {name}: every published head dim {published} ran on its "
            f"own instance, unpadded, in one pass; D 16, 20 and 264 on "
            f"{[tuple(p) for p in by_inst if p.d in (16, 20, 264)]}")
        for d in (16, *HEAD_DIM_RUNS["dims"]):
            want = ops.plan_of(d, torch.bfloat16)
            check(by_inst.get(want, 0) > 0,
                  f"{name} D {d} did not run on its plan {want} on the "
                  f"main path")
    moe_dispatch = wcc.counter.by_tag.get("moe_dispatch", 0)
    say(f"  wc_combine main-path launches from the MoE dispatch: "
        f"{moe_dispatch}, from everything else (graph replays included): "
        f"{launches['wc_combine'] - moe_dispatch}")
    for phase_n, names in ((2, ("wc_combine",)), (3, ("wc_combine",
                                                      "scan_probe")),
                           (4, ("wc_combine", "scan_probe")),
                           (5, ("paged_attention", "flash_attention")),
                           (6, ("wc_combine", "paged_attention")),
                           (7, ("wc_combine",)), (8, ("wc_combine",)),
                           (9, ("wc_combine",)), (10, ("wc_combine",)),
                           (11, ("wc_combine",)),
                           (12, ("wc_combine", "scan_probe")),
                           (13, ("wc_combine",)),
                           (14, ("wc_combine", "paged_attention",
                                 "flash_attention")),
                           (15, ("flash_attention", "flash_attention_bwd")),
                           (16, ("wc_combine", "paged_attention")),
                           (17, tuple(counters))):
        for name in names:
            check(per_phase[phase_n][name] > per_phase[phase_n - 1][name],
                  f"{name} was not launched in phase {phase_n}")
    check(moe_dispatch > 0, "the MoE dispatch launched no wc_combine")
    for name, meta in ATTN_META.items():
        kernel = meta.get("kernel", name)
        check(counters[kernel].by_size.get(meta["d"], 0) > 0,
              f"{kernel} at head dim {meta['d']} was not launched on the "
              f"main path")

    rows = []
    for name, meta in KERNEL_META.items():
        t = stats[name]["times"][meta["main_n"]]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": stats[name]["max_abs_err"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": None, "call_ms": t["call_ms"],
                     "plain_call_ms": t["plain_call_ms"],
                     "floor_ms": stats[name]["times"][1]["ms"],
                     "cumsum_ms": t["cumsum_ms"],
                     "launches_by_n": dict(sorted(
                         counters[name].by_size.items())),
                     "ms_by_n": {n: v["ms"] for n, v in
                                 stats[name]["times"].items()}})
        if name == "wc_combine":
            rows[-1]["launches_moe_dispatch"] = moe_dispatch
    for name, meta in ATTN_META.items():
        t = att[name]
        kernel = meta.get("kernel", name)
        row = {"name": name, "route": "cuda", "source": meta["source"],
               "replaces": meta["replaces"],
               "launches": (launches[name] if kernel == name else
                            counters[kernel].by_size.get(meta["d"], 0)),
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "call_ms": t["call_ms"],
               "plain_call_ms": t["plain_call_ms"],
               "library_call_ms": t["library_call_ms"],
               "head_dim": meta["d"], "shape_of": meta["main"]}
        for key in ("design", "ms_by_entry", "library_kernel", "ptxas",
                    "smem_bytes", "plan", "ring", "instance", "floor_ms",
                    "between_instances"):
            if t.get(key) is not None:
                row[key] = t[key]
        if kernel == name:
            row["launches_by_head_dim"] = dict(sorted(
                counters[name].by_size.items()))
            row["launches_by_plan_of_head_dim"] = {
                str(tuple(p)): n for p, n
                in sorted(instances[name].by_size.items())}
        if kernel == "flash_attention_bwd":
            row["launches_tensor_cores"] = (
                fa.counter_bwd_tc.count if kernel == name
                else fa.counter_bwd_tc.by_size.get(meta["d"], 0))
            row["note"] = "delta from the forward's f32 output"
            if kernel == name:   # the main path's dK/dV plans
                row["launches_by_plan"] = {
                    str(tuple(p)): n
                    for p, n in fa.counter_bwd_plan.by_size.items()}
        elif kernel == "flash_attention":
            row["launches_tensor_cores"] = (
                fa.counter_tc.count if kernel == name
                else fa.counter_tc.by_size.get(meta["d"], 0))
            row["note"] = ("with return_lse (training) also writes the "
                           "f32 output and each row's log-sum-exp")
        elif kernel == "paged_attention":
            row["note"] = ("with return_lse (the split-sequence decode's "
                           "parts) writes the f32 output and each head's "
                           "log-sum-exp, and reads nothing for a length "
                           "<= 0")
        rows.append(row)
    say(f"  all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
