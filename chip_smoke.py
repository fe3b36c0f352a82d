#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the CIDER engine on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, from the repo root

Phases (any mismatch raises, and the script exits non-zero):

0. device and build — the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds all four kernels of ``src/repro_torch/kernels/csrc``; each
   kernel's registers and spills (``ptxas -v``; the sort sweeps must not
   spill), the attention kernels' shared memory per block, and a check that
   ``cuobjdump -sass`` of the flash library holds ``HGMMA`` (bf16 runs on
   the tensor cores).
1. each kernel against its plain PyTorch version on the card: the two sort
   sweeps bit for bit over N in ``SWEEP_SIZES`` (1-3, 64, every tile edge of
   either kernel, ragged last tiles, the main path's sizes, 2^20) and four
   key layouts, each
   one kernel launch per call; their times at the main path's N and 2^20
   beside their single-launch floor (N = 1) and ``torch.cumsum``;
   the integer helpers (``_backoff_polls``, ``credit_slot``);
   ``paged_attention`` at the serve shape (every length 1-40), at
   decode_32k and at its table shape with lengths 4,096, 32,768 and on the
   split boundaries (0, 1, SPLIT - 1, SPLIT, SPLIT + 1, ...), and
   ``flash_attention`` at the prefill shape (B 2, S 4096),
   a ragged S, no mask and a 1024-token window, each in bf16 and f32 within
   the tolerances of ``tests/test_kernels.py`` (bf16 also within two ulps);
   kernel, plain, library and bound times.
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
   steps on the card against the same weights on the CPU; prefill logits
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
    ``run_sim`` at the default ``SimParams`` (1,024 lanes, 32,768 ticks),
    at ``benchmarks/run.py``'s BASE in 4 modes x {48, 512} clients and
    CIDER with ``wc_off``, ``cas_off`` and 3 MN replicas, and the two crash
    configurations of ``tests/test_substrates.py``: every ``SimResult``
    field equal to ``SIM_PINS`` (pinned from the JAX reference by
    ``tests/test_torch_sim_pins.py``), wall time and ms a tick each;
    256 ticks eagerly and through the graphs from one full-width state in
    all 4 modes, every ``SimState`` field equal; ms a tick by replay and
    eagerly, kernels a tick and the idle share of one profiled replay;
    replays and an engine window loop under
    ``torch.cuda.set_sync_debug_mode("error")``; and ``race_check``'s
    tick-level conformance scenario on the card.

Phases 7-12 print the wall time and peak device memory of their runs and
the idle share of one profiled rerun each.  The launch counters are zeroed
just before phase 2 and read after phase 13; every kernel must have
launched in that run, in the phases that run it.  A kernel captured into a
CUDA graph (phase 13) is counted once at capture, so its replays' launches
are added from the graphs' capture counts and replay counts.  The last
lines are the kernel table as JSON, the card's name and power limit, and
the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 16.7e12      # 132 SMs x 64 int32 lanes x 1.98 GHz
FLOPS = {"bfloat16": 989e12,   # H100 SXM dense tensor-core bf16
         "float32": 67e12}     # H100 SXM f32 outside the tensor cores
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
# path's sizes (the simulator's 3, 64, 512 and 1024 lanes among them) and
# 2^20
SWEEP_SIZES = (1, 2, 3, 64, 511, 512, 513, 514, 1000, 1023, 1024, 1025, 2047,
               2048, 2049, 4095, 4096, 4097, 4098, 8192, 9692, 34816, 69632,
               1 << 20)
SWEEP_TIMED = (1, 1024, 4096, 34816, 69632, 1 << 20)
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
    "paged_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:61",
        main="serve"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:69",
        main="prefill"),
}


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


_ENTRY = re.compile(r"(flash_fwd_bf16|flash_fwd_f32|paged_split_kernel|"
                    r"paged_merge_kernel)I(13__nv_bfloat16|f)?Li(\d+)E")
_SWEEP_ENTRY = re.compile(r"(wc_combine_kernel|scan_probe_kernel)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(name: str, log: str) -> int:
    """Registers, spills and static shared memory of each entry function
    of library ``name``, from ``nvcc -Xptxas -v``'s log.  Returns the bytes
    of spill stores and loads over all its entries."""
    entry, spilled = None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _ENTRY.search(line)
            sweep = _SWEEP_ENTRY.search(line)
            dtype = {"13__nv_bfloat16": "bf16, ", "f": "f32, "}.get(
                m.group(2), "") if m else ""
            entry = (f"{m.group(1)}<{dtype}D={m.group(3)}>" if m
                     else sweep.group(1) if sweep
                     else line.split("'")[1][:72])
        elif entry and any(w in line for w in ("registers", "spill",
                                               "smem")):
            spill = _SPILLS.search(line)
            if spill:
                spilled += int(spill.group(1)) + int(spill.group(2))
            say(f"  {name}: {entry}: {line.split(':', 1)[-1].strip()}")
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
    for dtype, label in ((1, "bf16"), (0, "f32")):
        flash = {d: fns["flash_attention"](dtype, d) for d in (32, 64, 128)}
        paged = {d: fns["paged_attention"](dtype, d, 2) for d in (32, 64, 128)}
        say(f"  dynamic shared memory per block, {label}, by D: "
            f"flash_attention {flash} B; paged_attention (g = 2) {paged} B")


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


def profile_device(fn, iters: int = 20):
    """Run ``fn`` ``iters`` times under ``torch.profiler``, tracing the
    device only (a trace of the CPU's operators would be most of the
    processing time of a long run, and no number here reads it).  Returns
    ``(device_ms_per_call, wall_ms_per_call, top)``: the summed self device
    time of every GPU event, the host wall time around the calls, and the
    five events with the most device time.  The device time is None when
    the profiler recorded no GPU events."""
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
    top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:5]
    top = [(e.key[:60], e.self_device_time_total / 1e3 / iters, e.count)
           for e in top]
    return (total if gpu else None), wall, top


def timed(fn, iters: int):
    """``(device ms, call ms)`` per call of ``fn``: the profiler's summed
    device time (a session that records no GPU events is run again, up to
    three times; then CUDA events), and the CUDA-event time of back-to-back
    calls, which includes host overhead."""
    call = cuda_ms(fn, iters=iters, warmup=1)
    for _ in range(3):
        dev = profile_device(fn, iters=iters)[0]
        if dev is not None:
            return dev, call
    say("  (the profiler recorded no GPU events: device time by CUDA events)")
    return call, call


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


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int((hi - lo + 1).sum())


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

    # paged: the serve shape (one 40-row page per sequence, the identity
    # block table, lengths 1-40), and decode_32k (B 8, lengths up to 32,768,
    # 16-row pages, a permuted block table into a larger pool: 64 splits),
    # also with every length 4,096, every length 32,768, and lengths on the
    # split boundaries
    rng = np.random.default_rng(32)
    sp = pa.SPLIT
    for label, b, page, np_, extra in (
            ("serve", 1, 40, 1, 0), ("decode_32k", 8, 16, 2048, 64),
            ("len_4096", 8, 16, 2048, 64), ("len_32768", 8, 16, 2048, 64),
            ("split_edges", 8, 16, 2048, 64)):
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
        else:
            lens_np = np.full(b, int(label[4:]), np.int32)
        bt = torch.as_tensor(bt_np.astype(np.int32), device=dev)
        lens = torch.as_tensor(lens_np, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn((b, h, d), dtype, dev, 1)
            kp = _randn((npool, page, kh, d), dtype, dev, 2)
            vp = _randn((npool, page, kh, d), dtype, dev, 3)
            args = (q, kp, vp, bt, lens)
            err = compare("paged_attention", pa.paged_attention_cuda(*args),
                          pa.paged_attention_ref(*args), dtype,
                          f"{label} {dtype}")
            if label == "serve":
                # every other length the serve gives the kernel: the mask
                # inside the page
                for n in range(1, 40):
                    ln = torch.full((1,), n, dtype=torch.int32, device=dev)
                    compare("paged_attention",
                            pa.paged_attention_cuda(q, kp, vp, bt, ln),
                            pa.paged_attention_ref(q, kp, vp, bt, ln), dtype,
                            f"serve length {n} {dtype}")
            ms, call = timed(lambda: pa.paged_attention_cuda(*args), 20)
            plain, plain_call = timed(lambda: pa.paged_attention_ref(*args), 5)
            # yardstick: SDPA over the same rows as a dense cache
            dk = kp[bt.long()].reshape(b, np_ * page, kh, d).transpose(1, 2)
            dv = vp[bt.long()].reshape(b, np_ * page, kh, d).transpose(1, 2)
            mask = (torch.arange(np_ * page, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                q[:, :, None], dk, dv, attn_mask=mask, enable_gqa=True), 20)
            es = q.element_size()
            n_rows = int(lens_np.clip(0, np_ * page).sum())
            nbytes = (2 * n_rows * kh * d * es + 2 * b * h * d * es
                      + 4 * int(np.ceil(lens_np / page).sum()) + 4 * b)
            flops = 4 * n_rows * h * d
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FLOPS[str(dtype).removeprefix("torch.")] * 1e3
            row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", call_ms=call,
                       plain_call_ms=plain_call, library_call_ms=lib_call)
            if label == ATTN_META["paged_attention"]["main"] \
                    and dtype == torch.bfloat16:
                out["paged_attention"].update(row)
            say(f"  paged_attention {label} B{b} H{h} KH{kh} D{d} page "
                f"{page} x {np_} (splits {pa.split_plan(np_ * page)}), "
                f"{n_rows} rows, {dtype}: max |diff| {err:.3g};"
                f" device: kernel {ms:.5f} ms, plain {plain:.5f} ms, SDPA "
                f"(dense, masked) {lib:.5f} ms; per call: {call:.5f} / "
                f"{plain_call:.5f} / {lib_call:.5f} ms; bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']}, "
                f"{nbytes / 1e9:.4f} GB) [{card}]")
            del q, kp, vp, dk, dv

    # flash: the prefill shape (B 2, S 4096, H 16, KH 8, D 128, causal), a
    # ragged S, no mask, and a 1024-token sliding window
    for label, s, causal, window in (("prefill", 4096, True, 0),
                                     ("ragged", 1000, True, 0),
                                     ("non_causal", 4096, False, 0),
                                     ("window", 4096, True, 1024)):
        b, h, kh, d = 2, 16, 8, 128
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn((b, h, s, d), dtype, dev, 4)
            k = _randn((b, kh, s, d), dtype, dev, 5)
            v = _randn((b, kh, s, d), dtype, dev, 6)
            kw = dict(causal=causal, window=window)
            err = compare("flash_attention",
                          fa.flash_attention_cuda(q, k, v, **kw),
                          fa.flash_attention_ref(q, k, v, **kw), dtype,
                          f"{label} {dtype}")
            ms, call = timed(lambda: fa.flash_attention_cuda(q, k, v, **kw), 5)
            plain, plain_call = timed(
                lambda: fa.flash_attention_ref(q, k, v, **kw), 3)
            lib = lib_call = None       # SDPA has no sliding window
            if not window:
                lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), 5)
            es = q.element_size()
            nbytes = 2 * (b * h * s * d + b * kh * s * d) * es
            flops = 4 * b * h * d * flash_pairs(s, causal, window)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FLOPS[str(dtype).removeprefix("torch.")] * 1e3
            row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", call_ms=call,
                       plain_call_ms=plain_call, library_call_ms=lib_call)
            if label == ATTN_META["flash_attention"]["main"] \
                    and dtype == torch.bfloat16:
                out["flash_attention"].update(row)
            say(f"  flash_attention {label} B{b} S{s} H{h} KH{kh} D{d} "
                f"causal={causal} window={window}, {dtype}: max |diff| "
                f"{err:.3g}; device: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f}"
                f" TFLOP/s), plain {plain:.4f} ms, SDPA {lib} ms; per call: "
                f"{call:.4f} / {plain_call:.4f} / {lib_call} ms; bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                f"{flops / 1e9:.2f} GFLOP) [{card}]")
            del q, k, v
    torch.cuda.empty_cache()
    return out


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


def _logits_close(got, want, what: str):
    """Card logits against CPU (or prefill against decode) logits: within
    MODEL_RTOL / MODEL_ATOL, argmax agreeing on at least 90 % of rows."""
    import torch
    g, w = got.float().cpu(), want.float().cpu()
    check(g.shape == w.shape, f"{what}: shapes {g.shape} vs {w.shape}")
    check(bool(torch.isfinite(g).all()), f"{what}: not finite")
    err = float((g - w).abs().max())
    bad = int(((g - w).abs() > MODEL_ATOL + MODEL_RTOL * w.abs()).sum())
    agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    check(bad == 0, f"{what}: {bad} logits beyond rtol {MODEL_RTOL} / atol "
                    f"{MODEL_ATOL} (max |diff| {err})")
    check(agree >= 0.9, f"{what}: argmax agreement {agree}")
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

    # the card against the same weights on the CPU: prefill of 64 tokens,
    # then 16 decode steps from its caches, fed the same tokens
    cpu = Model(cfg, device="cpu")
    params_cpu = _tree_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 80), generator=g, device=dev)
    results = {}
    t0 = time.perf_counter()
    for name, m, p, tk in (("card", model, params, toks),
                           ("cpu", cpu, params_cpu, toks.cpu())):
        last, (ck, cv) = m.prefill(p, tk[:, :64])
        st = m.init_decode_state(2, 80)
        st["k"][:, :, :64] = ck
        st["v"][:, :, :64] = cv
        steps = []
        for t in range(64, 80):
            lg, st = m.decode_step(p, st, tk[:, t:t + 1], t)
            steps.append(lg[:, 0].cpu())
        results[name] = (last.cpu(), torch.stack(steps, 1))
    err_p, agree_p = _logits_close(results["card"][0], results["cpu"][0],
                                   "prefill(64) card vs CPU")
    err_d, agree_d = _logits_close(results["card"][1], results["cpu"][1],
                                   "16 decode steps card vs CPU")
    say(f"  card vs CPU (same weights; prefill 64 tokens + 16 decode steps, "
        f"B 2): max |diff| {err_p:.4f} / {err_d:.4f}, argmax agreement "
        f"{agree_p:.3f} / {agree_d:.3f} (rtol {MODEL_RTOL}, atol "
        f"{MODEL_ATOL}); {time.perf_counter() - t0:.1f} s")
    del params_cpu, cpu

    # prefill logits against token-by-token decode logits, on the card
    full, _, _ = tfm.forward(cfg, params, toks[:, :64])
    st = model.init_decode_state(2, 64)
    dec = []
    for t in range(64):
        lg, st = model.decode_step(params, st, toks[:, t:t + 1], t)
        dec.append(lg[:, 0])
    err, agree = _logits_close(torch.stack(dec, 1), full,
                               "decode vs prefill on the card")
    say(f"  decode vs prefill logits on the card (64 tokens, B 2): max "
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


def weak_scaling_rows(dev, c: dict, modes=MODES, profile=None):
    """``benchmarks/scale.py::_weak_scaling`` on local meshes of ``dev``:
    mesh -> mode -> record, and the efficiency table.  The 1-way mesh's
    per-shard bill must sum to the single-device run's, window by window.
    ``profile(label, fn)``, where given, is called once with a rerun of
    the largest mesh's CIDER cell."""
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
            if profile and n == c["meshes"][-1] and mode == "CIDER":
                profile(f"weak scaling CIDER run_windows_sharded ({n} shards,"
                        f" {n_slots} slots, {c['windows']} windows)", run)
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
                       modes=("CIDER", "MCS"), timer=None,
                       profile=None) -> dict:
    """YCSB A and E over ``n_keys`` populated keys on an ``n_shards``-way
    local mesh (phase 4's streams and store size): raises unless, per
    workload and mode, the sharded run's results, bill, credit table and
    store view equal the single-device run's on the same stream, and every
    op's result and every touched key's final value equal the oracle's.
    ``timer(label, fn)`` runs and times ``fn``; ``profile(label, fn)``,
    where given, is called once with a rerun of the A sharded run of the
    first mode.  Returns per-cell summaries."""
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
            if profile and wl == "A" and name == modes[0]:
                profile(f"deployment A {name} run_windows_sharded "
                        f"({n_shards} shards, {n_slots} slots, {windows} "
                        f"windows)", run)
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
        lambda: weak_scaling_rows(dev, SCALE_FULL, profile=clock.profile))
    for m, by_mode in scale["weak_scaling"].items():
        for mode, want in by_mode.items():
            _check_rows(weak[m][mode], want, f"weak_scaling/{m}/{mode}")
    _check_rows(eff, scale["efficiency"], "efficiency")
    say("  weak_scaling (per-shard bills, hottest-shard ticks, p99) and "
        "efficiency == BENCH_scale.json; efficiency at 16 shards: "
        + ", ".join(f"{m} {eff[m]['16']}" for m in MODES)
        + "; mesh 1's per-shard bill == the single device's")
    out = sharded_deployment(dev, n_keys, windows, batch, n_cns, credit_table,
                             n, timer=clock.run, profile=clock.profile)
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
# 2^14 key slots, 32,768 ticks); benchmarks/run.py's BASE (Figs 11-12) in
# all four modes at 48 and 512 clients; BASE CIDER at 512 clients with
# wc_off, with cas_off (Fig 20) and with 3 MN replicas; and the two crash
# configurations of tests/test_substrates.py (MCS, one key, 16 clients).
# tests/test_torch_sim_pins.py proves that the JAX reference gives SIM_PINS.

SIM_BASE = dict(n_lanes=512, ticks=8192, max_ops=1024)
SIM_CRASH = dict(n_lanes=64, ticks=6144, max_ops=512, fail_tick=600,
                 max_wait=512, lanes_per_cn=1, local_wc=False)
SIM_WI = ("write-intensive", 1_000_000)
# name -> (SimParams overrides, mode, (workload, keys), clients)
SIM_RUNS = {
    "default_CIDER_512": ({}, "CIDER", SIM_WI, 512),
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
        mode='CIDER', n_clients=512, ticks=32768, ops_done=402530,
        throughput_mops=12.28424072265625, p50_us=36.0, p99_us=148.0,
        retries=24839, mn_iops_used=1048954, cn_msgs=33659,
        wc_rate=0.12364560884289559, wc_rate_local=0.0,
        wc_rate_global=0.12364560884289559, avg_batch=8.305865102639297,
        pess_ratio=0.15546573179330825, ideal_pess_ratio=0.02432690111330705,
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
SIM_EAGER_TICKS = 256      # ticks run eagerly and graphed from one state


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
    """Every SIM_RUNS run through ``run_sim`` (CUDA graphs), each result
    equal to its pin; returns the replays' extra launches by kernel."""
    import torch
    from repro_torch.core import sim
    from repro_torch.core.types import SyncMode
    extra: dict = {}
    for name, (over, mode, workload, clients) in SIM_RUNS.items():
        p, st = sim_streams(dev, over, workload, streams)
        record = []
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = sim.run_sim(p, SyncMode[mode], st, clients, record=record)
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
    n_hgmma = hgmma_count(build.library_path("flash_attention"))
    say(f"  cuobjdump -sass: {n_hgmma} HGMMA instructions in "
        f"{build.library_path('flash_attention').name}")
    check(n_hgmma > 0, "flash_attention's SASS holds no HGMMA: its bf16 "
                       "path does not run on the tensor cores")
    counters = {"wc_combine": wcc.counter, "scan_probe": sp.counter,
                "paged_attention": pa.counter, "flash_attention": fa.counter}

    def phase(n: int, what: str) -> None:
        say(f"== phase {n}: {what} [{card}] "
            f"(t = {time.perf_counter() - t_start:.1f} s)")

    phase(1, "kernels vs plain versions on the card")
    stats = phase1_kernels(dev, card)
    phase1_helpers(dev)
    say(f"  (t = {time.perf_counter() - t_start:.1f} s)")
    att = phase1_attention(dev, card)

    for c in counters.values():
        c.reset()              # the main paths' runs start here
    per_phase = {}

    def mark(phase):
        per_phase[phase] = {n: c.count for n, c in counters.items()}

    phase(2, "engine_json configuration")
    phase2_engine_json(dev, card)
    mark(2)
    phase(3, "YCSB A-F at the ycsb_json size")
    phase3_ycsb(dev, card)
    mark(3)
    phase(4, "deployment scale, YCSB A and E")
    phase4_deployment(dev, card, n_keys=1 << 24, windows=64, batch=4096,
                      n_cns=64, credit_table=4096)
    mark(4)
    phase(5, "qwen3-0.6b prefill and decode at full width")
    phase5_model(dev, card)
    mark(5)
    phase(6, "serve qwen3-0.6b at full width")
    phase6_serve(dev, card)
    mark(6)
    phase(7, "crash recovery, BENCH_recovery.json")
    phase7_recovery(dev, card)
    mark(7)
    phase(8, "MN replication, BENCH_replication.json")
    phase8_replication(dev, card)
    mark(8)
    phase(9, "dynamic scenarios, BENCH_scenarios.json")
    phase9_scenarios(dev, card)
    mark(9)
    phase(10, "open-loop arrivals at BENCH_scale.json's open-loop size")
    phase10_open_loop(dev, card)
    mark(10)
    phase(11, "deployment scale: crash recovery with MN replication, "
              "RaceHash")
    phase11_deployment(dev, card, n_keys=1 << 24, windows=64, batch=4096,
                       n_cns=64, credit_table=4096)
    mark(11)
    phase(12, "the sharded store: BENCH_*.json sharded rows, weak scaling, "
              "2^24 keys over 4 shards")
    phase12_sharded(dev, card, n_keys=1 << 24, windows=64, batch=4096,
                    n_cns=64, credit_table=4096)
    mark(12)
    phase(13, "the protocol simulator: pinned runs through CUDA graphs, "
              "graph vs eager, replay, race_check conformance")
    replayed = phase13_sim(dev, card)
    mark(13)
    # a graph's kernels were counted once, at capture: add their replays
    for (name, n_lanes), n in replayed.items():
        per_phase[13][name] += n
        by_size = counters[name].by_size
        by_size[n_lanes] = by_size.get(n_lanes, 0) + n
    say(f"  phase 13 launches beyond the captures: {replayed}")
    launches = dict(per_phase[13])
    say(f"  main-path launches: {launches}; cumulative after each phase: "
        f"{per_phase}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for name in KERNEL_META:
        by_n = dict(sorted(counters[name].by_size.items()))
        say(f"  {name} main-path launches by N: {by_n}")
    before = {2: {n: 0 for n in counters}}
    before.update({k: per_phase[k - 1] for k in range(3, 14)})
    for phase, names in ((2, ("wc_combine",)), (3, ("wc_combine",
                                                    "scan_probe")),
                         (4, ("wc_combine", "scan_probe")),
                         (5, ("paged_attention", "flash_attention")),
                         (6, ("wc_combine", "paged_attention")),
                         (7, ("wc_combine",)), (8, ("wc_combine",)),
                         (9, ("wc_combine",)), (10, ("wc_combine",)),
                         (11, ("wc_combine",)),
                         (12, ("wc_combine", "scan_probe")),
                         (13, ("wc_combine",))):
        for name in names:
            check(per_phase[phase][name] > before[phase][name],
                  f"{name} was not launched in phase {phase}")

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
    for name, meta in ATTN_META.items():
        t = att[name]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "call_ms": t["call_ms"],
                     "plain_call_ms": t["plain_call_ms"],
                     "library_call_ms": t["library_call_ms"]})
    say(f"  all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
