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
   sweeps bit for bit over N in ``SWEEP_SIZES`` (1, 2, every tile edge of
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

The launch counters are zeroed just before phase 2 and read after phase 6;
every kernel must have launched in that run, in the phases that run it.  The last lines are the kernel
table as JSON, the card's name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
# path's sizes and 2^20
SWEEP_SIZES = (1, 2, 511, 512, 513, 514, 1000, 1023, 1024, 1025, 2047, 2048,
               2049, 4095, 4096, 4097, 4098, 8192, 9692, 34816, 69632,
               1 << 20)
SWEEP_TIMED = (1, 4096, 34816, 69632, 1 << 20)
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
    """Run ``fn`` ``iters`` times under ``torch.profiler`` (CPU + CUDA).
    Returns ``(device_ms_per_call, wall_ms_per_call, top)``: the summed
    self device time of every GPU event, the host wall time around the
    calls, and the five events with the most device time.  The device time
    is None when the profiler recorded no GPU events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def phase3_ycsb(dev, card: str) -> None:
    import numpy as np
    import torch
    from repro_torch.core import engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import EngineConfig, OpKind, SyncMode
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.workloads.ycsb import YCSB, generate_ycsb_stream

    ref = json.loads((ROOT / "BENCH_ycsb.json").read_text())
    c = ref["config"]
    p = SimParams()
    pk = np.arange(c["n_keys"])
    for wl, spec in YCSB.items():
        ops = generate_ycsb_stream(spec, c["windows"], c["batch"], c["n_keys"],
                                   c["n_clients"], seed=c["seed"])
        stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                    n_cns=c["n_cns"], device=dev)
        counts = np.where(ops.kinds == OpKind.SCAN, ops.values, 0)
        n_ops = int((ops.kinds != OpKind.NOP).sum())
        upd = ops.kinds == OpKind.UPDATE
        scan_max = c["scan_max"] if spec.scan > 0 else 0
        t0 = time.perf_counter()
        for name in MODES:
            cfg = EngineConfig(n_slots=c["n_slots"], heap_slots=c["heap_slots"],
                               mode=SyncMode[name], scan_max=scan_max)
            st = engine.populate(cfg, engine.store_init(cfg, dev), pk, pk)
            before = sp.counter.count
            _, _, res, io = runner.run_windows(cfg, st,
                                               credit_init(c["credit_table"],
                                                           dev), stream)
            launched = sp.counter.count - before
            check(launched == (c["windows"] if scan_max else 0),
                  f"ycsb/{wl}/{name}: scan_probe launched {launched} times")
            row = modeled_row(runner, cfg, p, ops.kinds, res, io, n_ops,
                              scan_counts=counts)
            row["rows"] = int(res.rows.sum().item())
            pess = res.pessimistic.cpu().numpy()
            row["pess_ratio"] = round(float((pess & upd).sum()
                                            / max(int(upd.sum()), 1)), 4)
            for k, v in ref["workloads"][wl]["single"][name].items():
                check(row.get(k) == v, f"ycsb/{wl}/{name}: {k} = {row.get(k)},"
                                       f" BENCH_ycsb.json has {v}")
        torch.cuda.synchronize()
        say(f"  {wl}: 4 modes == BENCH_ycsb.json single rows "
            f"({time.perf_counter() - t0:.3f} s for 4 x {c['windows']} "
            f"windows) [{card}]")


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


def phase4_deployment(dev, card: str, n_keys: int, windows: int, batch: int,
                      n_cns: int, credit_table: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import combine, engine, runner
    from repro_torch.core.credits import credit_init
    from repro_torch.core.oracle import OracleStore
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.kernels.wc_combine import ops as wcc
    from repro_torch.core.types import EngineConfig, OpKind, SyncMode
    from repro_torch.workloads.ycsb import YCSB, generate_ycsb_stream

    counters = {"wc_combine": wcc.counter, "scan_probe": sp.counter}
    n_slots = n_keys + windows * batch          # room for E's inserts
    heap_slots = n_slots + windows * batch
    out = {}
    for wl in ("A", "E"):
        spec = YCSB[wl]
        scan_max = spec.scan_max if spec.scan > 0 else 0
        ops = generate_ycsb_stream(spec, windows, batch, n_keys, n_cns,
                                   seed=11)
        keys = touched_keys(ops, spec.scan_max)
        oracle = OracleStore()
        pop = keys[keys < n_keys]
        oracle.populate(pop, pop)
        want = [oracle.apply(ops.kinds[w], ops.keys[w], ops.values[w],
                             scan_max=scan_max) + (oracle.rows.copy(),)
                for w in range(windows)]
        want_ok = np.stack([x[0] for x in want])
        want_val = np.stack([x[1] for x in want])
        want_rows = np.stack([x[2] for x in want])
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
            st = st1
            check(np.array_equal(res.ok.cpu().numpy(), want_ok),
                  f"deploy/{wl}/{name}: ok differs from the oracle")
            check(np.array_equal(res.value.cpu().numpy(), want_val),
                  f"deploy/{wl}/{name}: value differs from the oracle")
            check(np.array_equal(res.rows.cpu().numpy(), want_rows),
                  f"deploy/{wl}/{name}: rows differ from the oracle")
            exists, val = engine.store_view(st)
            kt = torch.as_tensor(keys[keys < n_slots], device=dev).long()
            e_np, v_np = exists[kt].cpu().numpy(), val[kt].cpu().numpy()
            kv = oracle.kv
            want_e = np.array([int(k) in kv for k in kt.cpu().numpy()])
            want_v = np.array([kv.get(int(k), -1) for k in kt.cpu().numpy()])
            check(np.array_equal(e_np, want_e) and np.array_equal(v_np, want_v),
                  f"deploy/{wl}/{name}: final store differs from the oracle")
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
    launches = {name: c.count for name, c in counters.items()}
    say(f"  main-path launches: {launches}; cumulative after each phase: "
        f"{per_phase}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for name in KERNEL_META:
        by_n = dict(sorted(counters[name].by_size.items()))
        say(f"  {name} main-path launches by N: {by_n}")
    before = {2: {n: 0 for n in counters}, 3: per_phase[2], 4: per_phase[3],
              5: per_phase[4], 6: per_phase[5]}
    for phase, names in ((2, ("wc_combine",)), (3, ("wc_combine",
                                                    "scan_probe")),
                         (4, ("wc_combine", "scan_probe")),
                         (5, ("paged_attention", "flash_attention")),
                         (6, ("wc_combine", "paged_attention"))):
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
