#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the CIDER engine on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, from the repo root

Phases (any mismatch raises, and the script exits non-zero):

0. device and build — the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds every kernel of ``src/repro_torch/kernels/csrc``.
1. each kernel against its plain PyTorch version on the card, bit for bit,
   over N in {1, 1000, 4096, 34816, 69632, 2^20} and four key layouts, with
   kernel, plain and bound times; the integer helpers on the card
   (``_backoff_polls``, ``credit_slot``) against their plain forms.
2. the ``engine_json`` configuration (65,536 slots, batch 4096, 16 windows,
   write-intensive Zipf 0.99, 16 CNs) in all four SyncModes: every verb
   counter and the modeled Mops/s and latency percentiles must equal the
   committed ``BENCH_engine.json``.
3. YCSB A-F at the ``ycsb_json`` size x 4 modes: every field of the
   committed ``BENCH_ycsb.json`` ``single`` rows must be reproduced.
4. deployment scale: YCSB A and E over 2^24 populated keys, 64 CNs, batch
   4096, 64 windows, CIDER and MCS; every op's result and the final value of
   every touched key must equal the sequential oracle.

The launch counters are zeroed just before phase 2 and read after phase 4;
every kernel must have launched in that run.  The last lines are the kernel
table as JSON, the card's name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 16.7e12      # 132 SMs x 64 int32 lanes x 1.98 GHz
MODES = ("OSYNC", "SPIN", "MCS", "CIDER")
KERNEL_META = {
    "wc_combine": dict(source="src/repro_torch/kernels/csrc/wc_combine.cu",
                       replaces="src/repro/kernels/wc_combine/wc_combine.py:57",
                       bytes_per_elem=10, ops_per_elem=5, main_n=4096),
    "scan_probe": dict(source="src/repro_torch/kernels/csrc/scan_probe.cu",
                       replaces="src/repro/kernels/scan_probe/scan_probe.py:74",
                       bytes_per_elem=15, ops_per_elem=8, main_n=69632),
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


def phase1_kernels(dev, sizes) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.kernels.wc_combine import ops as wcc

    rng = np.random.default_rng(2024)
    stats = {name: {"max_abs_err": 0, "times": {}} for name in KERNEL_META}
    for n in sizes:
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
                if layout == "dup_heavy":
                    call_k = cuda_ms(lambda: kern(*args))
                    call_p = cuda_ms(lambda: plain(*args))
                    dev_k = profile_device(lambda: kern(*args))[0]
                    dev_p = profile_device(lambda: plain(*args))[0]
                    meta = KERNEL_META[name]
                    bytes_ms = meta["bytes_per_elem"] * n / HBM_BYTES_PER_S * 1e3
                    ops_ms = meta["ops_per_elem"] * n / INT32_OPS_PER_S * 1e3
                    # device time from the profiler; the CUDA-event time of
                    # back-to-back calls where it recorded no GPU events
                    t = dict(ms=call_k if dev_k is None else dev_k,
                             plain_ms=call_p if dev_p is None else dev_p,
                             call_ms=call_k,
                             plain_call_ms=call_p,
                             bound_ms=max(bytes_ms, ops_ms),
                             bound_by="bytes" if bytes_ms >= ops_ms
                             else "operations")
                    stats[name]["times"][n] = t
                    say(f"  {name:10s} N={n:8d} device: kernel {dev_k} ms, "
                        f"plain {dev_p} ms; per call (host-bound): kernel "
                        f"{call_k:.5f} ms, plain {call_p:.5f} ms; bound "
                        f"{t['bound_ms']:.6f} ms ({t['bound_by']}); library: "
                        f"none (no single PyTorch call computes it)")
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
    from repro_torch.kernels.scan_probe import ops as sp
    from repro_torch.kernels.wc_combine import ops as wcc
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")
    counters = {"wc_combine": wcc.counter, "scan_probe": sp.counter}

    say(f"== phase 1: kernels vs plain versions on the card [{card}]")
    stats = phase1_kernels(dev, (1, 1000, 4096, 34816, 69632, 1 << 20))
    phase1_helpers(dev)

    for c in counters.values():
        c.count = 0            # the main path's run starts here
    say(f"== phase 2: engine_json configuration [{card}]")
    phase2_engine_json(dev, card)
    say(f"== phase 3: YCSB A-F at the ycsb_json size [{card}]")
    phase3_ycsb(dev, card)
    say(f"== phase 4: deployment scale, YCSB A and E [{card}]")
    phase4_deployment(dev, card, n_keys=1 << 24, windows=64, batch=4096,
                      n_cns=64, credit_table=4096)
    launches = {name: c.count for name, c in counters.items()}
    say(f"  main-path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    rows = []
    for name, meta in KERNEL_META.items():
        t = stats[name]["times"][meta["main_n"]]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": stats[name]["max_abs_err"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": None, "call_ms": t["call_ms"],
                     "plain_call_ms": t["plain_call_ms"]})
    say(json.dumps({"kernels": rows}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
