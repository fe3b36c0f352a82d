#!/usr/bin/env python3
"""Time the attention kernels' rows of the kernel table on one card, for
one or more trees in turns.

    python3 tools/attention_designs.py                  # this tree
    python3 tools/attention_designs.py --trees build/parent . . build/parent

Each tree runs in a process of its own (its own ``src/repro_torch`` and
build directory), in the order given, so that two versions are compared on
one card in one call (parent, change, change, parent).  Every time is the
profiler's device time per call (``chip_smoke.timed``), in bf16, after the
call's output is held to the plain version within two bf16 ulps
(decode_32k within ``chip_smoke.ATT_TOL``'s 2e-2).  Rows:
``flash_attention`` at recurrentgemma-9b's prefill (B 1, S 4096, H 16, KH
1, D 256, causal, window 2048) and at the D 80/96/128 rows of the kernel
table, and at kimi-k2-1t-a32b's prefill (B 1, S 2048, H 64, KH 8, D
112, causal) beside the same shape at D 128 (what D 112's tiles, two
whole boxes with 16 zero columns, are weighed against);
``paged_attention`` at the 40-row serve slots (length 40) of
qwen3-0.6b (H 16, KH 8, D 128), deepseek-moe-16b (16, 16, 128),
phi-3-vision-4.2b (32, 32, 96), recurrentgemma-9b (16, 1, 256) and
kimi-k2-1t-a32b (64, 8, 112; and the same heads at D 128), at
recurrentgemma-9b's 2,048-row ring (length 2,048) and at decode_32k (B 8,
16-row pages, lengths up to 32,768); ``flash_attention_bwd`` at the
training shapes of qwen3-0.6b (D 128), hubert-xlarge (D 80),
phi-3-vision-4.2b (D 96), recurrentgemma-9b (D 256) and kimi-k2-1t-a32b
(B 1, S 4096, H 64, KH 8, D 112; and at D 128), each held to the
plain backward within ``chip_smoke.BWD_TOL``, with a row for each of its
launches (``<row>.delta``, ``.dkdv``, ``.reduce`` where the dK/dV pass
is split over head groups, ``.dq``) where the profiler recorded them.  A
row whose head dim a tree's kernels do not take (D 112 before it was
added; a tree before the compiled instances took every D up to 256 lists
its head dims in ``HEAD_DIMS``) is left out of that tree's line.  Every call goes through
the public wrappers (``flash_attention_cuda``, ``paged_attention_cuda``,
``flash_attention_bwd_cuda``), so that a parent tree runs its own design.
Prints one JSON line a tree, then a table.
Needs one CUDA card; the time of every row is the card's (its name and
power limit are printed first).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (row, B, S, H, KH, D, causal, window)
FLASH_ROWS = (("flash_d256", 1, 4096, 16, 1, 256, True, 2048),
              ("flash_d128", 2, 4096, 16, 8, 128, True, 0),
              ("flash_d128_mha", 1, 2048, 16, 16, 128, True, 0),
              ("flash_d80", 2, 1024, 16, 16, 80, False, 0),
              ("flash_d96", 1, 640, 32, 32, 96, True, 0),
              ("flash_d112", 1, 2048, 64, 8, 112, True, 0),
              ("flash_d128_kimi", 1, 2048, 64, 8, 128, True, 0))
# the backward at each family's training shape (row, B, S, H, KH, D,
# causal, window)
BWD_ROWS = (("bwd_d128", 2, 4096, 16, 8, 128, True, 0),
            ("bwd_d80", 2, 1024, 16, 16, 80, False, 0),
            ("bwd_d96", 1, 640, 32, 32, 96, True, 0),
            ("bwd_d256", 1, 4096, 16, 1, 256, True, 2048),
            ("bwd_d112", 1, 4096, 64, 8, 112, True, 0),
            ("bwd_d128_kimi", 1, 4096, 64, 8, 128, True, 0))
# (row, H, KH, D, span): one page of `span` rows, B 1, length span
PAGED_ROWS = (("paged_d128", 16, 8, 128, 40),
              ("paged_d128_mha", 16, 16, 128, 40),
              ("paged_d96", 32, 32, 96, 40),
              ("paged_d256", 16, 1, 256, 40),
              ("paged_d256_ring", 16, 1, 256, 2048),
              ("paged_d112", 64, 8, 112, 40),
              ("paged_d128_kimi", 64, 8, 128, 40))


def takes(ops, d: int) -> bool:
    """Whether a tree's kernel module ``ops`` runs head dim ``d`` in
    bf16."""
    import torch
    if not hasattr(ops, "instance_of"):     # a tree with a table of dims
        return d in ops.HEAD_DIMS
    try:
        ops.instance_of(d, torch.bfloat16)
    except ValueError:
        return False
    return True


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    build.build(("flash_attention", "paged_attention",
                 "flash_attention_bwd"))
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    rows: dict[str, float] = {}

    def flash_row(name, b, s, h, kh, d, causal, window):
        q = cs._randn((b, h, s, d), bf16, dev, 7)
        k = cs._randn((b, kh, s, d), bf16, dev, 8)
        v = cs._randn((b, kh, s, d), bf16, dev, 9)
        kw = dict(causal=causal, window=window)
        want = fa.flash_attention_ref(q, k, v, **kw).float()
        got = fa.flash_attention_cuda(q, k, v, **kw).float()
        bad = int(((got - want).abs() > 1e-5 + cs.BF16_ULPS2 * want.abs())
                  .sum())
        cs.check(bad == 0, f"{tree} {name}: {bad} elements beyond two bf16 "
                           f"ulps")
        flops = 4 * b * h * d * cs.flash_pairs(s, causal, window)
        ms, _ = cs.timed(lambda: fa.flash_attention_cuda(q, k, v, **kw), 5,
                         floor=cs.floor_ms(0, flops))
        rows[name] = ms

    for row in FLASH_ROWS:
        if takes(fa, row[5]):
            flash_row(*row)

    def bwd_row(name, b, s, h, kh, d, causal, window):
        q, do = (cs._randn((b, h, s, d), bf16, dev, i) for i in (21, 24))
        k, v = (cs._randn((b, kh, s, d), bf16, dev, i) for i in (22, 23))
        kw = dict(causal=causal, window=window)
        _, lse, o = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        args = (q, k, v, o, do, lse)
        want = fa.flash_attention_bwd_ref(*args, **kw)
        got = fa.flash_attention_bwd_cuda(*args, **kw)
        rtol, atol = cs.BWD_TOL["bfloat16"]
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            scale = max(float(w.abs().max()), 1.0)
            bad = int(((g - w).abs() > atol * scale + rtol * w.abs()).sum())
            cs.check(bad == 0, f"{tree} {name}: {bad} elements beyond "
                               f"BWD_TOL")
        del got, want
        flops = 10 * b * h * d * cs.flash_pairs(s, causal, window)
        rows[name], _, top = cs.timed(
            lambda: fa.flash_attention_bwd_cuda(*args, **kw), 3,
            events=True, floor=cs.floor_ms(0, flops))
        for entry in ("delta", "dkdv", "reduce", "dq"):
            ms = sum(t for key, t, _ in top if f"flash_bwd_{entry}" in key)
            if ms:
                rows[f"{name}.{entry}"] = ms

    for row in BWD_ROWS:
        if takes(fa, row[5]):
            bwd_row(*row)

    ident = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    for name, h, kh, d, span in PAGED_ROWS:
        if not takes(pa, d):
            continue
        q = cs._randn((1, h, d), bf16, dev, 10)
        kp = cs._randn((1, span, kh, d), bf16, dev, 11)
        vp = cs._randn((1, span, kh, d), bf16, dev, 12)
        ln = torch.full((1,), span, dtype=torch.int32, device=dev)
        want = pa.paged_attention_ref(q, kp, vp, ident, ln).float()
        got = pa.paged_attention_cuda(q, kp, vp, ident, ln).float()
        bad = int(((got - want).abs() > 1e-5 + cs.BF16_ULPS2 * want.abs())
                  .sum())
        cs.check(bad == 0, f"{tree} {name}: {bad} elements beyond two bf16 "
                           f"ulps")
        rows[name], _ = cs.timed(
            lambda: pa.paged_attention_cuda(q, kp, vp, ident, ln), 20)
        del q, kp, vp

    # decode_32k: B 8, KH 8, H 16, D 128, 16-row pages, 2,048 a sequence
    import numpy as np
    rng = np.random.default_rng(32)
    b, page, np_ = 8, 16, 2048
    bt = torch.as_tensor(rng.permutation(b * np_ + 64)[:b * np_]
                         .reshape(b, np_).astype(np.int32), device=dev)
    lens_np = rng.integers(1, np_ * page + 1, b).astype(np.int32)
    lens_np[0] = np_ * page
    lens = torch.as_tensor(lens_np, device=dev)
    q = cs._randn((b, 16, 128), bf16, dev, 1)
    kp = cs._randn((b * np_ + 64, page, 8, 128), bf16, dev, 2)
    vp = cs._randn((b * np_ + 64, page, 8, 128), bf16, dev, 3)
    want = pa.paged_attention_ref(q, kp, vp, bt, lens).float()
    got = pa.paged_attention_cuda(q, kp, vp, bt, lens).float()
    cs.check(bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()),
             f"{tree} decode_32k: mismatch")
    n_rows = int(lens_np.sum())
    rows["paged_decode_32k"], _ = cs.timed(
        lambda: pa.paged_attention_cuda(q, kp, vp, bt, lens), 20,
        floor=cs.floor_ms(2 * n_rows * 8 * 128 * 2, 4 * n_rows * 16 * 128))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--child")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("attention_designs: needs a CUDA card")
    if args.child:
        rows = child(Path(args.child).resolve())
        print(json.dumps({"tree": args.child, "ms": rows}), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    results = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, __file__, "--child", tree],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"attention_designs: {tree} failed")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    names = sorted({k for r in results for k in r["ms"]})
    print("row | " + " | ".join(r["tree"] for r in results))
    for k in names:
        print(f"{k} | " + " | ".join(
            f"{r['ms'][k]:.5f}" if k in r["ms"] else "-" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
