"""Fold the dry-run's per-cell JSONs into the roofline table (port of
``repro.rooflines.report``, reading ``repro_torch.launch.dryrun``'s
records: the collective term is ``None`` there, shown as "n/c", not
counted).

    PYTHONPATH=src python -m repro_torch.rooflines.report results/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import sys

__all__ = ["load", "table", "main"]


def load(outdir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(f"{outdir}/*.json")):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _g(x) -> str:
    return "n/c" if x is None else f"{x:.3g}"


def table(recs, mesh: str = "16x16") -> str:
    rows = ["| arch | cell | status | compute s | memory s | coll s | "
            "bottleneck | MODEL_FLOPs | useful | roofline frac | "
            "bytes/chip (args) |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['cell']} | {r['status']}: "
                        f"{r.get('reason', r.get('error', ''))[:60]} "
                        f"| | | | | | | | |")
            continue
        t = r["roofline"]
        mem = r.get("bytes_per_chip", {})
        gb = (mem.get("argument_size_in_bytes", 0)
              + mem.get("temp_size_in_bytes", 0)) / 1e9
        rows.append(
            f"| {r['arch']} | {r['cell']} | ok | {t['compute_s']:.3g} | "
            f"{t['memory_s']:.3g} | {_g(t['collective_s'])} | "
            f"{t['bottleneck']} | {t['model_flops']:.3g} | "
            f"{t['useful_ratio']:.3f} | {t['roofline_fraction']:.4f} | "
            f"{gb:.1f} GB |")
    return "\n".join(rows)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else "results/dryrun_torch"
    recs = load(outdir)
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "16x16"]
    print("### Single-pod (16x16 = 256 chips)\n")
    print(table(recs, "16x16"))
    print("\n### Multi-pod (2x16x16 = 512 chips)\n")
    print(table(recs, "2x16x16"))
    if ok:
        worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
        print("\nworst roofline fraction:", worst["arch"], worst["cell"],
              worst["roofline"]["roofline_fraction"])


if __name__ == "__main__":
    main()
