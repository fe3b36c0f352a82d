"""CLI driver for the port's invariant auditor (``repro_torch.analysis``):
the counterpart of ``tools/analyze.py``.

Runs the three passes: ``device_check`` (an aten-op census of the engine's
window loop and one simulator tick in every mode, on ``--device``),
``bill_lint`` (verb-bill conservation) and ``race_check`` (exhaustive
protocol model checking, with its tick-level conformance scenario on
``--device``).  Prints every violation, writes a machine-readable report
with the reference's keys, and exits non-zero if anything failed.

Usage:
    python tools/analyze_torch.py [--pass device_check,bill_lint,race_check]
                                  [--report ANALYZE_REPORT.torch.json]
                                  [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis import ANALYSIS_VERSION, PASSES  # noqa: E402
from repro_torch.core.types import as_device  # noqa: E402

DEFAULT_REPORT = "ANALYZE_REPORT.torch.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pass", dest="passes", default=",".join(PASSES),
                    help="comma-separated subset of passes to run "
                         f"(default: {','.join(PASSES)})")
    ap.add_argument("--report", default=DEFAULT_REPORT,
                    help="machine-readable report path ('' to skip)")
    ap.add_argument("--full", action="store_true",
                    help="race_check: widen the 3-client scenario space "
                         "beyond the CI-calibrated quick set")
    ap.add_argument("--device", default="cuda",
                    help="device of device_check and race_check's tick "
                         "conformance (default cuda; raises without one)")
    args = ap.parse_args(argv)

    selected = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = sorted(set(selected) - set(PASSES))
    if unknown:
        ap.error(f"unknown pass(es) {unknown}; choose from {list(PASSES)}")
    dev = as_device(args.device)

    report: dict = {"version": ANALYSIS_VERSION, "passes": {}}
    total = 0
    for name in selected:
        mod = __import__(f"repro_torch.analysis.{name}", fromlist=["run"])
        notes: list[str] = []
        t0 = time.time()
        if name == "race_check":
            viols = mod.run(notes, quick=not args.full, device=dev)
        elif name == "device_check":
            viols = mod.run(notes, device=dev)
        else:
            viols = mod.run(notes)
        dt = time.time() - t0
        total += len(viols)
        report["passes"][name] = {
            "violations": [{"target": v.target, "message": v.message}
                           for v in viols],
            "notes": notes,
            "seconds": round(dt, 2),
        }
        status = "OK" if not viols else f"{len(viols)} VIOLATION(S)"
        print(f"[analyze] {name}: {status} ({dt:.1f}s)")
        for n in notes:
            print(f"  note: {n}")
        for v in viols:
            print(f"  {v}")
    report["ok"] = total == 0

    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2) + "\n")
        print(f"[analyze] report -> {args.report}")
    if total:
        print(f"[analyze] FAILED: {total} violation(s)")
        return 1
    print("[analyze] all passes clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
