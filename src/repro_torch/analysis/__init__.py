"""Static-analysis layer of the port (port of ``repro.analysis``): prove the
port's invariants instead of sampling them.

Three passes:

* ``device_check`` — the port's stand-in for the reference's
  ``jaxpr_check``: a ``TorchDispatchMode`` census of every aten op that the
  engine's window loop (``runner.run_windows``, four modes, SCAN on) and
  one simulator ``tick`` per mode run, failing on a float64 op, on any
  dtype outside the port's documented set, and on any op that makes the
  host wait for the device (``.item()``, ``nonzero``, boolean-mask
  indexing).  The reference's donation and collective censuses have no
  counterpart: PyTorch donates nothing, and the mesh's sums are counted by
  ``tests/test_torch_mesh.py``.
* ``bill_lint`` — AST conservation lint: every ``IOMetrics`` field the
  port's engine and stores write is documented in docs/METRICS.md and
  consumed by the port's cost model (or whitelisted with a reason), and
  unsupported-op rejections raise the shared ``UnsupportedOpError``.
* ``race_check`` — the explicit-state model checker of the per-mode
  protocol machines, with its tick-level conformance scenario run on the
  port's simulator.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ANALYSIS_VERSION", "PASSES", "Violation", "analysis_provenance"]

# bump when a pass's invariants change meaningfully
ANALYSIS_VERSION = "1.0"

PASSES = ("device_check", "bill_lint", "race_check")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One analyzer finding.  ``passes == not violations`` everywhere."""
    pass_name: str   # which pass found it (one of PASSES)
    target: str      # what was audited (function, file, scenario)
    message: str     # what is wrong, in one sentence

    def __str__(self) -> str:
        return f"[{self.pass_name}] {self.target}: {self.message}"


def analysis_provenance() -> dict:
    """The pass list and version."""
    return {"version": ANALYSIS_VERSION, "passes": list(PASSES)}
