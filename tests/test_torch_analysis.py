"""The port's analysis passes (``repro_torch.analysis``): each is clean on
the real tree and fails on an injected fault.  ``race_check`` gives the
reference's scenario and state counts, and its tick-level conformance runs
the port's simulator; ``bill_lint`` reads the port's engine, stores and
runner; ``device_check`` audits the window loop and the tick."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import race_check as j_race_check  # noqa: E402
from repro_torch.analysis import (ANALYSIS_VERSION, PASSES,  # noqa: E402
                                  Violation, analysis_provenance)
from repro_torch.analysis import bill_lint, device_check, race_check  # noqa: E402
from repro_torch.analysis.race_check import (  # noqa: E402
    ModelFlags, Scenario, explore)
from repro_torch.core.types import OpKind, SyncMode  # noqa: E402

from test_analysis import METRICS_OK, RUNNER_OK, TYPES_OK  # noqa: E402


def test_provenance_names_the_passes():
    p = analysis_provenance()
    assert p == {"version": ANALYSIS_VERSION, "passes": list(PASSES)}
    assert PASSES == ("device_check", "bill_lint", "race_check")
    assert str(Violation("bill_lint", "x", "y")) == "[bill_lint] x: y"


# ---------------------------------------------------------------- race check

def test_race_check_clean_with_the_reference_counts():
    notes, ref_notes = [], []
    assert race_check.run(notes, device="cpu") == []
    assert j_race_check.run(ref_notes) == []
    assert notes[0] == ref_notes[0]          # scenarios and states
    assert notes[0].startswith("race_check: 1425 scenarios")
    assert "tick conformance comb_g=0/" in notes[1]


def test_race_check_sim_conformance_on_the_cpu():
    notes = []
    assert race_check._sim_conformance(notes, device="cpu") == []
    ref = []
    j_race_check._sim_conformance(ref)
    assert notes[0].split(" on ")[0] == ref[0]


@pytest.mark.parametrize("flags,mode,needle", [
    (ModelFlags(combine_covers_deletes=True), SyncMode.CIDER,
     "0 committed events"),
    (ModelFlags(repair_requires_dead_holder=False), SyncMode.SPIN,
     "mutual exclusion"),
    (ModelFlags(repair_requires_dead_holder=False), SyncMode.MCS,
     "wait-queue rank")])
def test_race_check_detects_seeded_bugs(flags, mode, needle):
    ops = ((OpKind.UPDATE, 0), (OpKind.DELETE, 0)) \
        if flags.combine_covers_deletes else ((OpKind.UPDATE, 0),) * 2
    sc = Scenario(mode, ops, (0,), hot=(True, True), flags=flags)
    viols, _ = explore(sc)
    assert any(needle in v.message for v in viols), [str(v) for v in viols]


# ---------------------------------------------------------------- bill lint

def test_bill_lint_clean_on_the_port():
    notes = []
    assert bill_lint.run(notes) == []
    assert notes[0].startswith("bill_lint: 6 writer files, 11 IOMetrics")


def test_bill_lint_reads_the_port():
    derived = bill_lint.derived_field_map(
        open("src/repro_torch/core/types.py").read())
    assert derived["mn_iops"] == {"reads", "writes", "cas", "faa"}
    assert bill_lint.consumed_fields(
        open("src/repro_torch/core/runner.py").read(), derived=derived) \
        >= {"reads", "writes", "cas", "faa", "mn_bytes"}


@pytest.mark.parametrize("case", ["undocumented", "unconsumed", "stale",
                                  "bare_notimplemented"])
def test_bill_lint_fails_on_injected_fixtures(case):
    md = METRICS_OK
    writers, stores, wl = {}, {}, {}
    if case == "undocumented":
        writers = {"src/repro_torch/core/engine.py":
                   "io = IOMetrics(reads=r, cas=c)"}
        needle = "no row"
    elif case == "unconsumed":
        md = METRICS_OK.replace(
            "| `faa` | verbs | credit FAAs |",
            "| `faa` | verbs | credit FAAs |\n| `retries` | count | waste |")
        writers = {"src/repro_torch/core/engine.py":
                   "io = IOMetrics(reads=r, retries=w)"}
        needle = "never consumed"
    elif case == "stale":
        wl = {"not_a_field": "stale"}
        needle = "stale whitelist"
    else:
        stores = {"src/repro_torch/stores/toy.py":
                  "def apply(self):\n    raise NotImplementedError('x')\n"}
        wl = None
        needle = "UnsupportedOpError"
    out = bill_lint.lint_sources(writers, metrics_md=md,
                                 runner_source=RUNNER_OK,
                                 types_source=TYPES_OK, store_sources=stores,
                                 whitelist=wl)
    assert any(needle in v.message for v in out), [str(v) for v in out]


# ---------------------------------------------------------------- device check

def test_device_check_clean_on_window_loop_and_tick():
    notes = []
    assert device_check.run(notes, device="cpu") == []
    assert notes[0].startswith("device_check: 8 paths on cpu")


def test_device_check_flags_an_injected_float64_op():
    x = torch.arange(8, dtype=torch.int32)
    _, c = device_check.census(lambda: (x.to(torch.float64) * 2).sum())
    out = device_check.check(c, "toy")
    assert any("float64" in v.message and "aten._to_copy" in v.message
               for v in out), [str(v) for v in out]


def test_device_check_flags_an_injected_item_and_mask_index():
    x = torch.arange(8, dtype=torch.int32)
    _, c = device_check.census(lambda: int(x.sum().item()) + x[x > 3].sum())
    msgs = [v.message for v in device_check.check(c, "toy")]
    assert any("_local_scalar_dense" in m for m in msgs), msgs
    assert any("boolean-mask index" in m for m in msgs), msgs


def test_device_check_flags_a_masked_fill_with_a_tensor_value():
    """``masked_fill`` with a 0-dim tensor value reads it on the host (a
    CUDA graph capture fails on it); with a Python number it does not."""
    x = torch.zeros(8, dtype=torch.int32)
    t = torch.tensor(3, dtype=torch.int32)
    _, c = device_check.census(lambda: x.masked_fill(x == 0, t))
    assert any("aten.masked_fill.Tensor" in v.message
               for v in device_check.check(c, "toy"))
    _, c = device_check.census(lambda: x.masked_fill(x == 0, 3))
    assert device_check.check(c, "toy") == []


def test_device_check_flags_a_dtype_outside_the_set():
    x = torch.arange(8, dtype=torch.int32)
    _, c = device_check.census(lambda: x.to(torch.float32) + 1)
    assert any("outside the documented set" in v.message
               for v in device_check.check(c, "toy"))
