"""The port's dynamic-contention slice against the JAX reference (CPU): the
four scenario generators give identical arrays, ``run_windows_traced`` on
``hotspot_shift`` gives bit-equal results, bills, state, credits and
credit-table mass in every mode, and ``chip_smoke.py``'s copy of the
benchmark row (``benchmarks/scenarios.py::_run_one``, single device)
reproduces the reference's at the benchmark's FAST size."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import scenarios as jbench  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.simnet import SimParams as JSimParams  # noqa: E402
from repro.core.types import SyncMode  # noqa: E402
from repro.workloads import dynamic as jdyn  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import runner as trun  # noqa: E402
from repro_torch.core.credits import credit_init as t_credit_init  # noqa: E402
from repro_torch.core.types import SyncMode as TSyncMode  # noqa: E402
from repro_torch.workloads import dynamic as tdyn  # noqa: E402
from test_torch_recovery import load_smoke  # noqa: E402
from test_torch_runner import assert_fields_equal  # noqa: E402

FAST = jbench.FAST
NAMES = list(jdyn.SCENARIOS)
GEN_CASES = [
    ("hotspot_shift", dict(hot_keys=4, shift_window=3, hot_frac=0.9)),
    ("flash_crowd", dict(peak_window=0, peak_frac=0.5)),
    ("flash_crowd", dict(peak_window=9)),
    ("churn", dict(phase_len=2, populated_frac=0.25, churn_frac=0.4)),
    ("skew_drift", dict(theta0=0.6, theta1=1.4, write_ratio=0.7)),
]


def _ops_equal(a, b):
    for f in ("kinds", "keys", "values", "clients"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", NAMES)
def test_scenario_generators_identical(name):
    args = (FAST["windows"], FAST["batch"], FAST["n_keys"], FAST["n_clients"])
    _ops_equal(jdyn.SCENARIOS[name].generate(*args, seed=FAST["seed"]),
               tdyn.SCENARIOS[name].generate(*args, seed=FAST["seed"]))
    js, ts = jdyn.SCENARIOS[name], tdyn.SCENARIOS[name]
    assert (js.populated_frac, js.description) == (ts.populated_frac,
                                                   ts.description)
    assert np.array_equal(js.populate_keys(100), ts.populate_keys(100))


@pytest.mark.parametrize("name,kw", GEN_CASES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(GEN_CASES)])
def test_scenario_generators_identical_with_overrides(name, kw):
    args = (10, 96, 300, 7)
    _ops_equal(getattr(jdyn, name)(*args, seed=4, **kw),
               getattr(tdyn, name)(*args, seed=4, **kw))


def test_hotspot_shift_sets_and_errors_identical():
    a, (ja, jb) = jdyn.hotspot_shift(8, 64, 256, 8, seed=2, return_sets=True)
    b, (ta, tb) = tdyn.hotspot_shift(8, 64, 256, 8, seed=2, return_sets=True)
    _ops_equal(a, b)
    assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
    for mod in (jdyn, tdyn):
        with pytest.raises(ValueError, match="hot_keys"):
            mod.hotspot_shift(4, 4, 64, 2, hot_keys=8)


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_run_windows_traced_hotspot_shift_matches_reference(mode):
    """The AIMD adaptation across a hotspot shift: per-window results and
    bills, final state and credits, and the credit mass after every
    window, bit for bit."""
    c = FAST
    ops = jdyn.hotspot_shift(c["windows"], c["batch"], c["n_keys"],
                             c["n_clients"], seed=c["seed"])
    jcfg = jbench._cfg(mode, c)
    smoke = load_smoke()
    tcfg = smoke.scenario_cfg(TSyncMode(int(mode)), c)
    pk = np.arange(c["n_keys"])
    js = jeng.populate(jcfg, jeng.store_init(jcfg), pk, pk)
    ts = teng.populate(tcfg, teng.store_init(tcfg, "cpu"), pk, pk)
    a = jrun.run_windows_traced(
        jcfg, js, j_credit_init(c["credit_table"]),
        jrun.make_stream(ops.kinds, ops.keys, ops.values, n_cns=c["n_cns"]))
    b = trun.run_windows_traced(
        tcfg, ts, t_credit_init(c["credit_table"], "cpu"),
        trun.make_stream(ops.kinds, ops.keys, ops.values, n_cns=c["n_cns"],
                         device="cpu"))
    for x, y, what in zip(a[:4], b[:4], ("state", "credits", "results",
                                         "io")):
        assert_fields_equal(x, y, what)
    assert np.asarray(a[4]).dtype == b[4].numpy().dtype
    assert np.array_equal(np.asarray(a[4]), b[4].numpy())
    if mode == SyncMode.CIDER:
        assert int(b[4].max()) > 0          # the credits moved


@pytest.mark.parametrize("name", NAMES)
def test_scenario_rows_match_reference_benchmark(name):
    """``chip_smoke.scenario_rows`` on the CPU against the reference's
    ``_run_one`` on the single device, every mode, trajectories included."""
    smoke = load_smoke()
    got = smoke.scenario_rows("cpu", FAST, names=[name])[name]
    sc = jdyn.SCENARIOS[name]
    ops = sc.generate(FAST["windows"], FAST["batch"], FAST["n_keys"],
                      FAST["n_clients"], seed=FAST["seed"])
    stream = jrun.make_stream(ops.kinds, ops.keys, ops.values,
                              n_cns=FAST["n_cns"])
    for mode in jbench.MODES:
        want = jbench._run_one(sc, mode, "single", FAST, ops, stream,
                               JSimParams())
        assert got[mode.name] == want, mode
