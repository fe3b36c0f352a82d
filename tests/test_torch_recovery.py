"""The port's crash-recovery slice against the JAX reference (CPU): the
liveness builders and the three recovery scenarios give identical arrays,
``run_recovery`` gives bit-equal per-window results, bills, state and
credits, and ``time_to_repair`` and the benchmark's metric row
(``chip_smoke.py``'s copy of ``benchmarks/recovery.py::_metrics``) agree,
at the benchmark's FAST size, in every mode."""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import recovery as jbench  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.simnet import SimParams as JSimParams  # noqa: E402
from repro.core.types import SyncMode  # noqa: E402
from repro import recovery as jrec  # noqa: E402
from repro.recovery import liveness as jlive  # noqa: E402
from repro.workloads import recovery as jwrec  # noqa: E402
from repro_torch import recovery as trec  # noqa: E402
from repro_torch.core.simnet import SimParams as TSimParams  # noqa: E402
from repro_torch.core.types import SyncMode as TSyncMode  # noqa: E402
from repro_torch.recovery import liveness as tlive  # noqa: E402
from repro_torch.workloads import recovery as twrec  # noqa: E402
from test_torch_runner import assert_fields_equal  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAST = jbench.FAST
SCENARIOS = list(jwrec.RECOVERY_SCENARIOS)


def load_smoke():
    """``chip_smoke.py`` as a module (its helpers take ``dev``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ---------------------------------------------------------------------------
# liveness builders
# ---------------------------------------------------------------------------

BUILDERS = [
    ("always_alive", (7, 5), {}),
    ("crash", (9, 8, [1, 6], 3), {}),
    ("crash", (4, 3, [0, 1, 2], 1), {}),
    ("rolling", (12, 7), {}),
    ("rolling", (20, 9), dict(down_windows=3, start=2, stagger=4, group=2)),
    ("elastic", (10, 6, [(2, [4, 5], True), (6, [0], False), (6, [1], False),
                         (8, [0], True)]), dict(initial_alive=[0, 1, 2, 3])),
    ("elastic", (5, 4, []), {}),
]


@pytest.mark.parametrize("name,args,kw", BUILDERS,
                         ids=[f"{b[0]}{i}" for i, b in enumerate(BUILDERS)])
def test_liveness_builders_identical(name, args, kw):
    ref = getattr(jlive, name)(*args, **kw)
    port = getattr(tlive, name)(*args, **kw)
    assert np.array_equal(ref.alive, port.alive)
    assert ref.alive.dtype == port.alive.dtype == np.bool_
    assert np.array_equal(ref.died(), port.died())
    assert np.array_equal(ref.n_alive(), port.n_alive())
    assert ref.first_crash_window() == port.first_crash_window()
    assert (ref.windows, ref.n_cns) == (port.windows, port.n_cns)
    for n_ops, lpc in ((64, None), (37, 5), (3, None)):
        assert np.array_equal(ref.cn_of(n_ops, lpc), port.cn_of(n_ops, lpc))
        assert np.array_equal(ref.drop_mask(n_ops, lpc),
                              port.drop_mask(n_ops, lpc))


def test_liveness_contract_errors_match():
    for mod in (jlive, tlive):
        with pytest.raises(ValueError, match="alive must be"):
            mod.LivenessSchedule(np.ones(4, bool))
        with pytest.raises(ValueError, match="beyond"):
            mod.elastic(3, 2, [(5, [0], False)])


# ---------------------------------------------------------------------------
# scenarios and run_recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_recovery_scenarios_identical(name):
    total = FAST["warm"] + FAST["windows"]
    args = (total, FAST["batch"], FAST["n_keys"], FAST["n_clients"],
            FAST["n_cns"])
    kw = dict(seed=FAST["seed"], **jbench._overrides(name, FAST))
    ops_j, sched_j = jwrec.RECOVERY_SCENARIOS[name].generate(*args, **kw)
    ops_t, sched_t = twrec.RECOVERY_SCENARIOS[name].generate(*args, **kw)
    for f in ("kinds", "keys", "values", "clients"):
        x, y = getattr(ops_j, f), getattr(ops_t, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(sched_j.alive, sched_t.alive)
    # the defaults too (no overrides), and the registry's descriptions
    a = jwrec.RECOVERY_SCENARIOS[name].generate(*args, seed=3)
    b = twrec.RECOVERY_SCENARIOS[name].generate(*args, seed=3)
    assert np.array_equal(a[0].keys, b[0].keys)
    assert np.array_equal(a[1].alive, b[1].alive)
    assert (jwrec.RECOVERY_SCENARIOS[name].description
            == twrec.RECOVERY_SCENARIOS[name].description)


def _reference_run(name, mode):
    c = FAST
    sc = jwrec.RECOVERY_SCENARIOS[name]
    total = c["warm"] + c["windows"]
    ops, sched = sc.generate(total, c["batch"], c["n_keys"], c["n_clients"],
                             c["n_cns"], seed=c["seed"],
                             **jbench._overrides(name, c))
    cfg = jbench._cfg(mode, c)
    stream = jrun.make_stream(ops.kinds, ops.keys, ops.values,
                              n_cns=c["n_cns"], alive=sched.alive)
    pk = sc.populate_keys(c["n_keys"])
    st = jeng.populate(cfg, jeng.store_init(cfg), pk, pk)
    run = jrec.run_recovery(cfg, st, j_credit_init(c["credit_table"]), stream)
    return cfg, ops, sched, run


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
@pytest.mark.parametrize("name", SCENARIOS)
def test_run_recovery_matches_reference(name, mode):
    smoke = load_smoke()
    jcfg, jops, jsched, jrun_ = _reference_run(name, mode)
    cfg, ops, sched, stream, st, cr = smoke.recovery_setup(
        "cpu", FAST, name, TSyncMode(int(mode)))
    assert dataclasses.asdict(cfg) == {
        **dataclasses.asdict(jcfg), "mode": TSyncMode(int(mode))}
    run = trec.run_recovery(cfg, st, cr, stream)
    assert_fields_equal(jrun_.results, run.results, "results")
    assert_fields_equal(jrun_.io, run.io, "io")
    assert_fields_equal(jrun_.state, run.state, "state")
    assert_fields_equal(jrun_.credits, run.credits, "credits")
    assert np.array_equal(jrun_.valid, run.valid)
    assert (run.n_shards, run.recovery_io) == (1, [])
    assert_fields_equal(jrun_.io_sum(), run.io_sum(), "io_sum")
    crash_w = sched.first_crash_window()
    assert crash_w == jsched.first_crash_window()
    for w in (crash_w, None, 0):
        assert (jrec.time_to_repair(jrun_.io, w)
                == trec.time_to_repair(run.io, w))
    # the benchmark row: chip_smoke.py's copy of _metrics on the port's run
    assert (jbench._metrics(jcfg, FAST, jops, jrun_, crash_w, JSimParams())
            == smoke.recovery_metrics(cfg, FAST, ops, run, crash_w,
                                      TSimParams()))


def test_slice_stream_and_post_drop_valid():
    smoke = load_smoke()
    _, _, _, stream, _, _ = smoke.recovery_setup(
        "cpu", FAST, "rolling_restart", TSyncMode.CIDER)
    seg = trec.slice_stream(stream, 3, 9)
    assert seg.shape == (6, FAST["batch"])
    assert torch.equal(seg.alive, stream.alive[3:9])
    assert torch.equal(seg.batch.keys, stream.batch.keys[3:9])
    run_valid = trec.orchestrator._post_drop_valid(stream)
    sched = twrec.rolling_restart(
        FAST["warm"] + FAST["windows"], FAST["batch"], FAST["n_keys"],
        FAST["n_clients"], FAST["n_cns"], seed=FAST["seed"],
        **jbench._overrides("rolling_restart", FAST))[1]
    assert np.array_equal(run_valid, sched.drop_mask(FAST["batch"]))


def test_recovery_exports_match_reference():
    assert sorted(trec.__all__) == sorted(jrec.__all__)
    smoke = load_smoke()
    _, _, _, stream, _, _ = smoke.recovery_setup(
        "cpu", FAST, "crash_storm", TSyncMode.CIDER)
    w = stream.shape[0]
    for bad in (0, w + 1):
        with pytest.raises(ValueError, match="failover windows must lie"):
            trec.run_recovery_sharded(None, 4, None, None, stream,
                                      [trec.FailoverEvent(bad, (0, 2))])
