"""The port's MN-replication slice against the JAX reference (CPU):
``MNLiveness`` and its builders, ``promote_replica``, and
``run_recovery_replicated`` (R 2 and 3, CN crashes included) bit for bit;
the ``BENCH_replication.json`` rows at the benchmark's FAST size through
``chip_smoke.py``'s helpers; and ``chip_smoke.py``'s deployment check at a
small size.  The sharded entry raises."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import replication as jbench  # noqa: E402
from repro import recovery as jrec  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.simnet import SimParams as JSimParams  # noqa: E402
from repro.core.types import EngineConfig as JConfig  # noqa: E402
from repro.core.types import SyncMode  # noqa: E402
from repro.core.types import per_replica_bill as j_per_replica  # noqa: E402
from repro.dist import store as jdstore  # noqa: E402
from repro.stores import PointerArray as JPointerArray  # noqa: E402
from repro.workloads import ycsb as jycsb  # noqa: E402
from repro.workloads.recovery import crash_storm as j_crash_storm  # noqa: E402
from repro_torch import recovery as trec  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import runner as trun  # noqa: E402
from repro_torch.core.credits import credit_init as t_credit_init  # noqa: E402
from repro_torch.core.types import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.types import SyncMode as TSyncMode  # noqa: E402
from repro_torch.dist import store as tdstore  # noqa: E402
from repro_torch.workloads.recovery import crash_storm as t_crash_storm  # noqa: E402
from test_torch_recovery import load_smoke  # noqa: E402
from test_torch_runner import assert_fields_equal  # noqa: E402

W, B, NK, NCN = 9, 128, 256, 8
HEAP = NK + W * B


def _pair(mode, r: int):
    kw = dict(n_slots=NK, heap_slots=HEAP, n_replicas=r)
    return JConfig(mode=mode, **kw), TConfig(mode=TSyncMode(int(mode)), **kw)


def _streams(seed: int, crash_window: int):
    """The same crash_storm stream (CN crash at ``crash_window``) for both."""
    args = (W, B, NK, 16, NCN)
    ops, sched = j_crash_storm(*args, seed=seed, crash_window=crash_window)
    ops_t, sched_t = t_crash_storm(*args, seed=seed, crash_window=crash_window)
    assert np.array_equal(ops.keys, ops_t.keys)
    assert np.array_equal(sched.alive, sched_t.alive)
    js = jrun.make_stream(ops.kinds, ops.keys, ops.values, n_cns=NCN,
                          alive=sched.alive)
    ts = trun.make_stream(ops.kinds, ops.keys, ops.values, n_cns=NCN,
                          alive=sched.alive, device="cpu")
    return js, ts


def _stores(jcfg, tcfg):
    pk = np.arange(NK)
    return (jeng.populate(jcfg, jeng.store_init(jcfg), pk, pk),
            teng.populate(tcfg, teng.store_init(tcfg, "cpu"), pk, pk))


# ---------------------------------------------------------------------------
# MNLiveness
# ---------------------------------------------------------------------------

MN_CASES = [("mn_always_alive", (6, 3)), ("mn_crash", (8, 3, (2,), 5)),
            ("mn_crash", (8, 3, (0, 2), 1)), ("mn_crash", (5, 2, (1,), 4))]


@pytest.mark.parametrize("name,args", MN_CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(MN_CASES)])
def test_mn_liveness_builders_identical(name, args):
    ref = getattr(jrec, name)(*args)
    port = getattr(trec, name)(*args)
    assert np.array_equal(ref.alive, port.alive)
    assert np.array_equal(ref.died(), port.died())
    assert np.array_equal(ref.n_alive(), port.n_alive())
    assert ref.segments() == port.segments()
    assert ref.first_crash_window() == port.first_crash_window()
    assert [ref.survivors(w) for w in range(ref.windows)] == [
        port.survivors(w) for w in range(port.windows)]


def test_mn_liveness_contracts_match():
    no_survivor = np.ones((4, 2), bool)
    no_survivor[2:] = False
    rejoin = np.ones((4, 2), bool)
    rejoin[1, 0] = False
    for mod in (jrec, trec):
        with pytest.raises(ValueError, match="surviving replica"):
            mod.MNLiveness(no_survivor)
        with pytest.raises(ValueError, match="no rejoin"):
            mod.MNLiveness(rejoin)
        with pytest.raises(ValueError, match="n_replicas"):
            mod.MNLiveness(np.ones(3, bool))


# ---------------------------------------------------------------------------
# promote_replica
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [SyncMode.MCS, SyncMode.SPIN, SyncMode.CIDER],
                         ids=lambda m: m.name)
def test_promote_replica_matches_reference(mode):
    """On the store a CN crash left stranded locks in, both packages bill
    the same sweep and re-arm CAS and hand the state back untouched."""
    jcfg, tcfg = _pair(mode, 2)
    js, ts = _streams(seed=2, crash_window=2)
    jst, tst = _stores(jcfg, tcfg)
    jst, _, _, _ = jrun.run_windows(jcfg, jst, j_credit_init(256),
                                    jrec.slice_stream(js, 0, 3))
    tst, _, _, _ = trun.run_windows(tcfg, tst, t_credit_init(256, "cpu"),
                                    trec.slice_stream(ts, 0, 3))
    assert_fields_equal(jst, tst, "state")
    for surv, dead in (((0,), (1,)), ((1, 0), (2,)), ((0, 1, 3), (2, 4))):
        _, jrio = jdstore.promote_replica(jcfg, jst, surv, dead)
        st2, trio = tdstore.promote_replica(tcfg, tst, surv, dead)
        assert st2 is tst
        assert jrio == trio
    assert trio["repair_rearm_cas"] == 3 * int(tst.stranded.sum())
    for mod, cfg, st in ((jdstore, jcfg, jst), (tdstore, tcfg, tst)):
        with pytest.raises(ValueError, match="no surviving"):
            mod.promote_replica(cfg, st, (), (0,))
        with pytest.raises(ValueError, match="both dead and surviving"):
            mod.promote_replica(cfg, st, (0, 1), (1,))


# ---------------------------------------------------------------------------
# run_recovery_replicated
# ---------------------------------------------------------------------------

REPLICATED = [(SyncMode.OSYNC, 2, 0, ((1,), 4)),
              (SyncMode.SPIN, 3, 1, ((2,), 3)),
              (SyncMode.MCS, 2, 2, ((0,), 3)),
              (SyncMode.MCS, 3, 3, ((0, 1), 5)),
              (SyncMode.CIDER, 2, 4, ((1,), 2)),
              (SyncMode.CIDER, 3, 5, ((2,), 3))]


@pytest.mark.parametrize(
    "mode,r,seed,death", REPLICATED,
    ids=[f"{m.name}-R{r}-seed{s}" for m, r, s, _ in REPLICATED])
def test_run_recovery_replicated_matches_reference(mode, r, seed, death):
    """A CN crash at window 3 and replica deaths (at the same window, or
    another) through both packages: per-window results and bills, final
    state and credits, validity and the promotion bill, bit for bit; a
    second replica death in one schedule too (R 3)."""
    jcfg, tcfg = _pair(mode, r)
    js, ts = _streams(seed, crash_window=3)
    dead, at = death
    mns = [(jrec.mn_crash(W, r, dead, at), trec.mn_crash(W, r, dead, at))]
    if r == 3 and len(dead) == 1:
        alive = np.ones((W, 3), bool)
        alive[at:, dead] = False
        alive[at + 3:, 0] = False
        mns.append((jrec.MNLiveness(alive), trec.MNLiveness(alive)))
    for jmn, tmn in mns:
        jst, tst = _stores(jcfg, tcfg)
        a = jrec.run_recovery_replicated(jcfg, jst, j_credit_init(256), js,
                                         jmn)
        b = trec.run_recovery_replicated(tcfg, tst, t_credit_init(256, "cpu"),
                                         ts, tmn)
        assert_fields_equal(a.results, b.results, "results")
        assert_fields_equal(a.io, b.io, "io")
        assert_fields_equal(a.state, b.state, "state")
        assert_fields_equal(a.credits, b.credits, "credits")
        assert np.array_equal(a.valid, b.valid)
        assert a.recovery_io == b.recovery_io
        assert len(b.recovery_io) == len(tmn.segments()) - 1
        assert b.n_shards == 1


def test_run_recovery_replicated_validates_shapes():
    jcfg, tcfg = _pair(SyncMode.CIDER, 2)
    js, ts = _streams(seed=0, crash_window=3)
    jst, tst = _stores(jcfg, tcfg)
    for mod, cfg, st, stream, cr in (
            (jrec, jcfg, jst, js, j_credit_init(256)),
            (trec, tcfg, tst, ts, t_credit_init(256, "cpu"))):
        with pytest.raises(ValueError, match="windows"):
            mod.run_recovery_replicated(cfg, st, cr, stream,
                                        mod.mn_always_alive(W + 1, 2))
        with pytest.raises(ValueError, match="replicas"):
            mod.run_recovery_replicated(cfg, st, cr, stream,
                                        mod.mn_always_alive(W, 3))


def test_run_recovery_sharded_raises_naming_item_11():
    with pytest.raises(NotImplementedError, match="ROADMAP item A11"):
        trec.run_recovery_sharded(TConfig(n_slots=8, heap_slots=8), 4, None,
                                  None, None, failovers=())


# ---------------------------------------------------------------------------
# the benchmark rows and the deployment check of chip_smoke.py, small
# ---------------------------------------------------------------------------

def test_replication_rows_match_reference_benchmark():
    """``chip_smoke.replication_rows`` on the CPU against the reference's
    benchmark recipe (``_cell``, ``per_replica_bill``, ``_mn_crash_cell``)
    at a FAST-like size: every single row R 1-3 x 4 modes and the mn_crash
    cell (MCS and CIDER: the other modes' bills are held by the tests
    above)."""
    smoke = load_smoke()
    c = dict(n_slots=1024, batch=256, windows=4)
    modes = [SyncMode.MCS, SyncMode.CIDER]
    got = smoke.replication_rows("cpu", c, modes=[m.name for m in modes])
    n_slots, b, windows = c["n_slots"], c["batch"], c["windows"]
    ops = jycsb.generate_window_stream(jycsb.WORKLOADS["write-intensive"],
                                       windows, b, n_slots, b)

    def stream_fn():
        return jrun.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                                n_cns=16)

    pk = np.arange(n_slots)
    io_one, io_w_r3 = {}, {}
    for r in (1, 2, 3):
        p = dataclasses.replace(JSimParams(), n_replicas=r)
        for mode in modes:
            pa = JPointerArray.create(n_slots, mode=mode,
                                      n_replicas=r).populate(pk, pk)
            cfg = pa.cfg
            pa, res, io_w = pa.apply_stream(stream_fn(), io_per_window=True)
            d = jbench._cell(cfg, ops, res, io_w, p, windows * b)
            if r == 1:
                io_one[mode] = jbench._sum_io(io_w)
            else:
                d["per_replica"] = j_per_replica(
                    io_one[mode], jbench._sum_io(io_w), r)
            if r == 3:
                io_w_r3[mode] = io_w
            assert got["replicas"][str(r)][mode.name] == d, (r, mode)
    for mode in modes:
        cfg = dataclasses.replace(JPointerArray.create(n_slots, mode=mode).cfg,
                                  n_replicas=jbench.CRASH_R)
        p = dataclasses.replace(JSimParams(), n_replicas=jbench.CRASH_R)
        want = jbench._mn_crash_cell(cfg, c, ops, stream_fn, p,
                                     io_w_r3[mode])
        assert got["mn_crash"][mode.name] == want, mode


def test_replicated_deployment_check_small():
    """``chip_smoke.replicated_deployment`` (phase 11) on the CPU at a small
    size: its oracle, segmented-run, R = 1 and conservation checks pass,
    and its repair timeline equals the reference's on the same run."""
    smoke = load_smoke()
    n_keys, windows, batch, n_cns = 2048, 9, 256, 16
    out = smoke.replicated_deployment("cpu", n_keys, windows, batch, n_cns,
                                      n_clients=n_cns, credit_table=256,
                                      seed=5)
    ops, sched = j_crash_storm(windows, batch, n_keys, n_cns, n_cns, seed=5)
    assert out["crash_window"] == sched.first_crash_window() == 3
    stream = jrun.make_stream(ops.kinds, ops.keys, ops.values, n_cns=n_cns,
                              alive=sched.alive)
    mn = jrec.mn_crash(windows, 3, (2,), 6)
    for name in ("CIDER", "MCS"):
        cfg = JConfig(n_slots=n_keys, heap_slots=n_keys + windows * batch,
                      mode=SyncMode[name], n_replicas=3)
        st = jeng.populate(cfg, jeng.store_init(cfg), np.arange(n_keys),
                           np.arange(n_keys))
        run = jrec.run_recovery_replicated(cfg, st, j_credit_init(256),
                                           stream, mn)
        assert out[name]["time_to_repair"] == jrec.time_to_repair(
            run.io, out["crash_window"])
        assert out[name]["recovery_io"] == run.recovery_io
        assert out[name]["mn_iops"] == int(np.asarray(run.io_sum().mn_iops))
        assert [s["replicas"] for s in out[name]["segments"]] == [3, 2]
