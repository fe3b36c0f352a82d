"""``chip_smoke.py``'s phase-12 helpers (the sharded store at the
benchmarks' configurations) on the CPU, at the benchmarks' FAST sizes,
against the reference's benchmark recipes (``benchmarks/{run,recovery,
replication,scenarios,scale}.py``).  The reference's own sharded runner
fails on this jax (ROADMAP "Reference faults"), so each recipe runs with
its single-device twin: the single rows of the same recipe (which the
committed files hold equal to the sharded rows), or, where the rows split
the bill by shard (weak scaling), the reference's per-shard engine
(``repro.core.engine.apply_batch(owned, slot_base)``) in place of
``run_windows_sharded``."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks import recovery as jrecb  # noqa: E402
from benchmarks import replication as jreplb  # noqa: E402
from benchmarks import run as jrunb  # noqa: E402
from benchmarks import scale as jscaleb  # noqa: E402
from benchmarks import scenarios as jscenb  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.simnet import SimParams as JSimParams  # noqa: E402
from repro.core.types import EngineConfig as JConfig  # noqa: E402
from repro.core.types import IOMetrics as JIO  # noqa: E402
from repro.core.types import OpBatch as JBatch  # noqa: E402
from repro.core.types import OpKind, SyncMode  # noqa: E402
from repro.dist import store as jdstore  # noqa: E402
from repro.stores import PointerArray as JPointerArray  # noqa: E402
from repro.workloads import dynamic as jdyn  # noqa: E402
from repro.workloads import ycsb as jycsb  # noqa: E402
from repro.workloads.recovery import RECOVERY_SCENARIOS  # noqa: E402
from repro_torch import recovery as trec  # noqa: E402
from repro_torch.core.types import SyncMode as TSyncMode  # noqa: E402
from test_torch_recovery import load_smoke  # noqa: E402

N_SHARDS = 4
YCSB_FAST = {**jrunb.YCSB_FAST,
             "heap_slots": (lambda h: h + -h % N_SHARDS)(
                 jrunb.YCSB_FAST["n_slots"]
                 + jrunb.YCSB_FAST["windows"] * jrunb.YCSB_FAST["batch"])}


def _ycsb_single_row(name: str, mode, c: dict) -> dict:
    """``bench_ycsb_json``'s single-device row of workload ``name``."""
    spec = jycsb.YCSB[name]
    p = JSimParams()
    ops = jycsb.generate_ycsb_stream(spec, c["windows"], c["batch"],
                                     c["n_keys"], c["n_clients"],
                                     seed=c["seed"])
    stream = jrun.make_stream(ops.kinds, ops.keys, ops.values,
                              n_cns=c["n_cns"])
    counts = np.where(ops.kinds == OpKind.SCAN, ops.values, 0)
    n_ops = int((ops.kinds != OpKind.NOP).sum())
    upd = ops.kinds == OpKind.UPDATE
    cfg = JConfig(n_slots=c["n_slots"], heap_slots=c["heap_slots"], mode=mode,
                  scan_max=c["scan_max"] if spec.scan > 0 else 0)
    pk = np.arange(c["n_keys"])
    st = jeng.populate(cfg, jeng.store_init(cfg), pk, pk)
    _, _, res, io = jrun.run_windows(cfg, st, j_credit_init(c["credit_table"]),
                                     stream)
    d = io.as_dict()
    d.update(jrun.modeled_throughput(io, p, n_ops=n_ops))
    lat = jrun.modeled_latency(cfg, ops.kinds, res, p, scan_counts=counts)
    d.update({f"modeled_{k}": v
              for k, v in jrun.latency_stats(lat).as_dict().items()})
    d["rows"] = int(np.asarray(res.rows).sum())
    d["pess_ratio"] = round(float((np.asarray(res.pessimistic) & upd).sum()
                                  / max(int(upd.sum()), 1)), 4)
    return d


@pytest.fixture(scope="module")
def ycsb_rows():
    smoke = load_smoke()
    return {n: smoke.ycsb_rows("cpu", YCSB_FAST, n) for n in (None, N_SHARDS)}


@pytest.mark.parametrize("n_shards", [None, N_SHARDS])
@pytest.mark.parametrize("mode", [SyncMode.MCS, SyncMode.CIDER],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("name", ["A", "E"])
def test_ycsb_rows_match_reference_single_rows(ycsb_rows, name, mode,
                                               n_shards):
    """The single and sharded4 rows of ``BENCH_ycsb.json``'s recipe equal
    its single rows; E's SCANs cross the partition edges.  On the CPU no
    kernel launches."""
    rows, launches = ycsb_rows[n_shards]
    assert rows[name][mode.name] == _ycsb_single_row(name, mode, YCSB_FAST)
    assert sorted(rows) == sorted(jycsb.YCSB)
    assert set(launches.values()) == {0}


def test_replication_sharded_rows_match_reference_single_cells():
    smoke = load_smoke()
    c = dict(n_slots=1024, batch=256, windows=4)
    modes = [SyncMode.MCS, SyncMode.CIDER]
    got = smoke.replication_sharded_rows("cpu", c, N_SHARDS,
                                         modes=[m.name for m in modes])
    n_slots, b, windows = c["n_slots"], c["batch"], c["windows"]
    ops = jycsb.generate_window_stream(jycsb.WORKLOADS["write-intensive"],
                                       windows, b, n_slots, b)
    stream = jrun.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                              n_cns=16)
    pk = np.arange(n_slots)
    for r in (1, 2, 3):
        p = dataclasses.replace(JSimParams(), n_replicas=r)
        for mode in modes:
            pa = JPointerArray.create(n_slots, mode=mode,
                                      n_replicas=r).populate(pk, pk)
            cfg = pa.cfg
            _, res, io_w = pa.apply_stream(stream, io_per_window=True)
            assert got[str(r)][mode.name] == jreplb._cell(
                cfg, ops, res, io_w, p, windows * b), (r, mode)


@pytest.mark.parametrize("name", list(jdyn.SCENARIOS))
def test_scenario_sharded_rows_match_reference_single_rows(name):
    """``scenario_rows(n_shards=4)`` (``run_windows_sharded_traced``)
    against the reference's ``_run_one`` on the single device, every mode,
    trajectories and credit mass included."""
    smoke = load_smoke()
    c = jscenb.FAST
    got = smoke.scenario_rows("cpu", c, names=[name],
                              n_shards=N_SHARDS)[name]
    sc = jdyn.SCENARIOS[name]
    ops = sc.generate(c["windows"], c["batch"], c["n_keys"], c["n_clients"],
                      seed=c["seed"])
    stream = jrun.make_stream(ops.kinds, ops.keys, ops.values,
                              n_cns=c["n_cns"])
    for mode in jscenb.MODES:
        assert got[mode.name] == jscenb._run_one(sc, mode, "single", c, ops,
                                                 stream, JSimParams()), mode


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_recovery_failover_matches_reference(mode):
    """The crash storm's shard failover (``recovery_failover``): its
    self-check against the single-device drop-mask run holds, and its
    ``failover`` sub-dict is the reference's ``failover_reown`` bill of the
    store at the crash window."""
    smoke = load_smoke()
    c = jrecb.FAST
    cfg, ops, sched, stream, st, cr = smoke.recovery_setup(
        "cpu", c, "crash_storm", TSyncMode(int(mode)))
    crash_w = sched.first_crash_window()
    single = trec.run_recovery(cfg, st, cr, stream)
    got = smoke.recovery_failover("cpu", c, cfg, stream, single, crash_w,
                                  mode.name)
    # the reference: its single-device run up to the crash window, the
    # store re-laid over its 4 shards, and failover_reown of that store
    jcfg = jrecb._cfg(mode, c)
    pk = RECOVERY_SCENARIOS["crash_storm"].populate_keys(c["n_keys"])
    jst = jeng.populate(jcfg, jeng.store_init(jcfg), pk, pk)
    jstream = jrun.make_stream(ops.kinds[:crash_w], ops.keys[:crash_w],
                               ops.values[:crash_w], n_cns=c["n_cns"],
                               alive=sched.alive[:crash_w])
    jst, _, _, _ = jrun.run_windows(jcfg, jst, j_credit_init(c["credit_table"]),
                                    jstream)
    exists, val = (np.asarray(x) for x in jeng.store_view(jst))
    keys = np.flatnonzero(exists)
    sst = jdstore.sharded_populate(jcfg, jrecb.N_SHARDS,
                                   jdstore.sharded_store_init(jcfg,
                                                              jrecb.N_SHARDS),
                                   keys, val[keys])
    _, rio = jdstore.failover_reown(jcfg, jrecb.N_SHARDS, sst,
                                    jrecb.SURVIVORS)
    assert got == {"asserted_equal": True, **rio, "window": crash_w}
    assert (smoke.REF_SHARDS, smoke.SURVIVORS) == (jrecb.N_SHARDS,
                                                   jrecb.SURVIVORS)


def _shard_engine_twin(cfg, mesh, state, credits, stream, *,
                       per_shard_io=False, io_per_window=False):
    """The reference's ``run_windows_sharded(per_shard_io=True,
    io_per_window=True)`` by its per-shard engine: every window on every
    shard's partition through ``engine.apply_batch(owned, slot_base)``,
    results summed with the neutral offsets of ``_psum_results`` and the
    bill split by shard ``(W, n_shards)``."""
    assert per_shard_io and io_per_window
    n = int(mesh.shape["data"])
    per, hper = jdstore.shard_extents(cfg, n)
    lcfg = dataclasses.replace(cfg, n_slots=per, heap_slots=hper)
    sts = [jeng.StoreState(
        ptr=state.ptr[s * per:(s + 1) * per],
        meta=state.meta[s * per:(s + 1) * per],
        epoch=state.epoch[s * per:(s + 1) * per],
        heap=state.heap[s * hper:(s + 1) * hper], heap_top=state.heap_top[s])
        for s in range(n)]
    crs = [credits] * n
    prev = stream.alive[0]
    ress, ios = [], []
    for w in range(stream.batch.kinds.shape[0]):
        batch = JBatch(*(getattr(stream.batch, f.name)[w]
                         for f in dataclasses.fields(JBatch)))
        alive = stream.alive[w]
        died = prev & ~alive
        prev = alive
        row_r, row_io = [], []
        for s in range(n):
            owned = (batch.keys >= s * per) & (batch.keys < (s + 1) * per)
            sts[s], crs[s], res, io = jeng.apply_batch(
                lcfg, sts[s], crs[s], batch, valid=stream.valid[w],
                owned=owned, slot_base=jnp.int32(s * per), alive=alive,
                died=died)
            row_r.append(res)
            row_io.append(io)
        tot = {f.name: sum(np.asarray(getattr(r, f.name), np.int32)
                           - {"value": -1, "wc_batch": 1}.get(f.name, 0)
                           for r in row_r)
               + {"value": -1, "wc_batch": 1}.get(f.name, 0)
               for f in dataclasses.fields(jeng.Results)}
        for f in ("ok", "pessimistic", "combined"):
            tot[f] = tot[f] > 0
        ress.append(jeng.Results(**tot))
        ios.append(JIO(*(np.stack([np.asarray(getattr(io, f.name))
                                   for io in row_io])
                         for f in dataclasses.fields(JIO))))
    stack = lambda cls, xs: cls(*(np.stack([getattr(x, f.name) for x in xs])  # noqa: E731
                                  for f in dataclasses.fields(cls)))
    return None, crs[0], stack(jeng.Results, ress), stack(JIO, ios)


def test_weak_scaling_rows_match_reference_recipe(monkeypatch):
    """``weak_scaling_rows`` at the FAST meshes {1, 2, 4} against
    ``benchmarks/scale.py::_weak_scaling`` itself (MCS and CIDER), with the
    reference's per-shard engine standing in for its sharded runner: the
    per-shard bills, hottest-shard ticks, p99 and efficiency table."""
    smoke = load_smoke()
    modes = [SyncMode.MCS, SyncMode.CIDER]
    monkeypatch.setattr(jscaleb, "MODES", modes)
    monkeypatch.setattr(jscaleb.dstore, "run_windows_sharded",
                        _shard_engine_twin)
    c = jscaleb.FAST
    want = jscaleb._weak_scaling(c, JSimParams(),
                                 jycsb.WORKLOADS["write-intensive"])
    got = smoke.weak_scaling_rows("cpu", c, modes=[m.name for m in modes])
    assert got == want
    assert len(got[0]["4"]["CIDER"]["shard_mn_iops"]) == 4


def test_sharded_deployment_checks_hold_at_a_small_size():
    """``sharded_deployment``'s checks (single device, oracle) at a few
    thousand keys, and the sizes it derives."""
    smoke = load_smoke()
    out = smoke.sharded_deployment("cpu", n_keys=4096, windows=3, batch=256,
                                   n_cns=8, credit_table=256, n_shards=4)
    assert sorted(out) == [("A", "CIDER"), ("A", "MCS"), ("E", "CIDER"),
                           ("E", "MCS")]
    assert all(o["mn_iops"] > 0 for o in out.values())
