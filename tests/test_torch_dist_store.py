"""The port's sharded store (``repro_torch.dist.store`` on a local mesh)
against the JAX reference on the CPU, bit for bit: the per-shard
``engine.apply_batch(owned, slot_base)`` against the reference's on the same
partition (every ``SyncMode``; SCAN, a CN crash, 3 MN replicas);
``sharded_store_init``/``sharded_populate``; ``run_windows_sharded`` (2 and
4 shards) against the reference's single-device ``run_windows`` and its
per-shard engine loop (physical layout, per-shard bills, every shard's
credit table); ``run_windows_sharded_traced``; ``failover_reown`` and
``run_recovery_sharded``."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import recovery as jrec  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core.credits import CreditState as JCredits  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.types import EngineConfig as JConfig  # noqa: E402
from repro.core.types import OpBatch as JBatch  # noqa: E402
from repro.core.types import OpKind, SyncMode  # noqa: E402
from repro.dist import store as jdstore  # noqa: E402
from repro.launch.mesh import make_local_mesh as j_local_mesh  # noqa: E402
from repro_torch import recovery as trec  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import runner as trun  # noqa: E402
from repro_torch.core.credits import credit_init as t_credit_init  # noqa: E402
from repro_torch.core.types import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.types import SyncMode as TSyncMode  # noqa: E402
from repro_torch.dist import store as tdstore  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from test_torch_runner import assert_fields_equal  # noqa: E402

MODES = list(SyncMode)
NS, B, W, NCN, TABLE, SCAN_MAX = 256, 128, 6, 8, 128, 8
HEAP = NS + W * B
STORE_FIELDS = ("ptr", "meta", "epoch", "heap", "heap_top")


def _cfgs(mode, **kw):
    kw = dict(n_slots=NS, heap_slots=HEAP, **kw)
    return JConfig(mode=mode, **kw), TConfig(mode=TSyncMode(int(mode)), **kw)


def _ops(seed: int, scan: bool = True):
    """W windows of mixed ops, half of them on four hot keys (so CIDER's
    credits warm up and runs cross shards), SCANs included."""
    rng = np.random.default_rng(seed)
    menu = [OpKind.SEARCH, OpKind.INSERT, OpKind.UPDATE, OpKind.DELETE]
    p = [0.3, 0.1, 0.5, 0.1]
    if scan:
        menu, p = menu + [OpKind.SCAN], [0.25, 0.1, 0.4, 0.1, 0.15]
    kinds = rng.choice(menu, size=(W, B), p=p).astype(np.int32)
    hot = rng.integers(0, NS, 4)
    keys = np.where(rng.random((W, B)) < 0.5, hot[rng.integers(0, 4, (W, B))],
                    rng.integers(0, NS, (W, B))).astype(np.int32)
    values = rng.integers(0, 10_000, (W, B))
    values = np.where(kinds == OpKind.SCAN,
                      rng.integers(1, SCAN_MAX + 3, (W, B)), values)
    # CNs 1 and 5 die at window 2, CN 3 at the last window
    alive = np.ones((W, NCN), bool)
    alive[2:, [1, 5]] = False
    alive[W - 1, 3] = False
    return kinds, keys, values.astype(np.int32), alive


def _streams(seed: int, crash: bool = True, scan: bool = True):
    kinds, keys, values, alive = _ops(seed, scan)
    alive = alive if crash else None
    return (jrun.make_stream(kinds, keys, values, n_cns=NCN, alive=alive),
            trun.make_stream(kinds, keys, values, n_cns=NCN, alive=alive,
                             device="cpu"))


POP = np.arange(0, NS, 2)


def _tsharded(tcfg, n):
    return tdstore.sharded_populate(
        tcfg, n, tdstore.sharded_store_init(tcfg, n, "cpu"), POP, POP + 7)


def _j(x):
    """A port tensor (or dataclass of them) as the reference's arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: _j(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return jnp.asarray(x.numpy())


def _jstore(st):
    return jeng.StoreState(**_j(st))


def _jcredits(cr):
    return JCredits(**_j(cr))


def _jbatch(stream, w):
    return JBatch(*(jnp.asarray(getattr(stream.batch, f.name)[w].numpy())
                    for f in dataclasses.fields(JBatch)))


@functools.lru_cache(maxsize=None)
def _jax_single(mode, seed: int):
    """The reference single-device run (per-window bills) of the stream."""
    jcfg, _ = _cfgs(mode, scan_max=SCAN_MAX)
    js, _ = _streams(seed)
    st = jeng.populate(jcfg, jeng.store_init(jcfg), POP, POP + 7)
    return jrun.run_windows(jcfg, st, j_credit_init(TABLE), js,
                            io_per_window=True)


def _assert_view(jst, tcfg, n, tst):
    ex1, v1 = jeng.store_view(jst)
    ex2, v2 = tdstore.sharded_store_view(tcfg, n, tst)
    assert np.array_equal(np.asarray(ex1), ex2.numpy())
    assert np.array_equal(np.asarray(v1), v2.numpy())
    assert np.array_equal(np.asarray(jst.meta), tst.meta.numpy())
    assert np.array_equal(np.asarray(jst.epoch), tst.epoch.numpy())


# ---------------------------------------------------------------------------
# the per-shard engine step
# ---------------------------------------------------------------------------

VARIANTS = ("live", "nolive", "scan", "crash", "replicas")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_per_shard_apply_batch_matches_reference(mode, variant):
    """Warm a 4-way store up over W - 1 windows with the port, then run the
    last window on every shard's partition through both engines: state,
    credits, results and bill of each shard bit for bit."""
    n = 4
    kw = {"scan_max": SCAN_MAX if variant == "scan" else 0,
          "n_replicas": 3 if variant == "replicas" else 1}
    jcfg, tcfg = _cfgs(mode, **kw)
    js, ts = _streams(3, crash=variant == "crash", scan=variant == "scan")
    mesh = make_local_mesh(n, "cpu")
    warm = trec.slice_stream(ts, 0, W - 1)
    st, cr, _, _ = tdstore.run_windows_sharded(
        tcfg, mesh, _tsharded(tcfg, n), t_credit_init(TABLE, "cpu"), warm)
    per, hper = tdstore.shard_extents(tcfg, n)
    jl = dataclasses.replace(jcfg, n_slots=per, heap_slots=hper)
    tl = dataclasses.replace(tcfg, n_slots=per, heap_slots=hper)
    w = W - 1
    tb = tdstore._window(ts, w)
    jb = _jbatch(ts, w)
    live = {}
    if variant != "nolive":
        alive, died = ts.alive[w], ts.alive[w - 1] & ~ts.alive[w]
        live = {"alive": alive, "died": died}
    for s in range(n):
        part = tdstore._partition(st, s, per, hper)
        owned = (tb.keys >= s * per) & (tb.keys < (s + 1) * per)
        t_out = teng.apply_batch(tl, part, cr, tb, valid=ts.valid[w],
                                 owned=owned, slot_base=s * per, **live)
        j_out = jeng.apply_batch(
            jl, _jstore(part), _jcredits(cr), jb,
            valid=jnp.asarray(ts.valid[w].numpy()),
            owned=jnp.asarray(owned.numpy()),
            slot_base=jnp.int32(s * per),
            **{k: jnp.asarray(v.numpy()) for k, v in live.items()})
        for what, a, b in zip(("state", "credits", "Results", "IOMetrics"),
                              j_out, t_out):
            assert_fields_equal(a, b, f"shard {s} {what}")
    if variant == "crash" and mode != SyncMode.OSYNC:
        assert int(st.stranded.sum()) > 0        # the crash stranded locks


def test_non_owning_shard_emits_neutral_results():
    """A shard that owns none of the window's keys returns every Results
    field's neutral element and a zero bill."""
    _, tcfg = _cfgs(SyncMode.CIDER, scan_max=SCAN_MAX)
    _, ts = _streams(4)
    n = 4
    per, hper = tdstore.shard_extents(tcfg, n)
    tl = dataclasses.replace(tcfg, n_slots=per, heap_slots=hper)
    tb = tdstore._window(ts, 0)
    tb = dataclasses.replace(tb, keys=torch.clamp(tb.keys, max=per - 9))
    part = tdstore._partition(_tsharded(tcfg, n), 3, per, hper)
    owned = torch.zeros_like(ts.valid[0])
    _, _, res, io = teng.apply_batch(tl, part, t_credit_init(TABLE, "cpu"), tb,
                                     valid=ts.valid[0], owned=owned,
                                     slot_base=3 * per)
    neutral = {"value": -1, "wc_batch": 1}
    for f in dataclasses.fields(res):
        assert (getattr(res, f.name) == neutral.get(f.name, 0)).all(), f.name
    assert all(int(v) == 0 for v in io.as_dict().values())


# ---------------------------------------------------------------------------
# the sharded store's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_populate_matches_reference(n):
    jcfg, tcfg = _cfgs(SyncMode.CIDER)
    keys = np.random.default_rng(n).permutation(NS)[:NS // 3]
    vals = np.arange(keys.shape[0]) * 3 + 1
    js = jdstore.sharded_populate(jcfg, n, jdstore.sharded_store_init(jcfg, n),
                                  keys, vals)
    ts = tdstore.sharded_populate(
        tcfg, n, tdstore.sharded_store_init(tcfg, n, "cpu"), keys, vals)
    assert_fields_equal(js, ts, "sharded_populate")
    for a, b in zip(jdstore.sharded_store_view(jcfg, n, js),
                    tdstore.sharded_store_view(tcfg, n, ts)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_divisibility_error():
    _, tcfg = _cfgs(SyncMode.CIDER)
    with pytest.raises(ValueError, match="divisible by n_shards=3"):
        tdstore.shard_extents(tcfg, 3)
    with pytest.raises(ValueError, match="divisible"):
        tdstore.sharded_store_init(tcfg, 3, "cpu")
    _, ts = _streams(1)
    with pytest.raises(ValueError, match="divisible"):
        tdstore.run_windows_sharded(tcfg, make_local_mesh(3, "cpu"),
                                    _tsharded(tcfg, 2),
                                    t_credit_init(TABLE, "cpu"), ts)
    with pytest.raises(ValueError, match="sharded_store_init"):
        tdstore.run_windows_sharded(tcfg, make_local_mesh(4, "cpu"),
                                    _tsharded(tcfg, 2),
                                    t_credit_init(TABLE, "cpu"), ts)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("io_per_window", [True, False])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_run_windows_sharded_matches_single_device(mode, n, io_per_window):
    """SCANs, CN crashes and CIDER's pessimistic path on one stream: the
    sharded run equals the reference's single-device ``run_windows``."""
    _, tcfg = _cfgs(mode, scan_max=SCAN_MAX)
    _, ts = _streams(5)
    jst, jcr, jres, jio = _jax_single(mode, 5)
    st, cr, res, io = tdstore.run_windows_sharded(
        tcfg, make_local_mesh(n, "cpu"), _tsharded(tcfg, n),
        t_credit_init(TABLE, "cpu"), ts, io_per_window=io_per_window)
    if not io_per_window:
        jio = jax.tree.map(lambda x: jnp.sum(x, axis=0), jio)
    assert_fields_equal(jres, res, "Results")
    assert_fields_equal(jio, io, "IOMetrics")
    assert_fields_equal(jcr, cr, "credits")
    _assert_view(jst, tcfg, n, st)
    assert int(res.rows.sum()) > 0
    if mode == SyncMode.CIDER:
        assert int(res.pessimistic.sum()) > 0
    if mode != SyncMode.OSYNC:
        assert int(io.repair_cas.sum()) > 0


def _jax_shard_loop(jcfg, n, ts, st0, cr0):
    """The reference's per-shard engine over every window of ``ts``:
    ``(assembled store arrays, per-shard credits, per-shard summed bills,
    per-shard stacked results)``."""
    per, hper = jdstore.shard_extents(jcfg, n)
    jl = dataclasses.replace(jcfg, n_slots=per, heap_slots=hper)
    sts = [_jstore(tdstore._partition(st0, s, per, hper)) for s in range(n)]
    crs = [_jcredits(cr0)] * n
    ios = [[] for _ in range(n)]
    ress = [[] for _ in range(n)]
    prev = ts.alive[0]
    for w in range(ts.shape[0]):
        jb = _jbatch(ts, w)
        alive = ts.alive[w]
        died = prev & ~alive
        prev = alive
        for s in range(n):
            owned = (ts.batch.keys[w] >= s * per) & (ts.batch.keys[w]
                                                     < (s + 1) * per)
            sts[s], crs[s], res, io = jeng.apply_batch(
                jl, sts[s], crs[s], jb, valid=jnp.asarray(ts.valid[w].numpy()),
                owned=jnp.asarray(owned.numpy()), slot_base=jnp.int32(s * per),
                alive=jnp.asarray(alive.numpy()),
                died=jnp.asarray(died.numpy()))
            ios[s].append(io)
            ress[s].append(res)
    arrays = {f: np.concatenate([np.asarray(getattr(x, f)) for x in sts])
              for f in ("ptr", "meta", "epoch", "heap")}
    arrays["heap_top"] = np.stack([np.asarray(x.heap_top) for x in sts])
    bills = [jax.tree.map(lambda *xs: np.sum(np.stack(xs), 0), *b)
             for b in ios]
    return arrays, crs, bills, ress


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_run_windows_sharded_layout_and_per_shard_bills(mode, n):
    """Against the reference's per-shard engine loop: the physical arrays
    (``ptr``/``meta``/``epoch``/``heap``/``heap_top``), every shard's
    replica of the credit table, and ``per_shard_io``'s slices, which sum
    to the global bill."""
    jcfg, tcfg = _cfgs(mode, scan_max=SCAN_MAX)
    _, ts = _streams(6)
    st0, cr0 = _tsharded(tcfg, n), t_credit_init(TABLE, "cpu")
    arrays, jcrs, bills, _ = _jax_shard_loop(jcfg, n, ts, st0, cr0)
    mesh = make_local_mesh(n, "cpu")
    st, cr, res, io = tdstore.run_windows_sharded(tcfg, mesh, st0, cr0, ts,
                                                  per_shard_io=True)
    for f in STORE_FIELDS:
        assert np.array_equal(arrays[f], getattr(st, f).numpy()), f
    for s in range(n):
        assert_fields_equal(jcrs[s], cr, f"shard {s} credits")
        for f in dataclasses.fields(io):
            got = getattr(io, f.name)
            assert tuple(got.shape) == (n,)
            assert int(got[s]) == int(getattr(bills[s], f.name)), (s, f.name)
    _, _, _, io_g = tdstore.run_windows_sharded(tcfg, mesh, st0, cr0, ts)
    for f in dataclasses.fields(io):
        assert torch.equal(getattr(io, f.name).sum(-1, dtype=torch.int32),
                           getattr(io_g, f.name)), f.name
    # per window as well: (W, n_shards) planes
    _, _, _, io_w = tdstore.run_windows_sharded(
        tcfg, mesh, st0, cr0, ts, per_shard_io=True, io_per_window=True)
    assert tuple(io_w.reads.shape) == (W, n)
    assert torch.equal(io_w.cas.sum(0, dtype=torch.int32), io.cas)


def test_every_shard_keeps_the_same_credit_table():
    """The credit plane is replicated: each shard computes its own copy
    from the same input, and the copies stay equal window after window."""
    _, tcfg = _cfgs(SyncMode.CIDER, scan_max=SCAN_MAX)
    _, ts = _streams(7)
    mesh = make_local_mesh(4, "cpu")
    _, crs, _, _, _ = tdstore._run_shards(
        tcfg, mesh, _tsharded(tcfg, 4), t_credit_init(TABLE, "cpu"), ts, None,
        True, False)
    assert int(crs[0].credit.sum()) > 0
    for s in range(1, 4):
        assert_fields_equal(crs[0], crs[s], f"shard {s} credits")


def test_run_windows_sharded_matches_reference_sharded_runner():
    """Against the reference's own ``run_windows_sharded`` (4-way, per-window
    bills), physical arrays included, where its ``shard_map`` runs."""
    mode = SyncMode.CIDER
    jcfg, tcfg = _cfgs(mode, scan_max=SCAN_MAX)
    js, ts = _streams(8)
    jst0 = jdstore.sharded_populate(jcfg, 4,
                                    jdstore.sharded_store_init(jcfg, 4),
                                    POP, POP + 7)
    try:
        jout = jdstore.run_windows_sharded(jcfg, j_local_mesh(data=4), jst0,
                                           j_credit_init(TABLE), js,
                                           io_per_window=True)
    except jax.errors.JaxRuntimeError as e:
        pytest.skip(f"the reference's sharded runner fails on this jax: {e}")
    tout = tdstore.run_windows_sharded(
        tcfg, make_local_mesh(4, "cpu"), _tsharded(tcfg, 4),
        t_credit_init(TABLE, "cpu"), ts, io_per_window=True)
    for f in STORE_FIELDS:
        assert np.array_equal(np.asarray(getattr(jout[0], f)),
                              getattr(tout[0], f).numpy()), f
    for what, a, b in zip(("credits", "Results", "IOMetrics"), jout[1:],
                          tout[1:]):
        assert_fields_equal(a, b, what)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_run_windows_sharded_traced_matches_reference(mode):
    jcfg, tcfg = _cfgs(mode, scan_max=SCAN_MAX)
    js, ts = _streams(9)
    st = jeng.populate(jcfg, jeng.store_init(jcfg), POP, POP + 7)
    jout = jrun.run_windows_traced(jcfg, st, j_credit_init(TABLE), js)
    tout = tdstore.run_windows_sharded_traced(
        tcfg, make_local_mesh(4, "cpu"), _tsharded(tcfg, 4),
        t_credit_init(TABLE, "cpu"), ts)
    for what, a, b in zip(("credits", "Results", "IOMetrics"), jout[1:4],
                          tout[1:4]):
        assert_fields_equal(a, b, what)
    assert np.array_equal(np.asarray(jout[4]), tout[4].numpy())
    _assert_view(jout[0], tcfg, 4, tout[0])


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_apply_batch_sharded_matches_single_device(mode):
    jcfg, tcfg = _cfgs(mode)
    kinds, keys, values, _ = _ops(10, scan=False)
    jb = JBatch.make(kinds[0], keys[0], values[0], n_cns=NCN)
    tb = trun.make_stream(kinds, keys, values, n_cns=NCN, device="cpu")
    tb = tdstore._window(tb, 0)
    st = jeng.populate(jcfg, jeng.store_init(jcfg), POP, POP + 7)
    jout = jeng.apply_batch(jcfg, st, j_credit_init(TABLE), jb)
    tout = tdstore.apply_batch_sharded(tcfg, make_local_mesh(4, "cpu"),
                                       _tsharded(tcfg, 4),
                                       t_credit_init(TABLE, "cpu"), tb)
    for what, a, b in zip(("credits", "Results", "IOMetrics"), jout[1:],
                          tout[1:]):
        assert_fields_equal(a, b, what)
    _assert_view(jout[0], tcfg, 4, tout[0])


# ---------------------------------------------------------------------------
# shard failover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("survivors", [(0, 2), (3,), (0, 1, 2, 3), (1, 3)])
def test_failover_reown_matches_reference(survivors):
    jcfg, tcfg = _cfgs(SyncMode.MCS, scan_max=SCAN_MAX)
    _, ts = _streams(11)
    st, _, _, _ = tdstore.run_windows_sharded(
        tcfg, make_local_mesh(4, "cpu"), _tsharded(tcfg, 4),
        t_credit_init(TABLE, "cpu"), ts)
    jnew, jrio = jdstore.failover_reown(jcfg, 4, _jstore(st), survivors)
    tnew, trio = tdstore.failover_reown(tcfg, 4, st, survivors)
    assert trio == jrio
    assert_fields_equal(jnew, tnew, "failover_reown state")
    with pytest.raises(ValueError, match="distinct shards"):
        tdstore.failover_reown(tcfg, 4, st, (0, 0))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_run_recovery_sharded_equals_single_device_drop_mask_run(mode):
    """4 shards, the survivors (0, 2) re-own the store at the crash window:
    results and every window's bill equal the reference's single-device
    drop-mask run, and ``recovery_io`` the reference's ``failover_reown``."""
    jcfg, tcfg = _cfgs(mode, scan_max=SCAN_MAX)
    js, ts = _streams(12)
    st = jeng.populate(jcfg, jeng.store_init(jcfg), POP, POP + 7)
    jrun_ = jrec.run_recovery(jcfg, st, j_credit_init(TABLE), js)
    ev = trec.FailoverEvent(window=2, survivors=(0, 2))
    run = trec.run_recovery_sharded(tcfg, 4, _tsharded(tcfg, 4),
                                    t_credit_init(TABLE, "cpu"), ts,
                                    failovers=[ev])
    assert run.n_shards == 2
    assert_fields_equal(jrun_.results, run.results, "Results")
    assert_fields_equal(jrun_.io, run.io, "IOMetrics")
    assert_fields_equal(jrun_.credits, run.credits, "credits")
    _assert_view(jrun_.state, tcfg, 2, run.state)
    assert np.array_equal(jrun_.valid, run.valid)
    # the recovery bill: the reference's failover_reown of the same store
    pre = tdstore.run_windows_sharded(
        tcfg, make_local_mesh(4, "cpu"), _tsharded(tcfg, 4),
        t_credit_init(TABLE, "cpu"), trec.slice_stream(ts, 0, 2))[0]
    _, jrio = jdstore.failover_reown(jcfg, 4, _jstore(pre), (0, 2))
    assert run.recovery_io == [{**jrio, "window": 2}]
    with pytest.raises(ValueError, match="interior"):
        trec.run_recovery_sharded(tcfg, 4, _tsharded(tcfg, 4),
                                  t_credit_init(TABLE, "cpu"), ts,
                                  failovers=[ev, ev])
