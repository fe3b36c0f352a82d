"""The port's types, workloads and runner against the JAX reference (CPU):
the same vocabulary and configs, identical generated streams, and bit-equal
multi-window runs and modeled metrics, across a CN crash and with SCAN."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core import simnet as jsim  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.workloads import ycsb as jycsb  # noqa: E402
from repro.workloads import zipf as jzipf  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import runner as trun  # noqa: E402
from repro_torch.core import simnet as tsim  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.credits import credit_init as t_credit_init  # noqa: E402
from repro_torch.workloads import ycsb as tycsb  # noqa: E402
from repro_torch.workloads import zipf as tzipf  # noqa: E402

MODES = list(jtypes.SyncMode)


def assert_fields_equal(ref, port, what=""):
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(port, f.name).numpy()
        assert a.dtype == b.dtype, (what, f.name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f.name)


def modeled(runner, p, cfg, kinds, res, io, n_ops, counts=None):
    """The benchmark row: verb bill + modeled throughput and latency."""
    d = io.as_dict()
    d.update(runner.modeled_throughput(io, p, n_ops=n_ops))
    lat = runner.modeled_latency(cfg, kinds, res, p, scan_counts=counts)
    d.update({f"modeled_{k}": v
              for k, v in runner.latency_stats(lat).as_dict().items()})
    return d


# ---------------------------------------------------------------------------
# types, constants, workloads
# ---------------------------------------------------------------------------

def test_vocabulary_and_configs_match():
    for name in ("OpKind", "Verb", "SyncMode"):
        ref, port = getattr(jtypes, name), getattr(ttypes, name)
        assert {m.name: int(m) for m in ref} == {m.name: int(m) for m in port}
    jf = {f.name: f.default for f in dataclasses.fields(jtypes.EngineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttypes.EngineConfig)}
    assert jf == tf
    assert dataclasses.asdict(jsim.SimParams()) == dataclasses.asdict(
        tsim.SimParams())
    assert ([f.name for f in dataclasses.fields(jtypes.IOMetrics)]
            == [f.name for f in dataclasses.fields(ttypes.IOMetrics)])
    with pytest.raises(ValueError, match="kernel backend"):
        ttypes.EngineConfig(n_slots=4, heap_slots=4, kernel_backend="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttypes.as_device("cuda")


def test_opbatch_make_and_io_helpers():
    rng = np.random.default_rng(0)
    kinds, keys, vals = (rng.integers(0, 5, 37), rng.integers(0, 9, 37),
                         rng.integers(0, 99, 37))
    for n_cns, lpc in ((1, None), (4, None), (3, 5)):
        assert_fields_equal(
            jtypes.OpBatch.make(kinds, keys, vals, n_cns, lpc),
            ttypes.OpBatch.make(kinds, keys, vals, n_cns, lpc, device="cpu"))
    z = ttypes.io_zeros("cpu")
    one = ttypes.IOMetrics(*(torch.tensor(i + 1, dtype=torch.int32)
                             for i in range(11)))
    two = ttypes.io_add(one, ttypes.io_add(z, one))
    assert two.as_dict()["mn_iops"] == 2 * (1 + 2 + 3 + 4)
    assert two.reads.dtype == torch.int32
    jone = jtypes.IOMetrics(*(jnp.int32(i + 1) for i in range(11)))
    jtwo = jtypes.io_add(jone, jone)
    for r in (1, 3):
        jr = jtypes.IOMetrics(*(jnp.int32(v) for v in
                                (1, 2 * r, 3 * r, 4 * r, 5, 6 + 6 * (r - 1),
                                 7 * r, 8, 9, 10 * r, 11)))
        tr = ttypes.IOMetrics(*(torch.tensor(int(getattr(jr, f.name)))
                                for f in dataclasses.fields(jr)))
        assert (jtypes.per_replica_bill(jone, jr, r)
                == ttypes.per_replica_bill(one, tr, r))
    with pytest.raises(ValueError):
        ttypes.per_replica_bill(one, two, 2)
    with pytest.raises(ValueError):
        jtypes.per_replica_bill(jone, jtwo, 2)


def test_zipf_and_scramble_identical():
    ids = np.arange(0, 100_000, 7)
    assert np.array_equal(jzipf.scramble(ids, 12345), tzipf.scramble(ids, 12345))
    for theta, scrambled in ((0.99, True), (0.99, False), (0.5, True),
                             (0.0, True)):
        a = jzipf.ZipfSampler(50_000, theta, seed=3).sample(4096, scrambled)
        b = tzipf.ZipfSampler(50_000, theta, seed=3).sample(4096, scrambled)
        assert np.array_equal(a, b)
    for n, theta, head in ((100, 0.99, 64), (10**6, 0.8, 8192), (10, 1.0, 4)):
        assert np.array_equal(jzipf.zipf_cdf_table(n, theta, head),
                              tzipf.zipf_cdf_table(n, theta, head))


def _ops_equal(a, b):
    for f in ("kinds", "keys", "values", "clients"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", ["A", "B", "C", "D", "E", "F"])
def test_ycsb_streams_identical(name):
    _ops_equal(jycsb.generate_ycsb_stream(jycsb.YCSB[name], 3, 512, 2048, 64,
                                          seed=7),
               tycsb.generate_ycsb_stream(tycsb.YCSB[name], 3, 512, 2048, 64,
                                          seed=7))


@pytest.mark.parametrize("name", ["write-intensive", "read-intensive",
                                  "write-only"])
def test_window_streams_identical(name):
    _ops_equal(jycsb.generate_window_stream(jycsb.WORKLOADS[name], 3, 1024,
                                            4096, 64, seed=2),
               tycsb.generate_window_stream(tycsb.WORKLOADS[name], 3, 1024,
                                            4096, 64, seed=2))
    spec = dataclasses.replace(jycsb.WORKLOADS[name], insert_fraction=0.2,
                               delete_fraction=0.1)
    tspec = tycsb.WorkloadSpec(**dataclasses.asdict(spec))
    _ops_equal(jycsb.generate_ops(spec, 999, 512, 8, seed=4),
               tycsb.generate_ops(tspec, 999, 512, 8, seed=4))


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def _crash_stream(w, b, n_cns, n_keys, seed, scan=False):
    spec = jycsb.YCSB["E" if scan else "A"]
    ops = jycsb.generate_ycsb_stream(spec, w, b, n_keys, 64, seed=seed)
    alive = np.ones((w, n_cns), bool)
    alive[2:, 1] = False                     # CN 1 dies at window 2
    valid = np.random.default_rng(seed).random((w, b)) < 0.97
    return ops, alive, valid


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("scan", [False, True])
def test_run_windows_matches_reference(mode, scan):
    w, b, n_cns, n_keys = 5, 256, 8, 512
    ops, alive, valid = _crash_stream(w, b, n_cns, n_keys, seed=5, scan=scan)
    kw = dict(n_slots=n_keys + w * b, heap_slots=n_keys + 2 * w * b,
              mode=mode, scan_max=16 if scan else 0)
    jcfg, tcfg = jtypes.EngineConfig(**kw), ttypes.EngineConfig(**kw)
    pk = np.arange(n_keys)
    args = (ops.kinds, ops.keys, ops.values, n_cns)
    jstream = jrun.make_stream(*args, valid=valid, alive=alive)
    tstream = trun.make_stream(*args, valid=valid, alive=alive, device="cpu")
    assert_fields_equal(jstream.batch, tstream.batch, "stream")
    for f in ("valid", "alive"):
        assert np.array_equal(np.asarray(getattr(jstream, f)),
                              getattr(tstream, f).numpy())

    def fresh(eng, cfg, credit_init, dev=()):
        st = eng.populate(cfg, eng.store_init(cfg, *dev), pk, pk)
        return st, credit_init(256, *dev)

    js, jc, jr, jio, jmass = jrun.run_windows_traced(
        jcfg, *fresh(jeng, jcfg, j_credit_init), jstream)
    ts, tc, tr, tio, tmass = trun.run_windows_traced(
        tcfg, *fresh(teng, tcfg, t_credit_init, ("cpu",)), tstream)
    for what, a, c in (("results", jr, tr), ("io", jio, tio),
                       ("state", js, ts), ("credits", jc, tc)):
        assert_fields_equal(a, c, what)
    assert np.array_equal(np.asarray(jmass), tmass.numpy())
    assert_fields_equal(jrun.io_window(jio, 3), trun.io_window(tio, 3), "w3")
    # summed bill (int32, as the reference's scan sums it) and the modeled
    # metrics, to the last digit
    jsum = jtypes.IOMetrics(*(jnp.sum(getattr(jio, f.name), axis=0)
                              for f in dataclasses.fields(jio)))
    _, _, _, tsum = trun.run_windows(
        tcfg, *fresh(teng, tcfg, t_credit_init, ("cpu",)), tstream)
    assert_fields_equal(jsum, tsum, "summed io")
    counts = np.where(ops.kinds == 5, ops.values, 0)
    for reps in (1, 2):
        p_ref, p_port = (jsim.SimParams(n_replicas=reps),
                         tsim.SimParams(n_replicas=reps))
        assert (jrun.modeled_throughput(jsum, p_ref, w * b)
                == trun.modeled_throughput(tsum, p_port, w * b))
        lj = jrun.modeled_latency(jcfg, ops.kinds, jr, p_ref, valid=valid,
                                  scan_counts=counts)
        lt = trun.modeled_latency(tcfg, ops.kinds, tr, p_port, valid=valid,
                                  scan_counts=counts)
        assert np.array_equal(lj, lt, equal_nan=True)
        assert (jrun.latency_stats(lj).as_dict()
                == trun.latency_stats(lt).as_dict())
    assert trun.latency_stats(np.full(3, np.nan)).n_ops == 0


def test_make_stream_options_and_errors():
    kinds = np.zeros((2, 8), np.int32)
    cn = np.arange(16, dtype=np.int32).reshape(2, 8) % 3
    js = jrun.make_stream(kinds, kinds, kinds, n_cns=3, cn=cn)
    ts = trun.make_stream(kinds, kinds, kinds, n_cns=3, cn=cn, device="cpu")
    assert_fields_equal(js.batch, ts.batch)
    assert ts.shape == (2, 8)
    with pytest.raises(ValueError, match="cn plane"):
        trun.make_stream(kinds, kinds, kinds, cn=cn[:1], device="cpu")
    with pytest.raises(ValueError, match="liveness"):
        trun.make_stream(kinds, kinds, kinds, n_cns=2,
                         alive=np.ones((2, 3), bool), device="cpu")
