"""The port's stores, interop and the committed benchmark files against
the JAX reference (CPU): the ``engine_json --fast`` stream path through
``PointerArray``, ``SmartART`` SCAN streams, heap compaction and the oracle,
a run that switches from the reference to the port at a window boundary,
and ``BENCH_engine.json`` / ``BENCH_ycsb.json`` single rows reproduced by
the port alone."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core import simnet as jsim  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.oracle import OracleStore as JOracle  # noqa: E402
from repro.stores import PointerArray as JPointerArray  # noqa: E402
from repro.stores import SmartART as JSmartART  # noqa: E402
from repro.stores.heap import reclaim as j_reclaim  # noqa: E402
from repro.workloads import ycsb as jycsb  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import runner as trun  # noqa: E402
from repro_torch.core import simnet as tsim  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.credits import credit_init as t_credit_init  # noqa: E402
from repro_torch.core.oracle import OracleStore as TOracle  # noqa: E402
from repro_torch.stores import PointerArray as TPointerArray  # noqa: E402
from repro_torch.stores import SmartART as TSmartART  # noqa: E402
from repro_torch.stores.heap import reclaim as t_reclaim  # noqa: E402
from repro_torch.workloads import ycsb as tycsb  # noqa: E402
from test_torch_runner import (_crash_stream, assert_fields_equal,  # noqa: E402
                               modeled)

ROOT = Path(__file__).resolve().parents[1]
MODES = list(jtypes.SyncMode)


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_engine_json_fast_end_to_end(mode):
    """``benchmarks/run.py --only engine_json --fast`` through both
    packages: the PointerArray stream path, bill and modeled metrics."""
    n_slots, b, windows = 4096, 1024, 4
    spec = jycsb.WORKLOADS["write-intensive"]
    ops = jycsb.generate_window_stream(spec, windows, b, n_slots, b)
    keys = ops.keys % n_slots
    pk = np.arange(n_slots)
    jpa = JPointerArray.create(n_slots, mode=mode).populate(pk, pk)
    tpa = TPointerArray.create(n_slots, mode=mode, device="cpu").populate(pk,
                                                                          pk)
    jpa, jr, jio = jpa.apply_stream(jrun.make_stream(ops.kinds, keys,
                                                     ops.values, n_cns=16))
    tpa, tr, tio = tpa.apply_stream(trun.make_stream(ops.kinds, keys,
                                                     ops.values, n_cns=16,
                                                     device="cpu"))
    assert_fields_equal(jr, tr, "results")
    assert (modeled(jrun, jsim.SimParams(), jpa.cfg, ops.kinds, jr, jio,
                    windows * b)
            == modeled(trun, tsim.SimParams(), tpa.cfg, ops.kinds, tr, tio,
                       windows * b))
    for a, c in zip(jpa.view(), tpa.view()):
        assert np.array_equal(np.asarray(a), c.numpy())


def test_pointer_array_single_window_and_scan_rejection():
    kinds = np.array([0, 1, 2, 3, 2, 0], np.int32)
    keys = np.array([1, 5, 1, 2, 2, 5], np.int32)
    vals = np.arange(6, dtype=np.int32) + 40
    jpa = JPointerArray.create(8).populate(np.arange(4), np.arange(4))
    tpa = TPointerArray.create(8, device="cpu").populate(np.arange(4),
                                                         np.arange(4))
    jpa, jr, jio = jpa.apply(jtypes.OpBatch.make(kinds, keys, vals, 2))
    tpa, tr, tio = tpa.apply(ttypes.OpBatch.make(kinds, keys, vals, 2,
                                                 device="cpu"))
    assert_fields_equal(jr, tr)
    assert jio.as_dict() == tio.as_dict()
    scan = ttypes.OpBatch.make([5], [1], [3], device="cpu")
    with pytest.raises(ttypes.UnsupportedOpError, match="SmartART"):
        tpa.apply(scan)
    with pytest.raises(ttypes.UnsupportedOpError):
        tpa.apply_stream(trun.make_stream([[5]], [[1]], [[3]], device="cpu"))


@pytest.mark.parametrize("mode", [jtypes.SyncMode.MCS, jtypes.SyncMode.CIDER],
                         ids=lambda m: m.name)
def test_smart_art_scan_streams(mode):
    ops = jycsb.generate_ycsb_stream(jycsb.YCSB["E"], 3, 512, 1000, 64, seed=1)
    keys = np.arange(1000)
    jsa = JSmartART.create(key_bits=11, mode=mode, credit_table=512,
                           scan_max=16).populate(keys, keys * 2)
    tsa = TSmartART.create(key_bits=11, mode=mode, credit_table=512,
                           scan_max=16, device="cpu").populate(keys, keys * 2)
    jsa, jr, jio = jsa.apply_stream(ops.kinds, ops.keys, ops.values, n_cns=8,
                                    io_per_window=True)
    tsa, tr, tio = tsa.apply_stream(ops.kinds, ops.keys, ops.values, n_cns=8,
                                    io_per_window=True)
    assert_fields_equal(jr, tr, "results")
    assert_fields_equal(jio, tio, "io")
    assert int(tr.rows.sum()) > 0
    jsa, jr1, _ = jsa.apply(ops.kinds[0], ops.keys[0], ops.values[0], n_cns=8)
    tsa, tr1, _ = tsa.apply(ops.kinds[0], ops.keys[0], ops.values[0], n_cns=8)
    assert_fields_equal(jr1, tr1, "single window")
    for a, c in zip(jsa.view(), tsa.view()):
        assert np.array_equal(np.asarray(a), c.numpy())


def test_reclaim_and_oracle_match_reference():
    kw = dict(n_slots=64, heap_slots=96, mode=jtypes.SyncMode.CIDER)
    jcfg, tcfg = jtypes.EngineConfig(**kw), ttypes.EngineConfig(**kw)
    pk = np.arange(0, 64, 2)
    js = jeng.populate(jcfg, jeng.store_init(jcfg), pk, pk + 7)
    ts = teng.populate(tcfg, teng.store_init(tcfg, "cpu"), pk, pk + 7)
    rng = np.random.default_rng(9)
    kinds = rng.integers(0, 4, 64).astype(np.int32)
    keys = rng.integers(0, 64, 64).astype(np.int32)
    js, _, _, _ = jeng.apply_batch(jcfg, js, j_credit_init(16),
                                   jtypes.OpBatch.make(kinds, keys, keys))
    ts, _, _, _ = teng.apply_batch(tcfg, ts, t_credit_init(16, "cpu"),
                                   ttypes.OpBatch.make(kinds, keys, keys,
                                                       device="cpu"))
    assert_fields_equal(j_reclaim(js), t_reclaim(ts), "reclaim")
    for a, c in zip(jeng.store_view(j_reclaim(js)),
                    teng.store_view(t_reclaim(ts))):
        assert np.array_equal(np.asarray(a), c.numpy())
    jo, to = JOracle(), TOracle()
    for o in (jo, to):
        o.populate(pk, pk)
    kinds_s = np.where(rng.random(64) < 0.2, 5, kinds)
    for a, c in zip(jo.apply(kinds_s, keys, keys % 9, scan_max=4),
                    to.apply(kinds_s, keys, keys % 9, scan_max=4)):
        assert np.array_equal(a, c)
    assert np.array_equal(jo.rows, to.rows)
    for a, c in zip(jo.view(64), to.view(64)):
        assert np.array_equal(a, c)


# ---------------------------------------------------------------------------
# interop: switch implementations at a window boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_interop_two_reference_then_two_port_windows(mode):
    w, b, n_cns, n_keys = 4, 256, 8, 512
    ops, alive, valid = _crash_stream(w, b, n_cns, n_keys, seed=6, scan=True)
    kw = dict(n_slots=n_keys + w * b, heap_slots=n_keys + 2 * w * b,
              mode=mode, scan_max=16)
    jcfg, tcfg = jtypes.EngineConfig(**kw), ttypes.EngineConfig(**kw)
    pk = np.arange(n_keys)

    def jstream(sl):
        return jrun.make_stream(ops.kinds[sl], ops.keys[sl], ops.values[sl],
                                n_cns, valid=valid[sl], alive=alive[sl])

    def jfresh():
        return jeng.populate(jcfg, jeng.store_init(jcfg), pk, pk), \
            j_credit_init(256)

    # four reference windows
    js4, jc4, jr4, jio4 = jrun.run_windows(jcfg, *jfresh(), jstream(slice(0, 4)),
                                           io_per_window=True)
    # two reference windows, then the port
    js2, jc2, _, _ = jrun.run_windows(jcfg, *jfresh(), jstream(slice(0, 2)))
    sd = interop.state_to_numpy(interop.state_from_numpy(
        **{f.name: np.asarray(getattr(js2, f.name))
           for f in dataclasses.fields(js2)}, device="cpu"))
    ts = interop.state_from_numpy(**sd, device="cpu")
    tc = interop.credits_from_numpy(np.asarray(jc2.credit),
                                    np.asarray(jc2.retry_record), device="cpu")
    tstream = trun.make_stream(ops.kinds[2:], ops.keys[2:], ops.values[2:],
                               n_cns, valid=valid[2:], alive=alive[2:],
                               device="cpu")
    ts, tc, tr, tio = trun.run_windows(tcfg, ts, tc, tstream,
                                       io_per_window=True,
                                       prev_alive=alive[1])
    assert_fields_equal(js4, ts, "state")
    assert_fields_equal(jc4, tc, "credits")
    for f in dataclasses.fields(jr4):
        assert np.array_equal(np.asarray(getattr(jr4, f.name))[2:],
                              getattr(tr, f.name).numpy()), f.name
    for f in dataclasses.fields(jio4):
        assert np.array_equal(np.asarray(getattr(jio4, f.name))[2:],
                              getattr(tio, f.name).numpy()), f.name
    # and back: the port's state rebuilds a reference state
    back = jeng.StoreState(**{k: jnp.asarray(v) for k, v in
                              interop.state_to_numpy(ts).items()})
    assert_fields_equal(back, ts, "round trip")
    cd = interop.credits_to_numpy(tc)
    assert np.array_equal(cd["credit"], np.asarray(jc4.credit))


# ---------------------------------------------------------------------------
# the committed benchmark files, reproduced by the port alone
# ---------------------------------------------------------------------------

def test_port_reproduces_bench_engine_json():
    ref = json.loads((ROOT / "BENCH_engine.json").read_text())
    c = ref["config"]
    n_slots, b, windows = c["n_slots"], c["batch"], c["windows"]
    ops = tycsb.generate_window_stream(tycsb.WORKLOADS[c["workload"]],
                                       windows, b, n_slots, b)
    stream = trun.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                              n_cns=c["n_cns"], device="cpu")
    pk = np.arange(n_slots)
    for mode in ttypes.SyncMode:
        pa = TPointerArray.create(n_slots, mode=mode, device="cpu").populate(
            pk, pk)
        pa, res, io = pa.apply_stream(stream)
        d = modeled(trun, tsim.SimParams(), pa.cfg, ops.kinds, res, io,
                    windows * b)
        for k, v in ref[mode.name].items():
            if k not in ("throughput_mops", "wall_s"):   # CPU wall-clock
                assert d[k] == v, (mode.name, k)


def test_port_reproduces_bench_ycsb_single_rows():
    ref = json.loads((ROOT / "BENCH_ycsb.json").read_text())
    c = ref["config"]
    p = tsim.SimParams()
    pk = np.arange(c["n_keys"])
    for name, spec in tycsb.YCSB.items():
        ops = tycsb.generate_ycsb_stream(spec, c["windows"], c["batch"],
                                         c["n_keys"], c["n_clients"],
                                         seed=c["seed"])
        stream = trun.make_stream(ops.kinds, ops.keys, ops.values,
                                  n_cns=c["n_cns"], device="cpu")
        counts = np.where(ops.kinds == ttypes.OpKind.SCAN, ops.values, 0)
        upd = ops.kinds == ttypes.OpKind.UPDATE
        for mode in ttypes.SyncMode:
            cfg = ttypes.EngineConfig(
                n_slots=c["n_slots"], heap_slots=c["heap_slots"], mode=mode,
                scan_max=c["scan_max"] if spec.scan > 0 else 0)
            st = teng.populate(cfg, teng.store_init(cfg, "cpu"), pk, pk)
            _, _, res, io = trun.run_windows(
                cfg, st, t_credit_init(c["credit_table"], "cpu"), stream)
            d = modeled(trun, p, cfg, ops.kinds, res, io, ops.kinds.size,
                        counts)
            d["rows"] = int(res.rows.sum())
            d["pess_ratio"] = round(float(
                (res.pessimistic.numpy() & upd).sum() / max(int(upd.sum()), 1)),
                4)
            assert d == ref["workloads"][name]["single"][mode.name], \
                (name, mode.name)
