"""The port's open-loop slice against the JAX reference (CPU): Poisson and
MMPP streams, ``dense_repack`` and ``open_loop_latency`` give identical
arrays; ``OpenLoopSpec`` rejects the same specs; and ``chip_smoke.py``'s
open-loop rows (curves, MMPP row, dense re-pack identity on one device)
equal the reference's single-device run of ``benchmarks/scale.py``'s
open-loop recipe at its FAST size."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jeng  # noqa: E402
from repro.core import runner as jrun  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.simnet import SimParams as JSimParams  # noqa: E402
from repro.core.types import EngineConfig as JConfig  # noqa: E402
from repro.core.types import SyncMode  # noqa: E402
from repro.workloads import openloop as jol  # noqa: E402
from repro.workloads import ycsb as jycsb  # noqa: E402
from repro_torch.core.types import SyncMode as TSyncMode  # noqa: E402
from repro_torch.workloads import openloop as tol  # noqa: E402
from repro_torch.workloads import ycsb as tycsb  # noqa: E402
from test_torch_recovery import load_smoke  # noqa: E402
from test_torch_runner import assert_fields_equal  # noqa: E402

# benchmarks/scale.py's FAST open-loop problem: a 2-way mesh's unit problem
FAST = dict(slots1=4096, lanes1=256, cns1=32, windows=8, warmup=4,
            theta=0.99, seed=11, ol_mesh=2, ol_windows=8,
            rhos=[0.6, 0.9, 1.05], mmpp_rho=0.9)
WINDOW_US = 250.0
SPECS = [dict(), dict(rho=1.3, windows=12, n_cns=3, lanes_per_cn=16),
         dict(arrival="mmpp", rho=0.8, seed=5),
         dict(arrival="mmpp", burst_mult=7.0, p_enter_burst=0.3,
              p_exit_burst=0.1, rho=0.5),
         dict(mix="read-intensive", theta=0.5, rho=0.95, seed=3)]
FIELDS = ("kinds", "keys", "values", "cn", "valid", "delay_windows",
          "arrivals", "phases", "backlog_end")


def _specs(kw):
    kw = dict(kw)
    mix = kw.pop("mix", "write-intensive")
    return (jol.OpenLoopSpec(mix=jycsb.WORKLOADS[mix], **kw),
            tol.OpenLoopSpec(mix=tycsb.WORKLOADS[mix], **kw))


def _same_stream(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.offered, a.delivered) == (b.offered, b.delivered)


@pytest.mark.parametrize("kw", SPECS, ids=[f"spec{i}" for i in range(len(SPECS))])
def test_streams_repack_and_latency_identical(kw):
    js, ts = _specs(kw)
    a, b = jol.generate_openloop_stream(js), tol.generate_openloop_stream(ts)
    _same_stream(a, b)
    ra, rb = jol.dense_repack(a), tol.dense_repack(b)
    _same_stream(ra, rb)
    assert np.array_equal(ra.order, rb.order)
    lat = np.random.default_rng(1).random(a.valid.shape) * 300
    lat[~a.valid] = np.nan
    for ol_a, ol_b in ((a, b), (ra, rb)):
        x = jol.open_loop_latency(ol_a, lat, 123.5)
        y = tol.open_loop_latency(ol_b, lat, 123.5)
        assert np.array_equal(x, y, equal_nan=True)


def test_spec_validation_matches():
    for mod in (jol, tol):
        with pytest.raises(ValueError, match="arrival"):
            mod.OpenLoopSpec(arrival="bursty")
        with pytest.raises(ValueError, match="rho"):
            mod.OpenLoopSpec(rho=0.0)
        with pytest.raises(ValueError, match="rho"):
            mod.OpenLoopSpec(rho=-1.0)
    assert (dataclasses.asdict(jol.OpenLoopSpec(mix=jycsb.WORKLOADS[
        "write-intensive"])) == dataclasses.asdict(tol.OpenLoopSpec()))


def _reference_rows(c: dict, window_us: float) -> dict:
    """``benchmarks/scale.py::_open_loop`` through the reference's
    single-device ``run_windows`` (its sharded path equals it by contract)."""
    n = c["ol_mesh"]
    n_slots, n_cns = c["slots1"] * n, c["cns1"] * n
    lanes = c["lanes1"] // c["cns1"]
    heap = n_slots + c["ol_windows"] * n_cns * lanes
    heap += -heap % n
    spec = jycsb.WORKLOADS["write-intensive"]
    pk = np.arange(n_slots)

    def run_mode(mode, ol):
        cfg = JConfig(n_slots=n_slots, heap_slots=heap, mode=mode)
        st = jeng.populate(cfg, jeng.store_init(cfg), pk, pk)
        stream = jrun.make_stream(ol.kinds, ol.keys % n_slots, ol.values,
                                  n_cns=n_cns, lanes_per_cn=lanes,
                                  valid=ol.valid, cn=ol.cn)
        st, cr, res, io = jrun.run_windows(cfg, st, j_credit_init(n_slots),
                                           stream)
        lat = jrun.modeled_latency(cfg, ol.kinds, res, JSimParams(),
                                   valid=ol.valid)
        stats = jrun.latency_stats(jol.open_loop_latency(ol, lat, window_us))
        return {"p50_us": stats.p50_us, "p99_us": stats.p99_us,
                "offered": ol.offered, "delivered": ol.delivered,
                "mean_delay_windows": round(
                    float(ol.delay_windows[ol.valid].mean()), 3)
                if ol.delivered else 0.0}

    def stream(rho, seed, arrival="poisson"):
        return jol.generate_openloop_stream(jol.OpenLoopSpec(
            n_cns=n_cns, lanes_per_cn=lanes, windows=c["ol_windows"],
            rho=rho, n_keys=n_slots, mix=spec, theta=c["theta"],
            arrival=arrival, seed=seed))

    out = {"curves": {m.name: [] for m in SyncMode}, "mmpp": {}}
    for rho in c["rhos"]:
        ol = stream(rho, c["seed"] + int(rho * 100))
        for mode in SyncMode:
            out["curves"][mode.name].append({"rho": rho,
                                             **run_mode(mode, ol)})
    olm = stream(c["mmpp_rho"], c["seed"] + 5000, "mmpp")
    for mode in SyncMode:
        out["mmpp"][mode.name] = {"rho": c["mmpp_rho"], **run_mode(mode, olm),
                                  "burst_windows_frac": round(
                                      float(olm.phases.mean()), 3)}
    return out


def test_open_loop_rows_match_reference_single_device():
    smoke = load_smoke()
    got = smoke.open_loop_rows("cpu", FAST, WINDOW_US)
    want = _reference_rows(FAST, WINDOW_US)
    assert got["curves"] == want["curves"]
    assert got["mmpp"] == want["mmpp"]
    assert got["dense_repack"]["delivered"] > 0


@pytest.mark.parametrize("mode", [SyncMode.MCS, SyncMode.CIDER],
                         ids=lambda m: m.name)
def test_dense_repack_run_matches_reference(mode):
    """One partially filled stream and its dense re-pack through both
    packages on one device: results, bill, state and credits bit for bit
    (the port's re-pack identity itself is checked inside
    ``open_loop_rows``)."""
    smoke = load_smoke()
    js, ts = _specs(dict(n_cns=8, lanes_per_cn=16, windows=6, rho=0.9,
                         n_keys=512, seed=13))
    ol_j, ol_t = jol.generate_openloop_stream(js), tol.generate_openloop_stream(ts)
    c = dict(slots1=512, lanes1=128, cns1=8, ol_mesh=1, ol_windows=6)
    for a, b in ((ol_j, ol_t), (jol.dense_repack(ol_j), tol.dense_repack(ol_t))):
        cfg = JConfig(n_slots=512, heap_slots=512 + 6 * 128, mode=mode)
        st = jeng.populate(cfg, jeng.store_init(cfg), np.arange(512),
                           np.arange(512))
        jst, jcr, jres, jio = jrun.run_windows(
            cfg, st, j_credit_init(512),
            jrun.make_stream(a.kinds, a.keys % 512, a.values, n_cns=8,
                             lanes_per_cn=16, valid=a.valid, cn=a.cn))
        tcfg, tst, tcr, tres, tio, _ = smoke.open_loop_run(
            "cpu", c, TSyncMode(int(mode)), b, WINDOW_US)
        assert tcfg.heap_slots == cfg.heap_slots
        for x, y, what in ((jst, tst, "state"), (jcr, tcr, "credits"),
                           (jres, tres, "results"), (jio, tio, "io")):
            assert_fields_equal(x, y, what)
