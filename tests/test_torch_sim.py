"""The port's protocol simulator (``repro_torch.core.{simnet,protocol,sim}``)
against the JAX reference on the CPU, integers equal with no tolerance:
the op streams, ``issue_mn``, one tick from the reference's state after k
ticks, and a built tick in which two lanes of one CN set the same
retry-record slot.  Whole runs are in ``test_torch_sim_runs.py``."""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import protocol as jproto  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core import simnet as jnet  # noqa: E402
from repro.core.types import SyncMode as JSyncMode  # noqa: E402
from repro.workloads.ycsb import WORKLOADS as JWORKLOADS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import simnet as tnet  # noqa: E402
from repro_torch.core.types import SyncMode  # noqa: E402
from repro_torch.workloads.ycsb import WORKLOADS  # noqa: E402

MODES = ("OSYNC", "SPIN", "MCS", "CIDER")
SMALL = dict(n_lanes=64, max_ops=128, h_bits=8, hc_bits=6, hl_bits=6)


def j_state_np(s) -> dict:
    """The reference's ``SimState`` as the dict ``interop`` carries."""
    out = {f.name: np.asarray(getattr(s, f.name))
           for f in dataclasses.fields(s) if f.name != "net"}
    out["net"] = {g.name: np.asarray(getattr(s.net, g.name))
                  for g in dataclasses.fields(s.net)}
    return out


def j_state(d: dict):
    """The dict back as the reference's ``SimState``."""
    fields = {k: jnp.asarray(v, jnp.int32) for k, v in d.items()
              if k != "net"}
    fields["net"] = jnet.NetState(**{k: jnp.asarray(v, jnp.int32)
                                     for k, v in d["net"].items()})
    return jproto.SimState(**fields)


def assert_states_equal(want: dict, got: dict, what: str = "") -> None:
    for name, w in want.items():
        if name == "net":
            assert_states_equal(w, got["net"], f"{what}net.")
            continue
        g = got[name]
        assert g.dtype == np.int32 and w.shape == g.shape, (what + name)
        if not np.array_equal(w, g):
            i = np.flatnonzero(np.asarray(w != g).reshape(-1))[0]
            raise AssertionError(f"{what}{name} differs first at flat index "
                                 f"{i}: reference {w.reshape(-1)[i]}, port "
                                 f"{g.reshape(-1)[i]}")


def streams_pair(kw: dict, workload="write-intensive", n_keys=1000, seed=0,
                 theta=None):
    jp, tp = jnet.SimParams(**kw), tnet.SimParams(**kw)
    js = jsim.make_streams(jp, JWORKLOADS[workload], n_keys, theta=theta,
                           seed=seed)
    ts = tsim.make_streams(tp, WORKLOADS[workload], n_keys, theta=theta,
                           seed=seed, device="cpu")
    return jp, tp, js, ts


@pytest.mark.parametrize("workload,n_keys,theta,seed", [
    ("write-intensive", 1_000_000, None, 0),
    ("read-intensive", 1000, 0.5, 3),
    ("write-only", 1, None, 0)])
def test_make_streams_equal(workload, n_keys, theta, seed):
    kw = dict(n_lanes=96, max_ops=64, h_bits=10, hc_bits=7, hl_bits=5)
    _, _, js, ts = streams_pair(kw, workload, n_keys, seed, theta)
    assert sorted(js) == sorted(ts)
    for name in js:
        t = ts[name]
        assert t.dtype == torch.int32 and t.is_contiguous()
        np.testing.assert_array_equal(np.asarray(js[name]), t.numpy(),
                                      err_msg=name)


def test_make_streams_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.make_streams(tnet.SimParams(n_lanes=4, max_ops=4),
                          WORKLOADS["write-only"], 10)


@pytest.mark.parametrize("backlog,byte_backlog,addr_hi", [
    (0, 0, 0), (37, 5, 3), (1000, 40_000, 9), (70_000, 3_000_000, 200)])
@pytest.mark.parametrize("seed", [0, 1])
def test_issue_mn_equal(backlog, byte_backlog, addr_hi, seed):
    rng = np.random.default_rng(seed * 7 + backlog)
    n, h = 256, 64
    issue = rng.random(n) < 0.6
    nbytes = rng.integers(8, 64, n).astype(np.int32)
    cost = rng.integers(1, 4, n).astype(np.int32)
    atomic = rng.random(n) < 0.5
    hkey = rng.integers(0, 6, n).astype(np.int32) * 7   # hot addresses
    addr = rng.integers(0, addr_hi + 1, h).astype(np.int32)
    t = 123
    p = dict(mn_cap=32, mn_bw=12500, addr_atomic_cap=2, rtt=2)
    jn = jnet.NetState(backlog=jnp.int32(backlog),
                       byte_backlog=jnp.int32(byte_backlog),
                       addr_backlog=jnp.asarray(addr))
    jnet2, jdone = jnet.issue_mn(jn, jnp.int32(t), jnp.asarray(issue),
                                 jnp.asarray(nbytes), jnp.asarray(cost),
                                 jnp.asarray(atomic), jnp.asarray(hkey),
                                 jnet.SimParams(**p))
    tn = tnet.NetState(backlog=torch.tensor(backlog, dtype=torch.int32),
                       byte_backlog=torch.tensor(byte_backlog,
                                                 dtype=torch.int32),
                       addr_backlog=torch.from_numpy(addr))
    tnet2, tdone = tnet.issue_mn(
        tn, torch.tensor(t, dtype=torch.int32), torch.from_numpy(issue),
        torch.from_numpy(nbytes), torch.from_numpy(cost),
        torch.from_numpy(atomic), torch.from_numpy(hkey),
        tnet.SimParams(**p))
    assert tdone.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
    for g in ("backlog", "byte_backlog", "addr_backlog"):
        w, got = np.asarray(getattr(jnet2, g)), getattr(tnet2, g)
        assert got.dtype == torch.int32 and tuple(got.shape) == w.shape
        np.testing.assert_array_equal(w, got.numpy(), err_msg=g)


def test_net_init_shapes():
    net = tnet.net_init(32, "cpu")
    assert net.backlog.shape == () and net.addr_backlog.shape == (32,)
    assert all(getattr(net, g.name).dtype == torch.int32
               for g in dataclasses.fields(net))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant,k", [
    ("default", 100), ("default", 333), ("local_wc_off", 250),
    ("crash", 700)])
def test_one_tick_from_reference_state(mode, variant, k):
    kw = dict(SMALL, ticks=k)
    if variant == "local_wc_off":
        kw["local_wc"] = False
    if variant == "crash":
        kw.update(fail_lanes=(3, 5, 9), fail_tick=600, max_wait=40)
    jp, tp, js, ts = streams_pair(kw, "write-only", 3)
    jmode, tmode = JSyncMode[mode], SyncMode[mode]
    before = jsim._run(jp, jmode, js, jnp.int32(48))
    want = jproto.tick(jp, jmode, js, before, jnp.int32(k))
    port = interop.sim_state_from_numpy(j_state_np(before), "cpu")
    got = tproto.tick(tp, tmode, ts, port, torch.tensor(k, dtype=torch.int32))
    assert_states_equal(j_state_np(want), interop.sim_state_to_numpy(got),
                        f"{mode} {variant} tick {k}: ")


def test_sim_state_round_trip():
    kw = dict(SMALL, ticks=20)
    jp, tp, js, ts = streams_pair(kw)
    d = j_state_np(jsim._run(jp, JSyncMode.CIDER, js, jnp.int32(20)))
    back = interop.sim_state_to_numpy(interop.sim_state_from_numpy(d, "cpu"))
    assert_states_equal(d, back)
    assert_states_equal(j_state_np(jproto.sim_init(jp, js)),
                        interop.sim_state_to_numpy(tproto.sim_init(tp, ts)))


def _two_lanes_one_rrec_slot(att0: int, att1: int) -> dict:
    """A CIDER state at tick 10 in which lanes 0 and 1 (one CN) both win an
    optimistic CAS on different keys that share the credit-table slot 5,
    with ``att0`` and ``att1`` failed attempts behind them."""
    kw = dict(n_lanes=4, lanes_per_cn=2, max_ops=4, ticks=1, h_bits=4,
              hc_bits=3, hl_bits=3)
    jp, tp = jnet.SimParams(**kw), tnet.SimParams(**kw)
    streams = {"kinds": np.full((4, 4), 2, np.int32),      # UPDATE
               "hkey": np.array([[1] * 4, [2] * 4, [3] * 4, [4] * 4],
                                np.int32),
               "hc": np.full((4, 4), 5, np.int32),
               "hl": np.zeros((4, 4), np.int32)}
    d = j_state_np(jproto.sim_init(jp, {k: jnp.asarray(v)
                                        for k, v in streams.items()}))
    d["phase"] = np.array([tproto.OCAS, tproto.OCAS, tproto.THINK,
                           tproto.THINK], np.int32)
    d["ready"] = np.array([10, 10, 99, 99], np.int32)
    d["att"] = np.array([att0, att1, 0, 0], np.int32)
    return jp, tp, streams, d


@pytest.mark.parametrize("att0,att1", [(3, 5), (5, 3), (4, 4)])
def test_two_lanes_of_one_cn_set_one_rrec_slot(att0, att1):
    """``rrec.at[ci].set(att)`` with two writers of one slot in one tick:
    the reference applies the updates in lane order, so lane 1's value
    stays; the port's ``_set_at`` keeps the same lane on any device."""
    jp, tp, streams, d = _two_lanes_one_rrec_slot(att0, att1)
    want = jproto.tick(jp, JSyncMode.CIDER,
                       {k: jnp.asarray(v) for k, v in streams.items()},
                       j_state(d), jnp.int32(10))
    got = tproto.tick(tp, SyncMode.CIDER,
                      {k: torch.from_numpy(v) for k, v in streams.items()},
                      interop.sim_state_from_numpy(d, "cpu"),
                      torch.tensor(10, dtype=torch.int32))
    wn, gn = j_state_np(want), interop.sim_state_to_numpy(got)
    assert int(wn["done_w"]) == 2        # both lanes finished this tick
    assert int(wn["rrec"][5]) == att1    # CN 0's slot 5: the last lane's
    assert_states_equal(wn, gn)


def test_set_at_keeps_the_last_lane():
    table = torch.arange(6, dtype=torch.int32)
    ids = torch.arange(5, dtype=torch.int32)
    idx = torch.tensor([1, 1, 4, 1, 4], dtype=torch.int32)
    mask = torch.tensor([True, True, True, False, False])
    val = torch.tensor([50, 70, 30, 90, 10], dtype=torch.int32)
    got = tproto._set_at(table, idx, mask, val, ids)
    want = jnp.arange(6, dtype=jnp.int32).at[
        jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(idx.numpy()), 6)
    ].set(jnp.asarray(val.numpy()), mode="drop")
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(got.numpy(), [0, 70, 2, 3, 30, 5])


class _SetCensus:
    """Wraps ``protocol._set_at``: per calling line, whether any slot was
    set by two lanes with different values in one call."""

    def __init__(self):
        self.calls: dict[int, int] = {}
        self.conflicts: dict[int, int] = {}
        self.inner = tproto._set_at

    def __call__(self, table, idx, mask, val, ids):
        line = sys._getframe(1).f_lineno
        self.calls[line] = self.calls.get(line, 0) + 1
        if not isinstance(val, int) and val.dim() == 1:
            m = mask.numpy()
            slots, vals = idx.numpy()[m], val.numpy()[m]
            for sl in np.unique(slots):
                if len(np.unique(vals[slots == sl])) > 1:
                    self.conflicts[line] = self.conflicts.get(line, 0) + 1
                    break
        return self.inner(table, idx, mask, val, ids)


def test_only_rrec_sees_two_values_in_one_slot(monkeypatch):
    """Every ``set`` scatter of the tick but the retry record writes one
    value per slot in practice (the lock holder is unique; ``newc`` is one
    value per slot), shown on contended runs of every mode, crashes and
    repairs included; the retry record does see two values in a slot."""
    census = _SetCensus()
    monkeypatch.setattr(tproto, "_set_at", census)
    src = open(tproto.__file__).read().splitlines()
    for mode in MODES:
        for kw, wl, keys in (
                (dict(SMALL, ticks=400, lanes_per_cn=8), "write-only", 4),
                (dict(SMALL, ticks=400, lanes_per_cn=16, hc_bits=1),
                 "write-intensive", 16),
                (dict(SMALL, ticks=900, lanes_per_cn=1, local_wc=False,
                      fail_lanes=(3, 5, 9), fail_tick=300, max_wait=64),
                 "write-only", 1)):
            tp = tnet.SimParams(**kw)
            ts = tsim.make_streams(tp, WORKLOADS[wl], keys, device="cpu")
            tsim._run(tp, SyncMode[mode], ts, 48)
    where = {src[line - 1].strip(): n for line, n in census.conflicts.items()}
    assert set(where) <= {"rrec = _set_at(s.rrec, ci, fin_opt, att, ids)"}, \
        where
    assert where, "no run set one retry-record slot twice in a tick"
    assert len(census.calls) >= 8
