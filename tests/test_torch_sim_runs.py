"""Whole runs of the port's protocol simulator against the JAX reference on
the CPU: the final ``SimState`` (every field, ``net`` included) and the
``SimResult`` equal, integers with no tolerance, for the four modes x the
factor-analysis, replication and crash variants, at a reduced size (64
lanes, 2^8 key slots, 2^6 credit and local-WC slots, 512-768 ticks)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sim as jsim  # noqa: E402
from repro.core import simnet as jnet  # noqa: E402
from repro.core.types import SyncMode as JSyncMode  # noqa: E402
from repro.workloads.ycsb import WORKLOADS as JWORKLOADS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import simnet as tnet  # noqa: E402
from repro_torch.core.types import SyncMode  # noqa: E402
from repro_torch.workloads.ycsb import WORKLOADS  # noqa: E402

from test_torch_sim import assert_states_equal, j_state_np  # noqa: E402

MODES = ("OSYNC", "SPIN", "MCS", "CIDER")
SMALL = dict(n_lanes=64, max_ops=128, h_bits=8, hc_bits=6, hl_bits=6)
# variant -> (SimParams overrides, workload, keys, clients)
# (crashes as tests/test_substrates.py runs them: one key, one lane a CN)
CRASH = dict(fail_tick=200, max_wait=64, ticks=768, lanes_per_cn=1,
             local_wc=False)
VARIANTS = {
    "default": (dict(ticks=512), "write-intensive", 1000, 48),
    "local_wc_off": (dict(ticks=512, local_wc=False), "write-intensive",
                     1000, 48),
    "wc_off": (dict(ticks=512, wc_off=True), "write-intensive", 1000, 48),
    "cas_off": (dict(ticks=512, cas_off=True), "write-intensive", 1000, 48),
    "replicas3": (dict(ticks=512, n_replicas=3), "write-intensive", 1000,
                  48),
    "fail_lane": (dict(CRASH, fail_lane=3), "write-only", 1, 16),
    "fail_lanes": (dict(CRASH, fail_lanes=(3, 5, 9)), "write-only", 1, 16),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_whole_run_state_and_result_equal(mode, variant):
    over, workload, n_keys, clients = VARIANTS[variant]
    kw = dict(SMALL, **over)
    jp, tp = jnet.SimParams(**kw), tnet.SimParams(**kw)
    js = jsim.make_streams(jp, JWORKLOADS[workload], n_keys, seed=1)
    ts = tsim.make_streams(tp, WORKLOADS[workload], n_keys, seed=1,
                           device="cpu")
    jmode, tmode = JSyncMode[mode], SyncMode[mode]
    want_state = jsim._run(jp, jmode, js, jnp.int32(clients))
    got_state = tsim._run(tp, tmode, ts, clients)
    assert_states_equal(j_state_np(want_state),
                        interop.sim_state_to_numpy(got_state),
                        f"{mode} {variant}: ")
    want = jsim.run_sim(jp, jmode, js, clients)
    got = tsim._result(tp, tmode, clients, got_state)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    assert want.ops_done > 0
    if variant.startswith("fail"):
        assert want.deadlocks >= (1 if mode in ("MCS", "CIDER") else 0)


def test_run_sim_and_sweep_clients_on_the_cpu():
    kw = dict(SMALL, ticks=256)
    jp, tp = jnet.SimParams(**kw), tnet.SimParams(**kw)
    modes = (SyncMode.MCS, SyncMode.CIDER)
    got = tsim.sweep_clients(tp, modes, "write-intensive", 500, [16, 64],
                             seed=2, device="cpu")
    want = jsim.sweep_clients(jp, [JSyncMode[m.name] for m in modes],
                              "write-intensive", 500, [16, 64], seed=2)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    streams = tsim.make_streams(tp, WORKLOADS["write-intensive"], 500,
                                seed=2, device="cpu")
    assert dataclasses.asdict(tsim.run_sim(tp, SyncMode.MCS, streams, 64)) \
        == dataclasses.asdict(want[1])


def test_advance_eager_pieces_equal_one_run():
    """``advance`` from a mid-run state continues the run exactly, and
    leaves the state it was given unchanged; the CPU refuses graphs."""
    kw = dict(SMALL, ticks=300)
    tp = tnet.SimParams(**kw)
    ts = tsim.make_streams(tp, WORKLOADS["write-intensive"], 1000,
                           device="cpu")
    whole = tsim._run(tp, SyncMode.CIDER, ts, 40)
    first = tsim._run(dataclasses.replace(tp, ticks=123), SyncMode.CIDER,
                      ts, 40)
    kept = interop.sim_state_to_numpy(first)
    rest = tsim.advance(tp, SyncMode.CIDER, ts, first, 123, 177)
    assert_states_equal(interop.sim_state_to_numpy(whole),
                        interop.sim_state_to_numpy(rest))
    assert_states_equal(kept, interop.sim_state_to_numpy(first))
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        tsim.advance(tp, SyncMode.CIDER, ts, first, 123, 1, graph=True)
    assert np.all(interop.sim_state_to_numpy(rest)["hist"] >= 0)
