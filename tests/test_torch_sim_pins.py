"""``chip_smoke.py``'s ``SIM_PINS`` are what the JAX reference's ``run_sim``
gives for each of ``SIM_RUNS``: the values phase 13 holds the port's
graphed simulator to on the card."""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import sim as jsim  # noqa: E402
from repro.core import simnet as jnet  # noqa: E402
from repro.core.types import SyncMode as JSyncMode  # noqa: E402
from repro.workloads.ycsb import WORKLOADS as JWORKLOADS  # noqa: E402
from repro_torch.core import simnet as tnet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.slow
def test_reference_reproduces_sim_pins():
    smoke = _smoke()
    assert sorted(smoke.SIM_RUNS) == sorted(smoke.SIM_PINS)
    streams = {}
    for name, (over, mode, (workload, keys), clients) in \
            smoke.SIM_RUNS.items():
        p = jnet.SimParams(**over)
        key = (p.n_lanes, p.max_ops, p.h_bits, p.hc_bits, p.hl_bits,
               workload, keys)
        if key not in streams:
            streams[key] = jsim.make_streams(p, JWORKLOADS[workload], keys,
                                             seed=0)
        got = dataclasses.asdict(jsim.run_sim(p, JSyncMode[mode],
                                              streams[key], clients))
        assert got == smoke.SIM_PINS[name], name


def test_sim_runs_cover_the_issue_list():
    smoke = _smoke()
    runs = smoke.SIM_RUNS
    # the default SimParams' width, cut to SIM_DEFAULT_TICKS ticks
    assert runs["default_CIDER_512"][0] == {"ticks": smoke.SIM_DEFAULT_TICKS}
    assert smoke.SIM_DEFAULT_TICKS == 8192
    assert tnet.SimParams().n_lanes == 1024 and tnet.SimParams().ticks == 32768
    for mode in smoke.MODES:
        for nc in (48, 512):
            assert runs[f"base_{mode}_{nc}"][0] == smoke.SIM_BASE
    assert {k for k, v in runs.items() if v[0].get("fail_lanes")
            or v[0].get("fail_lane", -1) >= 0} == {"crash_MCS_lane3",
                                                    "crash_MCS_lanes"}
