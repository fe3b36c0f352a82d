"""The port's drivers (``examples_torch/*.py``, ``tools/analyze_torch.py``)
on the CPU against the reference's (``examples/*.py``, ``tools/analyze.py``)
on the same seeded inputs, and the pins that ``chip_smoke.py`` phase 17
holds the card's rows to.

* quickstart, dynamic_contention, crash_recovery: the reference example
  runs in this process (``runpy``); the port's ``main(["--device", "cpu"])``
  prints the same table, line for line, so every integer is equal and every
  float matches to the printed digit.  The reference's values (recorded as
  its example runs) and the port's rows equal ``chip_smoke.py``'s pins:
  the modeled Mops/s exactly (pure functions of the bill), the p99s to the
  printed digit.
* crash_recovery's 2-shard failover: the reference's sharded path fails
  under this tree's jax (ROADMAP "Reference faults"), so its
  ``run_recovery_sharded`` is stood in for by what its example asserts it
  equals, the single-device run, with ``failover_reown``'s reown-read
  formula over the reference's single-device store at the crash window.
  The port's example asserts its own sharded bill bit-equal to its single
  device run.
* cider_sim_figures: at a cut size (``SIM_CUT``: every lane, 128 of 8,192
  ticks, every client count), every ``SimResult`` field of the example's
  ``sweep`` equal to the reference's ``run_sim`` on the same ``SimParams``,
  and its printed rows equal.
* serve_kv_cache: the scheduler's stats equal to the reference example's.
* train_lm: a few steps of the port's example against the reference's
  ``launch.train.main`` at the example's arguments, both from the
  reference's initial weights and on the same batches, losses within
  ``LOSS_RTOL`` (``tests/test_torch_train.py``).
* analyze_torch: the port's three passes clean on the CPU; the report has
  the reference tool's keys.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = {name: ROOT / "examples_torch" / f"{name}.py"
           for name in ("quickstart", "dynamic_contention", "crash_recovery",
                        "cider_sim_figures", "serve_kv_cache", "train_lm")}
DRIVERS["analyze_torch"] = ROOT / "tools" / "analyze_torch.py"
SIM_CUT = dict(lanes=512, ticks=128)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _load(DRIVERS[name], f"driver_{name}")


@pytest.fixture(scope="module")
def smoke():
    return _load(ROOT / "chip_smoke.py", "chip_smoke")


def _lines(text: str) -> list[str]:
    return [ln.rstrip() for ln in text.strip().splitlines()]


def _reference(name: str, **patches):
    """Run ``examples/<name>.py`` as ``__main__`` with module attributes
    patched (``"module:attr" -> value``); ``(stdout, its globals)``."""
    import importlib
    saved = []
    for where, value in patches.items():
        mod, attr = where.split(":")
        m = importlib.import_module(mod)
        saved.append((m, attr, getattr(m, attr)))
        setattr(m, attr, value)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            g = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                               run_name="__main__")
    finally:
        for m, attr, value in saved:
            setattr(m, attr, value)
    return out.getvalue(), g


def _port(name: str, argv=("--device", "cpu")):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = driver(name).main(list(argv))
    return out.getvalue(), rows


def test_quickstart_matches_reference(smoke):
    from repro.core import runner as jrunner
    modeled = []
    throughput = jrunner.modeled_throughput

    def recording(io_, p, n_ops):
        out = throughput(io_, p, n_ops)
        modeled.append((n_ops, out["modeled_mops"]))
        return out
    want, _ = _reference("quickstart",
                         **{"repro.core.runner:modeled_throughput": recording})
    got, rows = _port("quickstart")
    assert _lines(got) == _lines(want)
    pins = smoke.QUICKSTART_MOPS
    assert [r["workload"] for r in rows] == list(pins)
    for i, r in enumerate(rows):
        ref = modeled[4 * i:4 * i + 4]
        assert [n for n, _ in ref] == [r["n_ops"]] * 4
        assert r["mops"] == [m for _, m in ref] == list(
            pins[r["workload"]][1])
        assert r["n_ops"] == pins[r["workload"]][0]


def test_dynamic_contention_matches_reference(smoke):
    want, g = _reference("dynamic_contention")
    got, rows = _port("dynamic_contention")
    assert _lines(got) == _lines(want)
    upd, mass = g["upd"], np.asarray(g["mass"])
    pess, comb = np.asarray(g["pess"]), np.asarray(g["comb"])
    assert len(rows) == len(smoke.DYNAMIC_ROWS) == g["W"]
    for w, (r, pin) in enumerate(zip(rows, smoke.DYNAMIC_ROWS)):
        ref = (int(upd[w].sum()), int((pess[w] & upd[w]).sum()),
               int(comb[w].sum()), int(mass[w]),
               float(np.nanpercentile(g["lat"][w], 99)))
        port = (r["updates"], r["pess"], r["wc"], r["credits"], r["p99_us"])
        assert port[:4] == ref[:4] == pin[:4], w
        assert f"{port[4]:.1f}" == f"{ref[4]:.1f}" == f"{pin[4]:.1f}", w


def _failover_stand_in(keys0):
    """The reference's ``run_recovery_sharded`` for the example's one
    failover, as the single-device run it asserts equal, with
    ``failover_reown``'s reown reads over the single-device store at the
    failover window."""
    from repro.core.credits import credit_init
    from repro.core.engine import populate, store_init, store_view
    from repro.recovery import run_recovery, slice_stream

    def stand_in(cfg, n_shards, state, credits, stream, failovers):
        (ev,) = failovers

        def run(s):
            return run_recovery(cfg, populate(cfg, store_init(cfg), keys0,
                                              keys0), credit_init(4096), s)
        full = run(stream)
        head = run(slice_stream(stream, 0, ev.window))
        exists = np.asarray(store_view(head.state)[0])
        per = cfg.n_slots // n_shards
        dead = sorted(set(range(n_shards)) - set(ev.survivors))
        lost = int(exists.reshape(n_shards, per)[dead].sum())
        return dataclasses.replace(full, recovery_io=[{
            "dead_shards": dead, "reown_reads": len(dead) * per + lost}])
    return stand_in


def test_crash_recovery_matches_reference(smoke):
    keys0 = np.arange(1024)
    want, g = _reference("crash_recovery", **{
        "repro.recovery:run_recovery_sharded": _failover_stand_in(keys0)})
    got, out = _port("crash_recovery")
    assert _lines(got) == _lines(want)
    assert np.array_equal(g["keys0"], keys0)
    runs = g["runs"]
    for w, cells in enumerate(out["windows"]):
        for mode, (cfg, run, lat) in runs.items():
            rep, p99 = cells[mode.name]
            want_rep = int(np.asarray(run.io.repair_cas)[w])
            pin_rep, pin_p99 = smoke.CRASH_WINDOWS[mode.name][w]
            assert rep == want_rep == pin_rep, (w, mode)
            assert (f"{p99:.0f}" == f"{np.nanpercentile(lat[w], 99):.0f}"
                    == f"{pin_p99:.0f}"), (w, mode)
    from repro.recovery import time_to_repair
    for mode, (cfg, run, lat) in runs.items():
        t = time_to_repair(run.io, g["CRASH"])
        s = out["summary"][mode.name]
        pin = smoke.CRASH_SUMMARY[mode.name]
        assert (s["repair_cas"], s["windows_to_repair"]) == (
            t["repair_cas"], t["windows_to_repair"]) == pin[:2], mode
        assert (f"{s['p99_us']:.0f}"
                == f"{np.nanpercentile(lat[g['CRASH']:], 99):.0f}"
                == f"{pin[2]:.0f}"), mode
    rio = g["sharded"].recovery_io[0]
    assert out["failover"] == smoke.CRASH_FAILOVER == {
        "dead_shards": rio["dead_shards"], "reown_reads": rio["reown_reads"]}


def test_cider_sim_figures_matches_reference_at_a_cut_size(smoke):
    from repro.core import sim as jsim
    from repro.core.types import SyncMode as JSyncMode
    from repro.workloads.ycsb import WORKLOADS as JWORKLOADS
    ex = driver("cider_sim_figures")
    # the example's full size is phase 13's pinned BASE runs
    assert dataclasses.asdict(ex.params()) == dataclasses.asdict(
        ex.SimParams(**smoke.SIM_BASE))
    assert (ex.WORKLOAD, ex.N_KEYS) == smoke.SIM_WI
    assert {48, 512} <= set(ex.CLIENTS)
    tp = ex.params(**SIM_CUT)
    got = ex.sweep(tp, ex.streams(tp, "cpu"))
    p = jsim.SimParams(n_lanes=tp.n_lanes, ticks=tp.ticks,
                       max_ops=tp.max_ops)
    st = jsim.make_streams(p, JWORKLOADS[ex.WORKLOAD], n_keys=ex.N_KEYS)
    assert list(got) == list(ex.CLIENTS)
    for nc in ex.CLIENTS:
        row = [str(nc)]
        for mode in JSyncMode:
            want = dataclasses.asdict(jsim.run_sim(p, mode, st, nc))
            assert dataclasses.asdict(got[nc][mode.name]) == want, (nc, mode)
            row.append(f"{want['throughput_mops']:.2f}")
        assert ex.csv_row(nc, got[nc]) == ",".join(row)


def test_serve_kv_cache_matches_reference(smoke):
    import repro.launch.serve as jserve
    stats = []
    serve = jserve.main

    def recording(argv):
        stats.append(serve(argv))
        return stats[-1]
    want, _ = _reference("serve_kv_cache",
                         **{"repro.launch.serve:main": recording})
    got, rows = _port("serve_kv_cache")
    assert _lines(got)[-1] == _lines(want)[-1] == "serving example OK"
    assert rows == stats[0] == smoke.SERVE_KV_STATS


def test_train_lm_matches_reference_main(tmp_path, monkeypatch):
    """Three steps of the port's example against the reference's
    ``launch.train.main`` at the example's arguments (its checkpoint in a
    directory of the test's own): the same initial weights and batches
    (the port's Zipf pipeline on the CPU) on both sides."""
    import repro.launch.train as jtrain
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from test_torch_train import LOSS_RTOL, _j_params, _patch_mains
    ex = driver("train_lm")
    jm, jp = _j_params("qwen3-0.6b")
    pipe = Pipeline(DataConfig(vocab=jm.cfg.vocab, seq_len=64,
                               global_batch=8), device="cpu")
    batches = []
    for step in range(3):
        b = pipe.batch_at(step)
        toks = np.concatenate([b["tokens"].numpy(),
                               b["targets"].numpy()[:, -1:]], axis=1)
        assert np.array_equal(toks[:, 1:], b["targets"].numpy())
        batches.append(toks)
    _patch_mains(monkeypatch, jp, batches)
    want = jtrain.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3",
                        "--batch", "8", "--seq", "64",
                        "--ckpt", str(tmp_path / "reference"),
                        "--ckpt_every", "100"])
    got = ex.main(["--device", "cpu", "--steps", "3",
                   "--ckpt", str(tmp_path / "port")])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # a directory of the port's own under the checkout, never the
    # reference's /tmp/repro_ckpt
    assert Path(ex.CKPT).parent == ROOT / "build"


def test_analyze_torch_is_clean_with_the_reference_report_keys(tmp_path):
    tool = driver("analyze_torch")
    report = tmp_path / "ANALYZE_REPORT.torch.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool.main(["--device", "cpu", "--report", str(report)]) == 0
    assert "[analyze] all passes clean" in out.getvalue()
    got = json.loads(report.read_text())
    from repro_torch.analysis import PASSES
    assert got["ok"] is True
    assert list(got["passes"]) == list(PASSES)
    assert all(not v["violations"] for v in got["passes"].values())
    ref_report = tmp_path / "ANALYZE_REPORT.json"
    ref = _load(ROOT / "tools" / "analyze.py", "reference_analyze")
    with contextlib.redirect_stdout(io.StringIO()):
        assert ref.main(["--pass", "bill_lint",
                         "--report", str(ref_report)]) == 0
    want = json.loads(ref_report.read_text())
    assert set(got) == set(want)
    assert got["version"] == want["version"]
    for entry in got["passes"].values():
        assert set(entry) == set(want["passes"]["bill_lint"])
    with pytest.raises(SystemExit):
        tool.main(["--pass", "jaxpr_check", "--device", "cpu"])
    assert tool.DEFAULT_REPORT == "ANALYZE_REPORT.torch.json"
    assert tool.DEFAULT_REPORT in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_refuses_missing_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver(name).main([])


def test_one_counterpart_a_reference_example():
    """One counterpart a reference example, of the same name."""
    ref = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert ref == sorted(p.name for p in DRIVERS.values()
                         if p.parent.name == "examples_torch")
