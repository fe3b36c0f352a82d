"""The port's meshes (``repro_torch.launch.mesh``): the process-group mesh
(one shard per rank, ``all_reduce`` per field) on 2 and 4 gloo CPU ranks
gives what the local mesh (every shard in one process) gives; and a run
makes exactly 20 reductions, one per ``Results`` and ``IOMetrics`` field,
however many windows it has."""
from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import runner  # noqa: E402
from repro_torch.core.credits import credit_init  # noqa: E402
from repro_torch.core.engine import Results  # noqa: E402
from repro_torch.core.types import EngineConfig, IOMetrics, SyncMode  # noqa: E402
from repro_torch.dist import store as dstore  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

NS, B, W, NCN, TABLE, SCAN_MAX = 1024, 128, 4, 8, 256, 8
N_FIELDS = len(dataclasses.fields(Results)) + len(dataclasses.fields(IOMetrics))
JOIN_S = 90


def _setup(mode: int, windows: int = W):
    """A seeded stream with hot keys, SCANs and a CN crash, and its store
    config (the same in every process)."""
    rng = np.random.default_rng(mode)
    kinds = rng.choice([0, 1, 2, 3, 5], size=(windows, B),
                       p=[0.25, 0.1, 0.4, 0.1, 0.15]).astype(np.int32)
    hot = rng.integers(0, NS, 4)
    keys = np.where(rng.random((windows, B)) < 0.5,
                    hot[rng.integers(0, 4, (windows, B))],
                    rng.integers(0, NS, (windows, B))).astype(np.int32)
    values = np.where(kinds == 5, rng.integers(1, SCAN_MAX + 3, (windows, B)),
                      rng.integers(0, 1000, (windows, B))).astype(np.int32)
    alive = np.ones((windows, NCN), bool)
    alive[windows // 2:, 2] = False
    cfg = EngineConfig(n_slots=NS, heap_slots=NS + windows * B,
                       mode=SyncMode(mode), scan_max=SCAN_MAX)
    stream = runner.make_stream(kinds, keys, values, n_cns=NCN, alive=alive,
                                device="cpu")
    return cfg, stream


def _store(cfg, n):
    pk = np.arange(0, NS, 3)
    return dstore.sharded_populate(cfg, n,
                                   dstore.sharded_store_init(cfg, n, "cpu"),
                                   pk, pk * 2)


def _runs(cfg, mesh, stream):
    """The runs both meshes are held to: per-window bills split by shard,
    and the traced run."""
    n = mesh.n_shards
    a = dstore.run_windows_sharded(cfg, mesh, _store(cfg, n),
                                   credit_init(TABLE, "cpu"), stream,
                                   io_per_window=True, per_shard_io=True)
    b = dstore.run_windows_sharded_traced(cfg, mesh, _store(cfg, n),
                                          credit_init(TABLE, "cpu"), stream)
    return {"state": a[0], "credits": a[1], "results": a[2], "io": a[3],
            "traced": b[1:]}


class _Counting:
    """Counts ``reduce`` calls of the mesh it wraps."""

    def __init__(self, mesh):
        self.mesh, self.calls = mesh, 0
        self.n_shards, self.shards = mesh.n_shards, mesh.shards
        self.device = mesh.device

    def reduce(self, parts):
        self.calls += 1
        return self.mesh.reduce(parts)

    def psum(self, trees):
        return tmesh.Mesh.psum(self, trees)


def _worker(rank: int, world: int, store_path: str, out_path: str,
            mode: int) -> None:
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = _Counting(tmesh.make_process_group_mesh())
        cfg, stream = _setup(mode)
        out = _runs(cfg, mesh, stream)
        out["calls"] = mesh.calls
        out["shards"] = mesh.shards
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def _eq(a, b, what):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _eq(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.parametrize("mode", [SyncMode.MCS, SyncMode.CIDER],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("world", [2, 4])
def test_process_group_mesh_matches_local_mesh(tmp_path, world, mode):
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_worker,
                        args=(r, world, str(tmp_path / "store"),
                              str(tmp_path / f"out{r}.pt"), int(mode)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    cfg, stream = _setup(int(mode))
    want = _runs(cfg, tmesh.make_local_mesh(world, "cpu"), stream)
    per, hper = dstore.shard_extents(cfg, world)
    for r in range(world):
        got = torch.load(tmp_path / f"out{r}.pt", weights_only=False)
        assert got["shards"] == (r,)
        assert got["calls"] == 2 * N_FIELDS
        for k in ("credits", "results", "io", "traced"):
            _eq(want[k], got[k], f"rank {r} {k}")
        # this rank's partition of the store
        part = dstore._partition(got["state"], r, per, hper)
        _eq(dstore._partition(want["state"], r, per, hper), part,
            f"rank {r} store")


@pytest.mark.parametrize("windows", [1, 3, 7])
def test_twenty_reductions_per_run(windows):
    """One reduction per field per call, whatever the window count, for
    every runner and option."""
    cfg, stream = _setup(int(SyncMode.CIDER), windows)
    mesh = _Counting(tmesh.make_local_mesh(4, "cpu"))
    for kw in ({}, {"io_per_window": True}, {"per_shard_io": True}):
        mesh.calls = 0
        dstore.run_windows_sharded(cfg, mesh, _store(cfg, 4),
                                   credit_init(TABLE, "cpu"), stream, **kw)
        assert mesh.calls == N_FIELDS == 20, kw
    mesh.calls = 0
    dstore.run_windows_sharded_traced(cfg, mesh, _store(cfg, 4),
                                      credit_init(TABLE, "cpu"), stream)
    assert mesh.calls == 20


def test_local_mesh_shards_and_device():
    m = tmesh.make_local_mesh(4, "cpu")
    assert (m.n_shards, m.shards, m.device.type) == (4, (0, 1, 2, 3), "cpu")
    parts = [torch.full((3,), i, dtype=torch.int32) for i in range(4)]
    assert m.reduce(parts).tolist() == [6, 6, 6]
    assert m.reduce(parts).dtype == torch.int32
    with pytest.raises(ValueError):
        tmesh.make_local_mesh(0, "cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_process_group_mesh()
