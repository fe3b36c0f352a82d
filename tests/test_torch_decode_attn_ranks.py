"""Split-sequence decode attention (``repro_torch.dist.decode_attn``) on 2
gloo CPU ranks: a ``ProcessGroupMesh`` split along ``data``, each rank
attending over its half of the (replicated) cache and merging by
``all_reduce`` MAX of the log-sum-exps, then SUM of the weighted outputs
and of the weights.  Every rank ends with what the local mesh gives in one
process (within f32 rounding of the reductions' order), at lengths 0, 1,
Smax/2, Smax/2 + 1 and Smax, and with a (B,) length tensor.  The local
mesh is held to the JAX reference in tests/test_torch_decode_attn.py; this
file imports no JAX, so that the spawned ranks start quickly."""
from __future__ import annotations

import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist.decode_attn import decode_attention_spmd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

B, H, KH, D, SMAX, WORLD = 2, 8, 2, 32, 64, 2
LENGTHS = (0, 1, SMAX // WORLD, SMAX // WORLD + 1, SMAX)
ROWS = (5, SMAX // WORLD + 1)
JOIN_S = 90


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, 1, H, D), (B, SMAX, KH, D), (B, SMAX, KH, D))]


def _runs(mesh) -> dict:
    q, k, v = _inputs(6)
    outs = {ln: decode_attention_spmd(mesh, q, k, v, ln, seq_axis="data")
            for ln in LENGTHS}
    outs["rows"] = decode_attention_spmd(
        mesh, q, k, v, torch.tensor(ROWS, dtype=torch.int32),
        seq_axis="data")
    return outs


def _worker(rank: int, store_path: str, out_path: str) -> None:
    import torch.distributed as dist
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        torch.save(_runs(tmesh.make_process_group_mesh()), out_path)
    finally:
        dist.destroy_process_group()


def test_process_group_split_matches_local(tmp_path):
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_worker,
                        args=(r, str(tmp_path / "store"),
                              str(tmp_path / f"out{r}.pt")))
             for r in range(WORLD)]
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
    want = _runs(tmesh.make_local_mesh(WORLD, "cpu"))
    q, k, v = _inputs(6)
    for r in range(WORLD):
        got = torch.load(tmp_path / f"out{r}.pt")
        for key, w in want.items():
            torch.testing.assert_close(got[key], w, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["rows"], decode_attention(
            q, k, v, torch.tensor(ROWS, dtype=torch.int32)), rtol=1e-5,
            atol=1e-5)
