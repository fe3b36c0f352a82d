"""Dry-run of every (architecture x input shape x production mesh) on the
host (port of ``repro.launch.dryrun``), with no card and no memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --cell train_4k --mesh single --out results/dryrun_torch

Where the reference lowers and compiles each cell for a 256- or 512-chip
TPU mesh and reads the compiled program, the port accounts for it: the
model is abstract (``Model.init_abstract``, meta tensors), the sharding
rules (``dist.sharding``) give each device's local shapes on the
shape-only production mesh (``launch.mesh.make_production_mesh``), and
``rooflines.counter`` counts the step's matrix-product FLOPs by running the
port's own step on meta tensors under ``FlopCounterMode``, and its
collectives by running it as a DTensor program on a fake process group of
the mesh's size (``count_collectives``; both one and two blocks, scaled to
the full depth).  Each cell is one JSON under ``--out`` (an existing one is
read back, so a sweep resumes), with the reference's keys where they mean
the same: ``arch, cell, mesh, chips, status, reason, n_params,
model_flops, bytes_per_chip, coll_bytes_per_chip, coll_by_kind,
n_collectives, roofline``; and ``flops`` (the step's), ``flops_per_chip``
(its share of one of ``chips`` devices), ``count_s`` (the time of the FLOP
count, where the reference has ``compile_s``) and ``coll_count_s`` (the
collective count's).  ``bytes_per_chip`` is each device's share of the
step's arguments: a lower bound on its HBM traffic.  The collectives
differ by mesh, so each (arch, cell, mesh) is counted, the grid's counts
in ``--jobs`` processes at once, each with its own fake process group; a
count that fails stops the grid with its error.
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.rooflines.counter import (argument_bytes,
                                           count_collectives, count_flops)
from repro_torch.rooflines.roofline import model_flops, roofline

__all__ = ["SHAPES", "cell_supported", "run_cell", "main"]

SHAPES = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}

HBM_NOTE = ("bytes_per_chip: each device's share of the step's arguments "
            "(parameters, AdamW state, batch, decode state) by the sharding "
            "rules' local shapes; a lower bound on its HBM traffic")


def cell_supported(cfg, cell: str) -> tuple[bool, str]:
    kind = SHAPES[cell][0]
    if kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no decode step"
    if cell == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full attention: 500k decode skipped (DESIGN.md)"
    return True, ""


@functools.cache
def _count(arch: str, cell: str) -> tuple[int, float]:
    """The step's FLOPs and the seconds the count took (the same on both
    meshes, so counted once a process)."""
    kind, seq, gb = SHAPES[cell]
    t0 = time.perf_counter()
    flops = count_flops(get_config(arch), kind, seq, gb)
    return flops, time.perf_counter() - t0


def _collectives(arch: str, cell: str, multi_pod: bool) -> dict:
    """``count_collectives`` of one cell on its production mesh, and the
    seconds it took (``coll_count_s``)."""
    kind, seq, gb = SHAPES[cell]
    t0 = time.perf_counter()
    out = count_collectives(get_config(arch), kind, seq, gb,
                            make_production_mesh(multi_pod=multi_pod))
    return {**out, "coll_count_s": time.perf_counter() - t0}


def count_grid_collectives(cells, jobs: int) -> dict:
    """``_collectives`` of every ``(arch, cell, multi_pod)`` in ``cells``,
    keyed by that triple, in ``jobs`` spawned processes (the training
    cells first), each count opening and closing its own fake process
    group.  A count that fails raises its error here."""
    cells = sorted(cells, key=lambda c: SHAPES[c[1]][0] != "train")
    if not cells:
        return {}
    with ProcessPoolExecutor(max(1, min(jobs, len(cells))),
                             mp_context=multiprocessing.get_context("spawn")
                             ) as ex:
        try:
            return dict(zip(cells, ex.map(_collectives, *zip(*cells))))
        finally:
            ex.shutdown(cancel_futures=True)


def _record_path(arch: str, cell: str, multi_pod: bool, outdir: str) -> str:
    tag = f"{arch}__{cell}__{'multi' if multi_pod else 'single'}"
    return os.path.join(outdir, tag + ".json")


def run_cell(arch: str, cell: str, multi_pod: bool, outdir: str,
             coll: dict | None = None) -> dict:
    """One cell's record, read back if it exists; ``coll``, the cell's
    ``_collectives`` if counted already (``count_grid_collectives``),
    else they are counted here."""
    path = _record_path(arch, cell, multi_pod, outdir)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    ok, why = cell_supported(cfg, cell)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "cell": cell,
           "mesh": "2x16x16" if multi_pod else "16x16", "chips": mesh.size}
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        kind, seq, gb = SHAPES[cell]
        model = Model(cfg, device="meta")
        flops, count_s = _count(arch, cell)
        n_params = model.n_params()
        mem = argument_bytes(model, kind, seq, gb, mesh)
        mf = model_flops(cfg, kind, seq, gb, n_params)
        coll = coll or _collectives(arch, cell, multi_pod)
        terms = roofline(flops / rec["chips"], mem["argument_size_in_bytes"],
                         coll["coll_bytes_per_chip"], mf, rec["chips"])
        rec.update(status="ok", count_s=count_s, n_params=n_params,
                   flops=flops, flops_per_chip=flops / rec["chips"],
                   bytes_per_chip=mem, hbm_note=HBM_NOTE, **coll,
                   model_flops=mf, roofline=terms.row())
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> dict:
    """Run the grid the flags select; returns ``{"ok", "skipped"}``
    counts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--cell", default="all", choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1,
                    help="processes counting collectives at once")
    args = ap.parse_args(argv)
    archs = ALL_ARCHS if args.arch == "all" else [args.arch]
    cells = list(SHAPES) if args.cell == "all" else [args.cell]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    grid = [(a, c, mp) for a in archs for c in cells for mp in meshes]
    coll = count_grid_collectives(
        [g for g in grid if cell_supported(get_config(g[0]), g[1])[0]
         and not os.path.exists(_record_path(*g, args.out))], args.jobs)
    n = {"ok": 0, "skipped": 0}
    for arch in archs:
        for cell in cells:
            for mp in meshes:
                rec = run_cell(arch, cell, mp, args.out,
                               coll.get((arch, cell, mp)))
                s = rec["status"]
                n[s] += 1
                line = f"[{s:7s}] {arch:22s} {cell:12s} {rec['mesh']:8s}"
                if s == "ok":
                    r = rec["roofline"]
                    line += (f" count={rec['count_s']:6.2f}s"
                             f" coll={rec['coll_count_s']:6.2f}s"
                             f" bott={r['bottleneck']:10s}"
                             f" frac={r['roofline_fraction']:.3f}")
                print(line, flush=True)
    print(f"\nDRYRUN ok={n['ok']} skipped={n['skipped']}")
    return n


if __name__ == "__main__":
    main()
