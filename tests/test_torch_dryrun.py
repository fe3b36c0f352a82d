"""The port's dry-run (``repro_torch.launch.dryrun``) and its accounting
(``rooflines.counter``, ``roofline``, ``report``) on the CPU against the
JAX reference:

* the dot FLOPs of a smoke train step (loss and backward, B 2 x S 32,
  remat per block), counted by ``FlopCounterMode`` on meta tensors, equal
  the reference's ``parse_hlo(compiled.as_text()).dot_flops`` for
  qwen3-0.6b, deepseek-moe-16b and recurrentgemma-9b; mamba2-1.3b's count
  is 4 B S H N FLOPs a layer short: the backward of the decay factor of
  the reference's three-operand einsums (``ssm.py:63`` and ``:78``), which
  XLA emits as a dot contracting the state dim N and the port computes as
  an elementwise product and a sum;
* the block-scaled count equals the full-depth count, and one attention
  chunk counts what the chunked loop does;
* the skip rules, the 31 ``ok`` and 9 ``skipped`` cells a mesh with the
  reference's reasons, the record's keys (each ok cell's collectives
  counted, under the reference's kind names), ``report.table``;
* the ring formulas against ``parse_hlo``'s on one collective each, and
  the H100 roofline.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.rooflines.hlo_parser import parse_hlo  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.rooflines import counter, report, roofline  # noqa: E402


def _j_dryrun():
    """The reference's dry-run module: it sets XLA_FLAGS when imported (for
    a process of its own), so the variable is put back."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _ref_train_dot_flops(arch: str, b: int, s: int) -> float:
    m = JModel(j_get_config(arch, smoke=True))
    params = unbox(m.init_abstract())
    batch = m.input_specs("train", s, b)
    step = jax.jit(jax.value_and_grad(m.loss_fn, has_aux=True))
    return parse_hlo(step.lower(params, batch).compile().as_text()).dot_flops


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "mamba2-1.3b"])
def test_train_step_dot_flops_match_parse_hlo(arch):
    b, s = 2, 32
    cfg = get_config(arch, smoke=True)
    got = counter.count_step_flops(cfg, "train", s, b)
    want = _ref_train_dot_flops(arch, b, s)
    if cfg.family == "ssm":
        gap = 4 * b * s * cfg.ssm_heads * cfg.ssm_state * cfg.n_layers
        assert (got, want - got) == (int(want) - gap, gap) and gap == 65_536
    else:
        assert got == want


# one config of every family (the hybrid's smoke has a tail of 2 rec
# layers) and its cells at smoke size
FAMILIES = ["qwen3-0.6b", "qwen2.5-32b", "deepseek-moe-16b", "mamba2-1.3b",
            "recurrentgemma-9b", "hubert-xlarge", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in FAMILIES for k in ("train", "prefill", "decode")
    if k != "decode" or get_config(a).has_decode])
def test_block_scaled_count_equals_full_depth(arch, kind):
    cfg = get_config(arch, smoke=True)
    seq = 128 if cfg.frontend == "vision" else 64
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=8)    # 2 triples + 2 tail
    else:
        cfg = dataclasses.replace(cfg, n_layers=4)
    assert counter.count_flops(cfg, kind, seq, 2) == \
        counter.count_step_flops(cfg, kind, seq, 2) > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b",
                                  "hubert-xlarge"])
def test_one_chunk_counts_what_the_chunked_loop_does(arch):
    """``count_flops`` runs the attention as one chunk of the sequence: the
    same count as the chunked loop's."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_chunk=16)
    for kind in ("train", "prefill"):
        assert counter.count_flops(cfg, kind, 64, 2) == \
            counter.count_step_flops(cfg, kind, 64, 2)


def test_shapes_and_skip_rules_are_the_reference_s():
    jd = _j_dryrun()
    assert dryrun.SHAPES == jd.SHAPES
    for arch in ALL_ARCHS:
        for cell in dryrun.SHAPES:
            assert dryrun.cell_supported(get_config(arch), cell) == \
                jd.cell_supported(j_get_config(arch), cell), (arch, cell)


def test_grid_records_and_report(tmp_path, capsys):
    """The whole grid: 31 ok and 9 skipped a mesh, the records' keys, each
    ok cell's collectives, the per-chip share and argument bytes of both
    meshes, a second run reading the records back, and the report's
    tables."""
    n = dryrun.main(["--out", str(tmp_path)])
    assert n == {"ok": 62, "skipped": 18}
    recs = report.load(str(tmp_path))
    assert len(recs) == 80
    jd = _j_dryrun()
    n_params = {a: JModel(j_get_config(a)).n_params() for a in ALL_ARCHS}
    for r in recs:
        assert r["chips"] == (512 if r["mesh"] == "2x16x16" else 256)
        if r["status"] == "skipped":
            assert r["reason"] == jd.cell_supported(j_get_config(r["arch"]),
                                                    r["cell"])[1]
            continue
        assert {"arch", "cell", "mesh", "chips", "status", "n_params",
                "model_flops", "bytes_per_chip", "roofline", "flops",
                "flops_per_chip", "count_s"} <= set(r)
        assert r["coll_bytes_per_chip"] > 0 and r["n_collectives"] > 0
        assert set(r["coll_by_kind"]) <= {
            "all-gather", "reduce-scatter", "all-reduce", "all-to-all",
            "collective-permute"}
        assert r["coll_bytes_per_chip"] == pytest.approx(
            sum(r["coll_by_kind"].values()))
        assert r["flops_per_chip"] == r["flops"] / r["chips"]
        assert r["roofline"]["collective_s"] == \
            r["coll_bytes_per_chip"] / roofline.H100["link_bw"] > 0
        assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")
        mem = r["bytes_per_chip"]
        parts = sum(v for k, v in mem.items()
                    if k != "argument_size_in_bytes")
        assert mem["argument_size_in_bytes"] == parts > 0
        assert ("opt_state" in mem) == (r["cell"] == "train_4k")
        assert ("decode_state" in mem) == (dryrun.SHAPES[r["cell"]][0]
                                           == "decode")
        assert r["n_params"] == n_params[r["arch"]]
    single = {(r["arch"], r["cell"]): r for r in recs if r["mesh"] == "16x16"}
    for r in recs:
        if r["mesh"] == "2x16x16" and r["status"] == "ok":
            s = single[(r["arch"], r["cell"])]
            assert r["flops"] == s["flops"]
            assert r["bytes_per_chip"]["params"] <= \
                s["bytes_per_chip"]["params"]
    # qwen3's parameters on 256 chips: 596,049,920 bf16 values, sharded
    # except the norms
    q = single[("qwen3-0.6b", "train_4k")]
    assert q["bytes_per_chip"]["params"] < 2 * 596_049_920 / 64
    with open(tmp_path / "qwen3-0.6b__train_4k__single.json") as f:
        assert json.load(f) == q
    assert dryrun.run_cell("qwen3-0.6b", "train_4k", False,
                           str(tmp_path)) == q
    capsys.readouterr()
    report.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("| ok |") == 62 and out.count("skipped:") == 18
    table = report.table(recs, "16x16")
    assert len(table.splitlines()) == 2 + 40
    assert "| coll s |" in table and "| n/c |" not in table


def test_wire_bytes_are_parse_hlo_s():
    """One collective of each kind in a minimal HLO module: ``parse_hlo``'s
    wire bytes equal ``wire_bytes``'s."""
    for kind in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                 "collective-permute"):
        text = ("ENTRY %main (p: f32[1024]) -> f32[1024] {\n"
                "  %p = f32[1024]{0} parameter(0)\n"
                f"  ROOT %c = f32[1024]{{0}} {kind}(%p), "
                "replica_groups={{0,1,2,3}}\n}\n")
        got = parse_hlo(text).coll_bytes
        assert got == counter.wire_bytes(kind, 4096, 4) > 0, kind
    with pytest.raises(ValueError):
        counter.wire_bytes("broadcast", 1, 2)


def test_h100_roofline():
    t = roofline.roofline(989e12, 3.35e12, None, 989e12 * 256, 256)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, None)
    assert t.step_time_s == 1.0 and t.roofline_fraction == 1.0
    t = roofline.roofline(989e12, 3.35e12, 900e9, 989e12, 1)
    assert t.bottleneck == "collective" and t.collective_s == 2.0
    assert roofline.H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                             "link_bw": 450e9}
