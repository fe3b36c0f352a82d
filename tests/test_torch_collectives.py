"""The dry-run's collective count (``rooflines.counter.count_collectives``)
on the CPU: each step runs as a DTensor program over meta tensors on a
fake process group, with the reference's activation-sharding points
(``dist.ctx.shard``) in the port's models and the count's own
partitioning rules for views, products, gathers, scatters, joins and
elementwise ops.

* qwen3-0.6b's smoke prefill and train step (B 4 x S 32) on a 2 x 4
  (``data``, ``model``) mesh: the port's count equals a count by hand from
  the shapes and the sharding rules, and ``counter.SMOKE``; the
  reference's ``parse_hlo`` of the same steps partitioned by XLA, computed
  live, is held to its numbers, the partitioners' differences named, and
  the port's total to a stated share of the reference's;
* one dense block on a model-only 1 x 4 mesh: its collectives are the
  sums of its two row-parallel products, counted by hand;
* the block-scaled count equals the full-depth count for every family,
  and one attention chunk counts what the chunked loop does, also where a
  device holds one sequence;
* the count refuses a torch whose smoke counts differ (``check_torch``);
* no fake process group outlives a count, and a count refuses to replace
  an initialized group;
* ``shard`` leaves a plain tensor as it is, the same object.
"""
from __future__ import annotations

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.dist.ctx import use_mesh as j_use_mesh  # noqa: E402
from repro.dist.sharding import batch_shardings as j_batch_shardings  # noqa: E402
from repro.dist.sharding import param_shardings as j_param_shardings  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.rooflines.hlo_parser import parse_hlo  # noqa: E402
from repro.train.optimizer import OptState, adamw_init, adamw_update  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.ctx import shard, use_mesh  # noqa: E402
from repro_torch.dist.sharding import param_shardings  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh,  # noqa: E402
                                     make_process_group_mesh)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.rooflines import counter  # noqa: E402

B, S = 4, 32
MESH = AbstractMesh(("data", "model"), (2, 4))
KINDS = {"all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute"}

# The reference's ``parse_hlo`` of qwen3-0.6b's smoke steps partitioned
# by XLA on ``jax.make_mesh((2, 4), ...)``: ``(coll_by_kind,
# n_collectives)``.  The two partitioners agree on no kind:
# * all-gather: XLA gathers each FSDP weight over ``data`` inside the
#   layer loop, in f32 (its CPU backend computes bf16 dots in f32), and
#   again for the backward; the port gathers each parameter once a step,
#   in its own dtype;
# * all-reduce: both sum each row-parallel product (``wo``, ``wo_mlp``),
#   the vocab-sharded embedding lookup and each weight gradient where the
#   op makes it; XLA's prefill sums in f32, and it also sums q and k's
#   projections over ``model`` for their norms;
# * collective-permute: XLA moves the 2 kv heads' k and v projections
#   across the 4-way model axis; the port replicates them (2 heads do not
#   split 4 ways) and has none;
# * all-to-all: XLA's embedding gather; the port's lookup is a masked
#   gather and one sum;
# * n_collectives: the port counts each collective run (both layers),
#   ``parse_hlo`` each collective instruction (the layer loop's body
#   once).
REFERENCE = {
    "prefill": ({"all-gather": 165376.0, "collective-permute": 32768.0,
                 "all-reduce": 294912.0, "all-to-all": 8192.0}, 17),
    "train": ({"all-gather": 430080.0, "collective-permute": 131072.0,
               "all-reduce": 706324.0, "all-to-all": 16384.0}, 52)}
# the port's total wire bytes over the reference's, which moves more for
# its f32 gathers and sums and its permutes (prefill 238,848 of 501,248
# bytes; train 923,092 of 1,283,860)
RATIO = {"prefill": (0.47, 0.48), "train": (0.71, 0.72)}


def _reference(kind: str):
    """``(coll_by_kind, n_collectives)`` of the reference's ``kind`` step of
    qwen3-0.6b's smoke config, partitioned on a 2 x 4 host mesh with
    automatic axes (the train step: loss, gradients and AdamW, as its
    dry-run's ``make_train_step``)."""
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:8])
    m = JModel(j_get_config("qwen3-0.6b", smoke=True))
    boxed = m.init_abstract()
    psh = j_param_shardings(boxed, mesh)
    params = unbox(boxed)
    batch = m.input_specs(kind, S, B)
    bsh = j_batch_shardings(batch, mesh)
    with mesh, j_use_mesh(mesh):
        if kind == "prefill":
            lowered = jax.jit(
                lambda p, x: m.prefill(p, x["tokens"], x.get("frontend")),
                in_shardings=(psh, bsh)).lower(params, batch)
        else:
            def step(p, o, x):
                (loss, _), grads = jax.value_and_grad(
                    m.loss_fn, has_aux=True)(p, x)
                return adamw_update(p, grads, o)
            osh = OptState(m=psh, v=psh, step=NamedSharding(mesh, JP()))
            lowered = jax.jit(step, in_shardings=(psh, osh, bsh)).lower(
                params, jax.eval_shape(adamw_init, params), batch)
    h = parse_hlo(lowered.compile().as_text())
    return h.coll_by_kind, h.n_collectives


def _port(cfg, kind: str, seq: int = S, batch: int = B, mesh=MESH):
    with counter.placed_mesh(mesh) as pm:
        return counter.count_step_collectives(cfg, kind, seq, batch, pm)


def _ar(nbytes: float, g: int) -> float:
    return 2 * nbytes * (g - 1) / g


def _ag(nbytes: float, g: int) -> float:
    return nbytes * (g - 1) / g


def _derived(kind: str):
    """qwen3-0.6b's smoke step on the 2 x 4 mesh counted by hand from its
    shapes and the sharding rules: ``(coll_by_kind, n_collectives)``."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    L, d, h, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd
    model = Model(cfg, device="meta")
    params = model.init_abstract()
    shs = param_shardings(params, model.param_axes(), MESH)
    leaves = {k: (params[k], shs[k]) for k in ("embed", "final_norm")}
    leaves.update({f"blocks/{k}": (v, shs["blocks"][k])
                   for k, v in params["blocks"].items()})

    def on(sh, axis):
        return axis in sh.spec

    def local_bytes(x, sh):
        return math.prod(sh.local_shape) * x.element_size()
    # FSDP: each parameter split over ``data`` gathered once a step from
    # its local block (g = 2: the wire bytes are the block's)
    fsdp = [k for k, (x, sh) in leaves.items() if on(sh, "data")]
    ag = sum(local_bytes(*leaves[k]) for k in fsdp)
    # the residual's (B/2, S, d) bf16 block summed over ``model`` after
    # the embedding lookup and after each row-parallel product
    act = _ar(B // 2 * S * d * 2, 4)
    if kind == "prefill":
        return ({"all-gather": ag, "all-reduce": (1 + 2 * L) * act},
                len(fsdp) + 1 + 2 * L)
    # the backward sums each kv head's dk and dv over its query heads,
    # which ``model`` splits: the f32 (B/2, S, H, hd) gradient gathered
    ag += 2 * L * _ag(B // 2 * S * h * hd * 4, 4)
    # activations: the lookup, the forward's 2 L row sums, the
    # attention's again under remat (L), the backward's sums of dx through
    # the column-parallel q, gate and up products (3 L) and through the
    # tied logits product (1)
    n_act = 1 + 2 * L + L + 3 * L + 1
    # weight gradients summed over ``data`` where the product makes them,
    # each at its ``model`` share (g = 2: the share's bytes), a layer's
    # slice of the stacked blocks at a time; the embedding's twice, the
    # lookup's whole-table scatter and the tied logits product's vocab
    # share; q's norm's also over ``model``, which splits the heads it
    # is shared by
    rest = [k for k in leaves if k != "embed"]
    grads = sum(local_bytes(*leaves[k]) * (2 if on(leaves[k][1], "data")
                                           else 1) for k in rest)
    n_grads = sum(L if k.startswith("blocks/") else 1 for k in rest)
    embed = _ar(cfg.vocab * d * 2, 2) + _ar(cfg.vocab // 4 * d * 2, 2)
    qnorm = L * _ar(hd * 4, 4)
    # the loss: the logsumexp over the vocab and the pick of the target's
    # logit, f32 (B/2, S) each over ``model``, and the mean over ``data``;
    # AdamW's global norm: each leaf's squared sum over each axis it is
    # split on
    loss = 2 * _ar(B // 2 * S * 4, 4) + _ar(4, 2)
    axes = [(on(sh, "data"), on(sh, "model")) for _, sh in leaves.values()]
    norm = sum(a * _ar(4, 2) + b * _ar(4, 4) for a, b in axes)
    ar = n_act * act + grads + embed + qnorm + loss + norm
    n = len(fsdp) + 2 * L + n_act + n_grads + 2 + L + 3 + sum(
        a + b for a, b in axes)
    return {"all-gather": ag, "all-reduce": ar}, n


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_qwen3_smoke_against_parse_hlo(kind):
    port = _port(get_config("qwen3-0.6b", smoke=True), kind)
    ref = _reference(kind)
    assert port == _derived(kind) == counter.SMOKE[kind]
    assert ref == REFERENCE[kind]
    assert set(port[0]) <= KINDS and set(ref[0]) <= KINDS
    lo, hi = RATIO[kind]
    assert lo <= sum(port[0].values()) / sum(ref[0].values()) <= hi
    assert not {k for k in port[0] if port[0][k] == ref[0].get(k)}


def test_one_dense_block_on_a_model_axis_is_its_row_parallel_sums():
    """On a 1 x 4 (``data``, ``model``) mesh one dense block of qwen3-0.6b's
    smoke config is tensor-parallel alone: q, k, v, gate and up split their
    output columns (k and v replicated: 2 kv heads on 4 parts), attention
    runs per head, and the two row-parallel products (``wo``, ``wo_mlp``)
    leave pending sums of the (B, S, d) residual, each summed in bf16
    where the product makes it.  The block's collectives (two blocks'
    count less one block's) are those two sums."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    mesh = AbstractMesh(("data", "model"), (1, 4))
    one = _port(dataclasses.replace(cfg, n_layers=1), "prefill", mesh=mesh)
    two = _port(dataclasses.replace(cfg, n_layers=2), "prefill", mesh=mesh)
    block = {k: two[0].get(k, 0.0) - one[0].get(k, 0.0)
             for k in set(one[0]) | set(two[0])}
    n = B * S * cfg.d_model
    assert {k: v for k, v in block.items() if v} == {
        "all-reduce": 2 * _ar(2 * n, 4)}
    assert two[1] - one[1] == 2


# one config of every family (the hybrid's smoke has a tail of 2 rec
# layers) and its kinds at smoke size
FAMILIES = ["qwen3-0.6b", "qwen2.5-32b", "deepseek-moe-16b", "mamba2-1.3b",
            "recurrentgemma-9b", "hubert-xlarge", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in FAMILIES for k in ("train", "prefill", "decode")
    if k != "decode" or get_config(a).has_decode])
def test_block_scaled_count_equals_full_depth(arch, kind):
    cfg = get_config(arch, smoke=True)
    seq = 128 if cfg.frontend == "vision" else 64
    cfg = dataclasses.replace(cfg, n_layers=8 if cfg.family == "hybrid"
                              else 4, attn_chunk=seq)
    got = counter.count_collectives(cfg, kind, seq, B, MESH)
    by_kind, n = _port(cfg, kind, seq, B)
    assert got["coll_by_kind"] == pytest.approx(by_kind, rel=1e-12)
    assert got["n_collectives"] == n > 0
    assert got["coll_bytes_per_chip"] == pytest.approx(sum(by_kind.values()))
    assert set(by_kind) <= KINDS


@pytest.mark.parametrize("arch,batch", [
    ("qwen3-0.6b", 4), ("recurrentgemma-9b", 4), ("hubert-xlarge", 4),
    ("qwen3-0.6b", 2)])
def test_one_chunk_counts_what_the_chunked_loop_does(arch, batch):
    """``count_collectives`` runs the attention as one chunk of the
    sequence; the chunked loop slices q, k and v along the sequence, which
    no mesh axis splits, and its products keep the batch and the heads
    split, so it moves the same.  B 2 on the 2-way ``data`` axis is the
    case of a device holding one sequence (the multi-pod prefill_32k
    cells: 32 sequences on ``pod`` x ``data``)."""
    cfg = get_config(arch, smoke=True)
    for kind in ("train", "prefill"):
        assert _port(dataclasses.replace(cfg, attn_chunk=16), kind, 64,
                     batch) == \
            _port(dataclasses.replace(cfg, attn_chunk=64), kind, 64, batch)


def test_a_count_refuses_a_torch_whose_smoke_counts_differ(monkeypatch):
    counter.check_torch.cache_clear()
    try:
        assert counter.check_torch() == torch.__version__
        counter.check_torch.cache_clear()
        pins = dict(counter.SMOKE, prefill=({"all-gather": 1.0}, 1))
        monkeypatch.setattr(counter, "SMOKE", pins)
        with pytest.raises(RuntimeError, match="not checked"):
            counter.count_collectives(get_config("qwen3-0.6b", smoke=True),
                                      "decode", S, B, MESH)
    finally:
        counter.check_torch.cache_clear()


def test_no_process_group_outlives_a_count():
    import torch.distributed as dist
    counter.count_collectives(get_config("qwen3-0.6b", smoke=True), "decode",
                              S, B, MESH)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_process_group_mesh()
    with pytest.raises(ValueError):
        counter.count_collectives(get_config("qwen3-0.6b", smoke=True),
                                  "generate", S, B, MESH)
    assert not dist.is_initialized()


def test_a_count_refuses_an_initialized_process_group(tmp_path):
    import torch.distributed as dist
    counter.check_torch()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="initialized"):
            counter.count_collectives(get_config("qwen3-0.6b", smoke=True),
                                      "decode", S, B, MESH)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_shard_returns_a_plain_tensor_itself():
    x = torch.zeros(4, 8, 16)
    axes = ("act_batch", None, "act_mlp")
    assert shard(x, axes) is x
    with use_mesh(MESH):
        assert shard(x, axes) is x
    with counter.placed_mesh(MESH) as pm, use_mesh(pm):
        assert shard(x, axes) is x
