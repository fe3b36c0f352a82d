"""The dry-run's accounting of one step (the port's counterpart of
``repro.rooflines.hlo_parser``, which reads compiled, partitioned HLO).

* **Matrix-product FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``
  over the port's own step -- forward; for training forward, backward
  (each block recomputed under ``remat="block"``, as the reference's
  ``jax.checkpoint`` recomputes it) and AdamW -- on meta tensors, so it
  needs no memory and no card.  It counts the products PyTorch runs
  (``mm``, ``bmm``, ``einsum``'s products, attention), which is what the
  reference's ``parse_hlo`` counts as ``dot_flops``.  ``count_flops``
  counts models one and two blocks deep (the hybrid: one and two
  (rec, rec, attn) triples, and one triple plus its tail layers) and
  scales the block's count to the full depth: every block of a family
  does the same work.
* **HBM bytes**: ``argument_bytes`` adds each device's share of the step's
  arguments (parameters, AdamW state, batch, decode state) from its
  sharding's local shape: a lower bound on the step's traffic, since a
  step reads each argument at least once and activations come on top.
* **Collectives**: ``count_collectives`` runs the same step as a DTensor
  program: its arguments are DTensors of meta tensors laid out by the
  sharding rules on a ``DeviceMesh`` of the production axes over a
  ``"fake"`` process group (``placed_mesh``), and the models' ``shard``
  points redistribute their activations as the reference's
  ``with_sharding_constraint`` lays them out.  A dispatch mode
  (``_counting_mode``) bills each functional collective, output bytes
  and group size through ``wire_bytes`` (the reference's ring formulas),
  under the reference's kind names; it scales from one and two blocks as
  ``count_flops`` does.  The layouts between the shard points are the
  count's own, not DTensor's, whose strategies change with the torch
  version: views (``_view``), products (``_einsum``: ``torch.einsum``,
  ``mm``, ``bmm``, partitioned as a ``dot_general``), row gathers and
  scatters (``_index``, ``_index_put``, ``_gather``, ``_scatter``),
  joins and cuts (``_cat``, ``_split``) and elementwise ops
  (``_pointwise``) follow stated rules, each pending sum is summed by the
  op that makes it (``_summed``), FSDP gathers each parameter once a
  step (``_Placer.unshard``), redistributions are planned greedily
  (``_greedy_redistribution_plans``) and Shard-to-Shard moves billed as
  the all-to-all a card's mesh runs (``_all_to_all_on_cpu_mesh``).  The
  ops left to DTensor (reductions, softmax, casts, the MoE's sort, ...)
  take its strategies and those in ``_register_strategies``, and a torch
  whose counts of qwen3-0.6b's smoke steps differ from ``SMOKE`` is
  refused (``check_torch``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.dist.ctx import use_mesh
from repro_torch.dist.sharding import (P, Sharding, batch_shardings,
                                       decode_state_shardings,
                                       param_shardings, to_placements)
from repro_torch.launch.mesh import PlacedMesh
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (OptState, adamw_init,
                                         adamw_update, tree_leaves, tree_map)

__all__ = ["count_step_flops", "count_flops", "argument_bytes", "wire_bytes",
           "placed_mesh", "count_step_collectives", "count_collectives"]


class _Unplaced:
    """The step's arguments as the abstract model makes them: plain meta
    tensors, AdamW's state from ``adamw_init``."""

    def params(self, tree):
        return tree

    def unshard(self, params):
        return params

    def opt_state(self, params):
        return adamw_init(params)

    def batch(self, tree):
        return tree

    def decode_state(self, tree):
        return tree

    def token(self, t):
        return t


def _run_step(model: Model, kind: str, seq: int, global_batch: int,
              place=_Unplaced()) -> None:
    """One ``kind`` step of ``model`` on meta tensors; ``place`` lays out
    its arguments (``_Placer``: as DTensors on a device mesh)."""
    cfg = model.cfg
    params = place.params(model.init_abstract())
    if kind == "train":
        params = tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = model.loss_fn(place.unshard(params), place.batch(
            model.input_specs("train", seq, global_batch)))
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        it = iter(grads)
        with torch.no_grad():
            params = tree_map(lambda p: p.detach(), params)
            adamw_update(params, tree_map(lambda _: next(it), params),
                         place.opt_state(params))
    elif kind == "prefill":
        batch = place.batch(model.input_specs("prefill", seq, global_batch))
        with torch.no_grad():
            params = place.unshard(params)
            if cfg.family == "encoder":
                tfm.forward(cfg, params, batch["tokens"],
                            batch.get("frontend"))
            else:
                model.prefill(params, batch["tokens"], batch.get("frontend"))
    elif kind == "decode":
        specs = model.input_specs("decode", seq, global_batch)
        with torch.no_grad():
            model.decode_step(place.unshard(params),
                              place.decode_state(specs["state"]),
                              place.token(specs["token"]).long(), 0)
    else:
        raise ValueError(kind)


def count_step_flops(cfg, kind: str, seq: int, global_batch: int) -> int:
    """The matrix-product FLOPs of one ``kind`` step of ``cfg`` at its own
    depth, counted on meta tensors."""
    with FlopCounterMode(display=False) as fc:
        _run_step(Model(cfg, device="meta"), kind, seq, global_batch)
    return int(fc.get_total_flops())


def _depths(cfg) -> dict[str, int]:
    """The reduced depths ``count_flops`` and ``count_collectives`` count:
    ``one`` and ``two`` blocks, and for a hybrid with a tail, ``tail``
    (one triple and the tail's layers)."""
    if cfg.family == "hybrid":
        out = {"one": 3, "two": 6}
        if cfg.n_layers % 3:
            out["tail"] = 3 + cfg.n_layers % 3
        return out
    return {"one": 1, "two": 2}


def _full_depth(cfg, one, two, tail=None):
    """A count at ``cfg``'s depth from its counts at ``_depths``: the
    embedding, head and loss once, plus the block's count times the number
    of blocks (and, in a hybrid, the tail's count)."""
    if cfg.family == "hybrid":
        nt = cfg.n_layers // 3
        return one + (nt - 1) * (two - one) + (0 if tail is None
                                               else tail - one)
    return one + (cfg.n_layers - 1) * (two - one)


def count_flops(cfg, kind: str, seq: int, global_batch: int) -> int:
    """``count_step_flops`` at the full depth, from the counts of one and
    two blocks (``_full_depth``).  The attention runs as one chunk of the whole
    sequence (``attn_chunk = seq``): the plain chunked attention computes
    every (query chunk, key chunk) pair, masked or not, so its products'
    FLOPs do not depend on the chunk, and one chunk counts them without a
    Python loop over 32 x 32 pairs a layer at 32k positions."""
    cfg = dataclasses.replace(cfg, attn_chunk=max(seq, cfg.attn_chunk))
    n = {k: count_step_flops(dataclasses.replace(cfg, n_layers=L), kind,
                             seq, global_batch)
         for k, L in _depths(cfg).items()}
    return _full_depth(cfg, **n)


def _nbytes(sharding, dtype) -> int:
    n = 1
    for s in sharding.local_shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def argument_bytes(model: Model, kind: str, seq: int, global_batch: int,
                   mesh) -> dict[str, int]:
    """Each device's bytes of the step's arguments, by the local shapes of
    their shardings on ``mesh``: ``params`` (and for training ``opt_state``,
    the f32 AdamW moments and the step counter, laid out as the
    parameters), ``batch`` (``decode_state`` and the token for decode), and
    ``argument_size_in_bytes``, their sum."""
    params = model.init_abstract()
    psh = param_shardings(params, model.param_axes(), mesh)
    out = {"params": sum(_nbytes(s, p.dtype) for s, p in zip(
        tree_leaves(psh), tree_leaves(params)))}
    if kind == "train":
        out["opt_state"] = 2 * sum(_nbytes(s, torch.float32)
                                   for s in tree_leaves(psh)) + 4
    spec = model.input_specs(kind, seq, global_batch)
    if kind == "decode":
        st = spec.pop("state")
        out["decode_state"] = sum(_nbytes(s, x.dtype) for s, x in zip(
            tree_leaves(decode_state_shardings(st, mesh)), tree_leaves(st)))
        spec.pop("pos")
    out["batch"] = sum(_nbytes(s, x.dtype) for s, x in zip(
        tree_leaves(batch_shardings(spec, mesh)), tree_leaves(spec)))
    out["argument_size_in_bytes"] = sum(out.values())
    return out


def wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Bytes one device sends for a ring collective of ``kind`` over
    ``group`` devices whose output is ``out_bytes`` a device (the
    reference's formulas, ``hlo_parser.py:192-201``)."""
    g = max(group, 2)
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * (g - 1) / g
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")


# ===========================================================================
# Collectives: the step as a DTensor program on a fake process group
# ===========================================================================

def _coll_kinds() -> dict:
    """Functional collective op -> the reference's kind name."""
    f = torch.ops._c10d_functional
    return {f.all_gather_into_tensor: "all-gather",
            f.all_gather_into_tensor_coalesced: "all-gather",
            f.reduce_scatter_tensor: "reduce-scatter",
            f.reduce_scatter_tensor_coalesced: "reduce-scatter",
            f.all_reduce: "all-reduce",
            f.all_reduce_coalesced: "all-reduce",
            f.all_to_all_single: "all-to-all",
            torch.ops._dtensor.shard_dim_alltoall: "all-to-all",
            f.broadcast: None}


@functools.cache
def _counting_mode():
    """The class of the dispatch mode that bills every functional
    collective the step issues; built on first use, since it imports
    ``torch.distributed.tensor``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    kinds = _coll_kinds()
    aten = torch.ops.aten
    rules = {aten.view.default: _view, aten._unsafe_view.default: _view,
             aten.mm.default: functools.partial(_einsum, "ik,kj->ij"),
             aten.bmm.default: functools.partial(_einsum, "bik,bkj->bij"),
             aten.index.Tensor: _index,
             aten.gather.default: _gather,
             aten.scatter.src: functools.partial(_scatter, aten.scatter.src),
             aten.scatter_add.default: functools.partial(
                 _scatter, aten.scatter_add.default),
             aten.index_put.default: _index_put,
             aten.cat.default: _cat,
             aten.split.Tensor: _split,
             aten.split_with_sizes.default: _split}

    class Counting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_kind: dict[str, float] = {}
            self.n = 0
            self.inner = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                if self.inner:
                    # DTensor's own handling of the step's op: it runs the
                    # op's local tensors' ops and collectives, which come
                    # back here
                    return NotImplemented
                self.inner = True
                try:
                    with self:
                        rule = rules.get(func) or (
                            functools.partial(_pointwise, func)
                            if torch.Tag.pointwise in func.tags else None)
                        out = rule(*args, **kwargs) if rule else None
                        if out is None:
                            out = func(*args, **kwargs)
                        return _summed(out)
                finally:
                    self.inner = False
            out = func(*args, **kwargs)
            packet = getattr(func, "_overloadpacket", None)
            if packet in kinds:
                self._bill(packet, kinds[packet], args, out)
            return out

        def _bill(self, packet, kind, args, out):
            if kind is None:
                raise NotImplementedError(
                    f"{packet}: no collective kind of the reference's")
            outs = out if isinstance(out, (list, tuple)) else [out]
            nbytes = sum(o.numel() * o.element_size() for o in outs)
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + wire_bytes(
                kind, nbytes, _group_size(args[-1]))
            self.n += 1

    return Counting


def _summed(out):
    """``out`` with each pending sum (a DTensor's ``Partial`` placements)
    all-reduced to ``Replicate``: a partial sum is summed by the op that
    makes it, as XLA's partitioner sums a row-parallel product, a
    gradient's batch reduction or a masked lookup at the op."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(out, (list, tuple)):
        return type(out)(_summed(o) for o in out)
    if isinstance(out, DTensor) and any(p.is_partial()
                                        for p in out.placements):
        return out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def _view_groups(src, dst):
    """A view from shape ``src`` to ``dst`` as groups ``(input dims,
    output dims)`` of equal products; a size-1 dim that starts a group is
    a group of its own."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        if i < len(src) and src[i] == 1:
            groups.append(([i], []))
            i += 1
        elif j < len(dst) and dst[j] == 1:
            groups.append(([], [j]))
            j += 1
        else:
            a, b, pa, pb = [i], [j], src[i], dst[j]
            i, j = i + 1, j + 1
            while pa != pb:
                if pa < pb:
                    a.append(i)
                    pa *= src[i]
                    i += 1
                else:
                    b.append(j)
                    pb *= dst[j]
                    j += 1
            groups.append((a, b))
    return groups


def _view_layout(src, dst, placements, sizes):
    """The placements of a view from ``src`` to ``dst`` of a tensor laid
    out by ``placements`` on mesh axes of ``sizes``: ``(placements,
    None)`` where each device's block stays one block of the view, else
    ``(None, m)``, ``m`` the mesh axis to gather first.  A group of
    merged dims keeps its mesh axes where they split the dims major to
    minor in mesh order, every dim but the last one split all the way, so
    that a device holds a contiguous run of the merged dim; a split dim
    hands its mesh axes, in mesh order, to the new dims major to minor,
    moving to the next only when one is split all the way."""
    from torch.distributed.tensor import Shard
    out = list(placements)
    for a, b in _view_groups(src, dst):
        ms = [m for m, p in enumerate(placements)
              if p.is_shard() and p.dim in a]
        if not ms:
            continue
        if ms != sorted(ms, key=lambda m: a.index(placements[m].dim)):
            return None, ms[-1]
        loc = {d: src[d] for d in a}
        for m in ms:
            d = placements[m].dim
            if loc[d] % sizes[m]:
                return None, m
            loc[d] //= sizes[m]
        last = a.index(placements[ms[-1]].dim)
        if not b or any(loc[d] != 1 for d in a[:last]):
            return None, ms[-1]
        k, r = 0, dst[b[0]]
        for m in ms:
            while r == 1 and k + 1 < len(b):
                k += 1
                r = dst[b[k]]
            if r % sizes[m]:
                return None, ms[-1]
            r //= sizes[m]
            out[m] = Shard(b[k])
    return out, None


def _view(x, shape):
    """A view (``view``, ``_unsafe_view``) of the DTensor ``x``, laid out
    by ``_view_layout``; where a device's block would not stay one block,
    ``x`` is first gathered over the fewest mesh axes, innermost first, as
    a partitioner gathers it.  The step's layouts of views are the
    count's own, not the torch version's (whose rules differ: one
    version shards a dim merged from two split dims, another gathers
    it)."""
    from torch.distributed.tensor import Replicate
    shape = list(shape)
    if -1 in shape:
        i = shape.index(-1)
        shape[i] = x.numel() // max(1, -torch.Size(shape).numel())
    shape = torch.Size(shape)
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        raise NotImplementedError("a view of a pending sum")
    pl = list(x.placements)
    while True:
        out, gather = _view_layout(tuple(x.shape), tuple(shape), pl,
                                   mesh.shape)
        if out is not None:
            break
        pl[gather] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    local = list(shape)
    for m, p in enumerate(out):
        if p.is_shard():
            local[p.dim] //= mesh.shape[m]
    y = x._local_tensor.reshape(local)
    return _wrap(y, mesh, out, shape)


def _einsum(equation, *operands):
    """``torch.einsum`` of DTensors partitioned as a ``dot_general``:
    torch's own einsum merges the batch dims into one for ``bmm``, which a
    device's block of two split dims (the batch over ``data``, the heads
    over ``model``) does not survive, so the count partitions the product
    itself.  On each mesh axis the operand with the most elements names
    the letter split there (none where every operand is replicated); each
    operand holding that letter is split on it, every other operand
    replicated, and the product runs on the local blocks: the output is
    split on the letter where the output has it, else (a contracted
    letter) a pending sum, summed at once (``_summed``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    lhs, out_letters = equation.replace(" ", "").split("->")
    letters = lhs.split(",")
    if "." in equation or len(letters) != len(operands):
        raise NotImplementedError(f"einsum {equation!r} on DTensors")
    mesh = _mesh_of(operands)
    size = {}
    for ls, o in zip(letters, operands):
        size.update(zip(ls, o.shape))

    def placements(o):
        return (list(o.placements) if isinstance(o, DTensor)
                else [Replicate()] * mesh.ndim)
    src = [placements(o) for o in operands]
    if any(p.is_partial() for pl in src for p in pl):
        raise NotImplementedError("einsum of a pending sum")
    split = []
    for m in range(mesh.ndim):
        named = [(o.numel(), -i, ls[pl[m].dim])
                 for i, (ls, o, pl) in enumerate(zip(letters, operands, src))
                 if pl[m].is_shard()]
        split.append(max(named)[2] if named else None)
    locals_ = []
    for ls, o, pl in zip(letters, operands, src):
        want = [Shard(ls.index(t)) if t is not None and t in ls
                else Replicate() for t in split]
        if not isinstance(o, DTensor):
            o = DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if want != pl:
            o = o.redistribute(mesh, want)
        locals_.append(o.to_local())
    out = torch.functional.einsum(f"{lhs}->{out_letters}", *locals_)
    shape = torch.Size(size[t] for t in out_letters)
    pl = [Replicate() if t is None else Shard(out_letters.index(t))
          if t in out_letters else Partial() for t in split]
    return _summed(DTensor.from_local(
        out, mesh, pl, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride()))


def _mesh_of(*ts):
    from torch.distributed.tensor import DTensor
    return next(t.device_mesh for t in _flat(ts) if isinstance(t, DTensor))


def _dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return x if isinstance(x, DTensor) else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _wrap(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _index(x, indices):
    """A row gather ``x[idx]`` (one index tensor, on dim 0: the embedding
    lookup, the MoE dispatch's gathers), partitioned on each mesh axis:
    ``x`` split along its rows gives a masked lookup, each device the rows
    it holds, and a pending sum; split along another dim, the output split
    there; else the output split as ``idx`` is.  ``idx`` is replicated
    where ``x`` is split.  Other index forms are DTensor's (``None``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if len(indices) != 1 or indices[0] is None:
        return None
    mesh = _mesh_of(x, indices[0])
    x, idx = _dtensor(x, mesh), _dtensor(indices[0], mesh)
    ni = idx.ndim
    xp, ip, out = list(x.placements), list(idx.placements), []
    for m, p in enumerate(xp):
        if p.is_shard():
            ip[m] = Replicate()
            out.append(Partial() if p.dim == 0 else Shard(ni + p.dim - 1))
        else:
            out.append(ip[m] if ip[m].is_shard() else Replicate())
    if ip != list(idx.placements):
        idx = idx.redistribute(mesh, ip)
    y = x._local_tensor[idx._local_tensor]
    return _wrap(y, mesh, out, tuple(idx.shape) + tuple(x.shape[1:]))


def _gather(x, dim, index, sparse_grad=False):
    """``torch.gather`` of DTensors (the cross-entropy's pick of each
    target's logit, the MoE's count's backward), partitioned on each mesh
    axis: ``x`` split along ``dim`` gives a masked gather and a pending
    sum (``index`` replicated); split along another dim, ``index`` is cut
    alike and the output split there; else the output split as ``index``
    is, ``x`` cut alike where the two dims have one size."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _mesh_of(x, index)
    x, index = _dtensor(x, mesh), _dtensor(index, mesh)
    dim %= x.ndim
    xp, ip, out = list(x.placements), list(index.placements), []
    for m in range(mesh.ndim):
        d = xp[m].dim if xp[m].is_shard() else (
            ip[m].dim if ip[m].is_shard() else None)
        if d is None:
            out.append(Replicate())
        elif xp[m].is_shard() and d == dim:
            ip[m] = Replicate()
            out.append(Partial())
        elif d != dim and x.shape[d] != index.shape[d]:
            xp[m], ip[m] = Replicate(), Replicate()
            out.append(Replicate())
        else:
            ip[m] = Shard(d)
            xp[m] = Replicate() if d == dim else Shard(d)
            out.append(Shard(d))
    if xp != list(x.placements):
        x = x.redistribute(mesh, xp)
    if ip != list(index.placements):
        index = index.redistribute(mesh, ip)
    y = torch.gather(x._local_tensor, dim, index._local_tensor)
    return _wrap(y, mesh, out, index.shape)


def _scatter(func, x, dim, index, src):
    """``scatter`` / ``scatter_add`` of DTensors (top-k's backward, the
    MoE's expert count), partitioned on each mesh axis: split alike where
    ``x``, ``index`` and ``src`` share a split dim other than ``dim`` (the
    first of them split names it), else all replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh_of(x, index, src)
    ts = tuple(_dtensor(t, mesh) for t in (x, index, src))
    dim %= x.ndim
    out = []
    for m in range(mesh.ndim):
        d = next((t.placements[m].dim for t in ts
                  if t.placements[m].is_shard()), None)
        ok = d is not None and d != dim and len(
            {t.shape[d] for t in ts}) == 1
        out.append(Shard(d) if ok else Replicate())
    x, index, src = (t if list(t.placements) == out
                     else t.redistribute(mesh, out) for t in ts)
    y = func(x._local_tensor, dim, index._local_tensor, src._local_tensor)
    return _wrap(y, mesh, out, x.shape)


def _index_put(x, indices, values, accumulate=False):
    """A row scatter ``x.index_put([idx], values, accumulate)`` (one index
    tensor, on dim 0: the embedding lookup's backward), partitioned on each
    mesh axis: ``idx`` and ``values`` split alike along an index dim, each
    device writes its own rows into ``x`` and the writes are a pending sum
    (``x`` replicated there); ``x`` split along its rows, each device
    keeps the writes to rows it holds (``idx`` and ``values`` replicated);
    ``x`` split along another dim, ``values`` split alike.  Other forms
    are DTensor's (``None``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if len(indices) != 1 or indices[0] is None:
        return None
    mesh = _mesh_of(x, indices[0], values)
    x, idx, values = (_dtensor(t, mesh) for t in (x, indices[0], values))
    ni = idx.ndim
    xp, ip, vp = list(x.placements), list(idx.placements), \
        list(values.placements)
    out = []
    for m in range(mesh.ndim):
        if xp[m].is_shard():
            ip[m] = Replicate()
            vp[m] = Replicate() if xp[m].dim == 0 else \
                Shard(ni + xp[m].dim - 1)
            out.append(xp[m])
        elif ip[m].is_shard():
            vp[m] = Shard(ip[m].dim)
            out.append(Partial())
        else:
            vp[m] = Replicate()
            out.append(Replicate())
    if ip != list(idx.placements):
        idx = idx.redistribute(mesh, ip)
    if vp != list(values.placements):
        values = values.redistribute(mesh, vp)
    y = x._local_tensor.index_put([idx._local_tensor], values._local_tensor,
                                  accumulate)
    return _wrap(y, mesh, out, x.shape)


def _pointwise(func, *args, **kwargs):
    """An elementwise op (``torch.Tag.pointwise``) of DTensors, partitioned
    on each mesh axis: the output is split where the largest operand is
    split (``self``, in place), else where the next largest is (a
    replicated operand is cut to it at no cost), and every operand is
    laid out alike, replicated where it is broadcast.  Ops with a tensor
    list or an ``out=`` are DTensor's (``None``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if "out" in kwargs or any(isinstance(a, (list, tuple)) for a in args):
        return None
    inplace = func._schema.is_mutable
    dts = [a for a in (*args, *kwargs.values()) if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    shape = torch.broadcast_shapes(*(a.shape for a in (*args,
                                                       *kwargs.values())
                                     if isinstance(a, torch.Tensor)))
    ref = args[0] if inplace else max(dts, key=lambda a: a.numel())
    if not isinstance(ref, DTensor) or (inplace and ref.shape != shape):
        return None
    nd = len(shape)
    if any(p.is_partial() for p in ref.placements):
        raise NotImplementedError(f"{func} of a pending sum")
    others = sorted((a for a in dts if a is not ref),
                    key=lambda a: -a.numel())
    out = []
    for m, p in enumerate(ref.placements):
        for a in ([ref] if inplace else [ref, *others]):
            q, off = a.placements[m], nd - a.ndim
            if q.is_shard() and a.shape[q.dim] == shape[q.dim + off]:
                out.append(Shard(q.dim + off))
                break
        else:
            out.append(Replicate())

    def local(a):
        if not isinstance(a, torch.Tensor):
            return a
        a, off = _dtensor(a, mesh), nd - a.ndim
        want = [Shard(p.dim - off) if p.is_shard() and p.dim >= off
                and a.shape[p.dim - off] == shape[p.dim] else Replicate()
                for p in out]
        if want != list(a.placements):
            a = a.redistribute(mesh, want)
        return a._local_tensor
    y = func(*(local(a) for a in args),
             **{k: local(v) for k, v in kwargs.items()})
    return args[0] if inplace else _wrap(y, mesh, out, shape)


def _cat(tensors, dim=0):
    """``torch.cat`` of DTensors, partitioned on each mesh axis: where an
    input is split along the joined dim, every input is gathered there;
    else the inputs take the layout of the largest."""
    from torch.distributed.tensor import Replicate
    mesh = _mesh_of(tensors)
    ts = [_dtensor(t, mesh) for t in tensors]
    dim %= ts[0].ndim
    big = max(ts, key=lambda t: t.numel())
    want = [Replicate() if any(p.is_shard(dim) for p in col) else big_p
            for col, big_p in zip(zip(*(t.placements for t in ts)),
                                  big.placements)]
    ts = [t if list(t.placements) == want else t.redistribute(mesh, want)
          for t in ts]
    shape = list(ts[0].shape)
    shape[dim] = sum(t.shape[dim] for t in ts)
    return _wrap(torch.cat([t._local_tensor for t in ts], dim), mesh, want,
                 shape)


def _split(x, sizes, dim=0):
    """``split`` / ``split_with_sizes`` of a DTensor, partitioned on each
    mesh axis: gathered where it is split along the dim it is cut on, the
    pieces laid out as ``x`` elsewhere."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    dim %= x.ndim
    want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(mesh, want)
    n = x.shape[dim]
    sizes = ([sizes] * (-(-n // sizes)) if isinstance(sizes, int)
             else list(sizes))
    out, at = [], 0
    for k in sizes:
        k = min(k, n - at)
        shape = list(x.shape)
        shape[dim] = k
        local = x._local_tensor.narrow(dim, at, k)
        out.append(_wrap(local, mesh, want, shape))
        at += k
    return out


@contextlib.contextmanager
def _einsum_partitioned():
    """Inside the block, ``torch.einsum`` of DTensors runs as ``_einsum``
    wherever the step calls it: in the models, in an autograd function's
    forward and backward; other calls run as before."""
    from torch.distributed.tensor import DTensor
    saved = torch.einsum

    def einsum(*args, **kwargs):
        if any(isinstance(a, DTensor) for a in _flat(args[1:])):
            return _einsum(*args, **kwargs)
        return saved(*args, **kwargs)
    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = saved


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    if not isinstance(group_name, str):
        return group_name.size()
    return _resolve_process_group(group_name).size()


class _Placer:
    """The step's arguments as DTensors of meta local tensors on
    ``mesh.device_mesh``, laid out by the sharding rules: parameters and
    AdamW's moments by ``param_shardings``, the batch by
    ``batch_shardings``, the decode state by ``decode_state_shardings``,
    the step counter replicated, and the decode token as the reference
    places it (over the batch axes when they divide it, else
    replicated)."""

    def __init__(self, model: Model, mesh):
        self.mesh = mesh
        self.psh = param_shardings(model.init_abstract(), model.param_axes(),
                                   mesh)

    def _dt(self, x, sh, dtype=None):
        from torch.distributed.tensor import DTensor
        dm = self.mesh.device_mesh
        local = torch.empty(sh.local_shape, dtype=dtype or x.dtype,
                            device="meta")
        return DTensor.from_local(local, dm, to_placements(sh.spec, dm),
                                  run_check=False, shape=torch.Size(sh.shape),
                                  stride=torch.empty(sh.shape,
                                                     device="meta").stride())

    def params(self, tree):
        return tree_map(self._dt, tree, self.psh)

    def unshard(self, params):
        """FSDP's gather: each parameter replicated over the data axes
        (``pod``, ``data``) and kept sharded over ``model``, once a step,
        before its first use; its gradient, summed over the batch where
        the product makes it (``_summed``), is cut back to the
        parameter's layout."""
        names = self.mesh.device_mesh.mesh_dim_names
        from torch.distributed.tensor import Replicate

        def gather(p):
            pl = [Replicate() if names[i] in ("pod", "data") else x
                  for i, x in enumerate(p.placements)]
            return p.redistribute(p.device_mesh, pl)
        return tree_map(gather, params)

    def opt_state(self, params):
        def moment(p, sh):
            return self._dt(p, sh, torch.float32)
        step = self._dt(torch.empty((), dtype=torch.int32, device="meta"),
                        Sharding(P(), (), ()))
        return OptState(m=tree_map(moment, params, self.psh),
                        v=tree_map(moment, params, self.psh), step=step)

    def batch(self, tree):
        return tree_map(self._dt, tree, batch_shardings(tree, self.mesh))

    def decode_state(self, tree):
        return tree_map(self._dt, tree,
                        decode_state_shardings(tree, self.mesh))

    def token(self, t):
        sizes = self.mesh.shape
        axes = tuple(a for a in ("pod", "data") if a in sizes)
        n = 1
        for a in axes:
            n *= sizes[a]
        spec = P(axes if len(axes) > 1 else axes[0]) \
            if axes and t.shape[0] % n == 0 else P()
        local = tuple(t.shape[0] // n if (i == 0 and spec) else d
                      for i, d in enumerate(t.shape))
        return self._dt(t, Sharding(spec, tuple(t.shape), local))


@contextlib.contextmanager
def placed_mesh(mesh):
    """A ``PlacedMesh`` of ``mesh`` (an ``AbstractMesh``, or anything with
    ``axis_names`` and ``axis_sizes``) over a ``"fake"`` process group of
    its size, which issues no communication: the ``DeviceMesh`` has the
    mesh's axis names and the ``meta`` device type.  The group is torn
    down when the block exits, however it exits.  Raises if a process
    group is initialized already: the fake one would replace it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("placed_mesh: a process group is initialized "
                           "already; the collective count needs its own")
    size = mesh.size
    # DTensor warns of every two-step sum over a 2-axis mesh; a count
    # bills them and needs no advice
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        log.setLevel(logging.ERROR)
        dm = DeviceMesh("cpu", torch.arange(size).view(mesh.axis_sizes),
                        mesh_dim_names=tuple(mesh.axis_names))
        with _all_to_all_on_cpu_mesh(), _greedy_redistribution_plans():
            yield PlacedMesh(mesh, dm)
    finally:
        log.setLevel(level)
        dist.destroy_process_group()


@contextlib.contextmanager
def _greedy_redistribution_plans():
    """Inside the block, DTensor plans every redistribution greedily, one
    mesh axis at a time, as it plans those of plain ``Shard`` layouts, in
    every torch version: the same moves for the same layouts, and no
    search over the states of a 3-axis mesh (which takes minutes for one
    product).  A layout the greedy planner cannot walk raises."""
    from torch.distributed.tensor import _redistribute as rd
    if not hasattr(rd, "get_redistribute_planner"):
        raise RuntimeError(f"torch {torch.__version__}: no greedy "
                           "redistribution planner to count with")

    def greedy(src_spec, dst_spec, use_graph_based_transform=None):
        return rd.get_redistribute_planner(
            src_spec.device_mesh, src_spec.tensor_meta
        ).generate_greedy_transform_infos(src_spec, dst_spec)

    saved = rd._gen_transform_infos_non_cached
    rd._gen_transform_infos_non_cached = greedy
    rd._gen_transform_infos.cache_clear()
    try:
        yield
    finally:
        rd._gen_transform_infos_non_cached = saved
        rd._gen_transform_infos.cache_clear()


@contextlib.contextmanager
def _all_to_all_on_cpu_mesh():
    """Inside the block, DTensor moves a tensor from one sharded dimension
    to another (Shard(i) -> Shard(j) on one mesh axis) by its all-to-all
    op, ``_dtensor.shard_dim_alltoall``, as it does on a card's mesh; on a
    ``cpu`` mesh it would all-gather and keep a chunk, since gloo has no
    all-to-all."""
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    if not hasattr(pt, "shard_dim_alltoall"):
        raise RuntimeError("torch.distributed.tensor.placement_types has no "
                           "shard_dim_alltoall to bill as an all-to-all")
    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = saved


def count_step_collectives(cfg, kind: str, seq: int, global_batch: int,
                           pmesh) -> tuple[dict[str, float], int]:
    """``({kind: wire bytes a device}, number of collectives)`` of one
    ``kind`` step of ``cfg`` at its own depth, run as a DTensor program on
    ``pmesh`` (a ``PlacedMesh``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_strategies()
    model = Model(cfg, device="meta")
    place = _Placer(model, pmesh)
    mode = _counting_mode()()
    with use_mesh(pmesh), implicit_replication(), mode, \
            _einsum_partitioned():
        _run_step(model, kind, seq, global_batch, place)
    return dict(mode.by_kind), mode.n


@functools.cache
def _register_strategies() -> None:
    """Sharding strategies for ops the count's rules (``_counting_mode``)
    leave to DTensor, where it has none or a version's differs
    (``register_sharding``; once a process, and they apply to DTensors
    alone).  The count runs on meta tensors, so a strategy has to be right
    about layouts and communication, not about values:

    * ``aten.logsumexp`` (the cross-entropy's normalizer over the vocab):
      DTensor gathers a reduced dimension that is sharded, the whole f32
      logits; here each shard reduces its part and the (B, S) results
      are combined by one all-reduce (``Partial``), as a partitioner
      combines the shards' maxima and sums.
    * ops some torch versions give no strategy (2.11 has none for these),
      registered in every version so that the count does not depend on
      it: ``aten.index_put_`` (the MoE dispatch's writes; all replicated,
      or ``self`` and the values sharded alike past the indexed
      dimensions), ``aten.cummax`` and ``aten.flip`` (the plain
      ``wc_combine``'s run starts, ``combine._cummin_reverse``; sharded
      on any other dimension), and ``aten.softplus_backward`` and
      ``aten.detach_`` (sharded alike on any dimension, a broadcast one
      replicated).
    * ``aten.constant_pad_nd`` (the causal conv's left pad of the sequence,
      recurrentgemma's and mamba2's blocks): sharded alike on any
      dimension it does not pad.  Torch 2.11's own strategy gathers the
      input and labels the result with one placement on a 2-axis mesh,
      which the next product then misreads.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.logsumexp.default)
    def logsumexp(input, dim, *rest):
        nd = len(input.shape)
        dims = sorted(d % nd for d in dim)
        keepdim = bool(rest and rest[0])
        tail = [None] * (1 + len(rest))
        out = [([Replicate()], [Replicate()] + tail)]
        for d in range(nd):
            if d in dims:
                out.append(([Partial()], [Shard(d)] + tail))
            else:
                od = d if keepdim else d - sum(x < d for x in dims)
                out.append(([Shard(od)], [Shard(d)] + tail))
        return out

    @register_sharding(aten.index_put_.default)
    def index_put_(self, indices, values, *rest):
        n_idx = sum(i is not None for i in indices)
        tail = [None] * len(rest)

        def one(sv, i, v):
            return [sv], [sv] + [i] * n_idx + [v] + tail
        out = [one(Replicate(), Replicate(), Replicate())]
        if all(i is not None for i in indices):
            nd = max(len(i.shape) for i in indices)
            for k in range(len(indices), len(self.shape)):
                vk = nd + k - len(indices)
                if vk < len(values.shape) and \
                        values.shape[vk] == self.shape[k]:
                    out.append(one(Shard(k), Replicate(), Shard(vk)))
        return out

    def along_others(dims):
        def strategy(input, dim, *rest):
            nd = len(input.shape)
            skip = {d % nd for d in ([dim] if isinstance(dim, int)
                                     else dim)}
            n_out = len(dims)
            tail = [None] * (1 + len(rest))
            return [([Replicate()] * n_out, [Replicate()] + tail)] + [
                ([Shard(d)] * n_out, [Shard(d)] + tail)
                for d in range(nd) if d not in skip]
        return strategy

    @register_sharding(aten.constant_pad_nd.default)
    def constant_pad_nd(input, pad, *rest):
        nd = len(input.shape)
        padded = {nd - 1 - i // 2 for i, p in enumerate(pad) if p}
        tail = [None] * (1 + len(rest))
        return [([Replicate()], [Replicate()] + tail)] + [
            ([Shard(d)], [Shard(d)] + tail)
            for d in range(nd) if d not in padded]

    register_sharding(aten.cummax.default)(along_others((0, 1)))
    register_sharding(aten.flip.default)(along_others((0,)))

    def elementwise(*args, **kwargs):
        shapes = [a.shape for a in args if hasattr(a, "shape")]
        out_shape = torch.broadcast_shapes(*shapes)
        nd = len(out_shape)

        def on(a, d):
            if not hasattr(a, "shape"):
                return None
            k = d - (nd - len(a.shape))
            return Shard(k) if k >= 0 and a.shape[k] == out_shape[d] \
                else Replicate()
        out = [([Replicate()], [Replicate() if hasattr(a, "shape") else None
                                for a in args])]
        out += [([Shard(d)], [on(a, d) for a in args])
                for d in range(nd) if out_shape[d] > 1]
        return out

    for op in (aten.softplus_backward.default, aten.detach_.default):
        register_sharding(op)(elementwise)



# qwen3-0.6b's smoke config (2 layers, d 128, 4 heads over 2 kv heads, ff
# 256, vocab 512) at B 4 x S 32 on a 2 x 4 (``data``, ``model``) mesh:
# ``(coll_by_kind, n_collectives)`` of its prefill and train step under
# this module's rules (``tests/test_torch_collectives.py`` derives them
# from the shapes)
SMOKE = {"prefill": ({"all-gather": 115968.0, "all-reduce": 122880.0}, 16),
         "train": ({"all-gather": 214272.0, "all-reduce": 708820.0}, 76)}


@functools.cache
def check_torch() -> str:
    """Counts ``SMOKE``'s steps and raises unless they equal it: DTensor
    runs every op the count's rules leave to it, and its strategies change
    between torch versions, so a version that counts the smoke steps
    otherwise is refused.  Once a process; returns the version."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    cfg = get_config("qwen3-0.6b", smoke=True)
    with placed_mesh(AbstractMesh(("data", "model"), (2, 4))) as pm:
        got = {k: count_step_collectives(cfg, k, 32, 4, pm) for k in SMOKE}
    if got != SMOKE:
        raise RuntimeError(f"torch {torch.__version__} counts qwen3-0.6b's "
                           f"smoke steps as {got}, not {SMOKE}: the "
                           f"collective count is not checked under it")
    return torch.__version__


def count_collectives(cfg, kind: str, seq: int, global_batch: int,
                      mesh) -> dict:
    """The collectives of one ``kind`` step of ``cfg`` on ``mesh`` (an
    ``AbstractMesh``) at the full depth, scaled from one and two blocks as
    ``count_flops`` scales (the attention as one chunk too: the chunked
    loop slices q, k and v along the sequence, which no mesh axis splits,
    and moves the same; ``tests/test_torch_collectives.py``), under a
    torch that passes ``check_torch``: ``{"coll_bytes_per_chip",
    "coll_by_kind", "n_collectives"}``."""
    check_torch()
    cfg = dataclasses.replace(cfg, attn_chunk=max(seq, cfg.attn_chunk))
    with placed_mesh(mesh) as pmesh:
        n = {k: count_step_collectives(dataclasses.replace(cfg, n_layers=L),
                                       kind, seq, global_batch, pmesh)
             for k, L in _depths(cfg).items()}
    return _scaled(cfg, n)


def _scaled(cfg, n: dict) -> dict:
    kinds = sorted(set().union(*(by for by, _ in n.values())))
    by_kind = {k: _full_depth(cfg, **{d: by.get(k, 0.0)
                                      for d, (by, _) in n.items()})
               for k in kinds}
    return {"coll_bytes_per_chip": sum(by_kind.values()),
            "coll_by_kind": by_kind,
            "n_collectives": _full_depth(cfg, **{d: c for d, (_, c)
                                                 in n.items()})}
