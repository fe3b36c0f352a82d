"""Mixture-of-Experts layer (port of ``repro.models.moe``): shared + routed
experts, top-k routing and sort-based capacity grouping.

The dispatch is the same primitive as CIDER's global write combining:
flatten the (token, expert) assignments, sort them stably by expert, rank
each inside its expert's run, and gather each expert's tokens into a
contiguous (E, C, D) block, so that each expert runs one grouped matmul.
The rank goes through ``core.combine._first_last_rank``, the seam that
launches the ``wc_combine`` kernel on a card (tallied under the launch tag
``"moe_dispatch"``).  Tokens beyond an expert's capacity are dropped
(GShard-style).

``rows > 1`` groups each of ``rows`` equal token blocks on its own (the
reference ``vmap``s ``_routed_ffn`` over the rows): here the rows are a
batch axis written out, grouped in one sort and one rank launch with
row-major expert ids ``row * E + e``, whose runs are the per-row runs.

Where the reference's combine scatter-adds a token's k contributions in
bf16 in lane order (``.at[src_tok].add``), the port adds the k terms of
each token one after another in bf16: the same sums in the same order,
deterministic (an ``index_add_`` on a card adds by atomics in no fixed
order).

``pinned_routing`` records the expert choices of a run, or replays them
in another: a near-tie between two experts' gates flips under any change
of rounding (card against CPU, a one-token decode against a prefill, XLA
against PyTorch), and a flipped token moves by far more than a logit
tolerance, so comparisons of two runs route both alike.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core.combine import _first_last_rank, lexsort2
from repro_torch.dist.ctx import shard
from repro_torch.kernels.build import launch_tag

__all__ = ["route_topk", "moe_ffn", "moe_capacity", "pinned_routing"]

_PINS: list = []    # the active pinned_routing hooks, innermost last


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 factor: float = 1.25) -> int:
    c = int(n_tokens * top_k * factor / n_experts) + 1
    # 128-aligned, as the reference sizes it for its matrix units and mesh
    return max(128, (c + 127) // 128 * 128)


def route_topk(logits: torch.Tensor, top_k: int):
    """logits: (..., E) -> (weights (..., k) f32, softmaxed over the chosen;
    experts (..., k) int32).  A stable descending sort picks the k largest
    gates, so that equal gates go to the lower expert first, as
    ``lax.top_k`` orders them."""
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    w, ix = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, ix = w[..., :top_k], ix[..., :top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ix.to(torch.int32)


@contextlib.contextmanager
def pinned_routing(record: list | None = None, replay=None):
    """Inside the block, every routed MoE call appends its expert choices
    (a CPU int32 tensor of the call's (R, T, k) shape) to ``record``; or,
    given ``replay`` (such tensors or arrays, one a call in call order),
    takes those choices instead, weighted by its own softmaxed gates.
    Yields ``[flips, choices]``: of the token choices replayed, how many
    the call would have made otherwise.  Raises if replayed choices are
    left over."""
    queue = None if replay is None else list(replay)
    flips = [0, 0]

    def pin(logits, w, ix):
        if queue is None:
            record.append(ix.cpu())
            return w, ix
        want = torch.as_tensor(queue.pop(0)).to(ix.device).reshape(ix.shape)
        flips[0] += int((ix.sort(-1).values != want.sort(-1).values)
                        .any(-1).sum())
        flips[1] += want[..., 0].numel()
        w = torch.softmax(logits.to(torch.float32), -1).gather(
            -1, want.long())
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), \
            want.to(torch.int32)

    _PINS.append(pin)
    try:
        yield flips
    finally:
        _PINS.remove(pin)
    if queue:
        raise RuntimeError(f"{len(queue)} replayed routing choices unused")


def _group_by_expert(expert_ids: torch.Tensor, n_experts: int,
                     capacity: int):
    """expert_ids: (T*k,) int32 -> (slot (T*k,) int32, the destination in
    [0, E*C), or E*C when dropped; dropped (T*k,) bool).  Stable sort by
    expert, then each lane's rank in its expert's run (``wc_combine``)."""
    tk = expert_ids.shape[0]
    pos = torch.arange(tk, dtype=torch.int32, device=expert_ids.device)
    order = lexsort2(pos, expert_ids)
    with launch_tag("moe_dispatch"):
        _, _, rank_sorted = _first_last_rank(expert_ids[order].contiguous(),
                                             "auto")
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    dropped = rank >= capacity
    slot = torch.where(dropped, n_experts * capacity,
                       expert_ids * capacity + rank)
    return slot.to(torch.int32), dropped


def _routed_ffn(x: torch.Tensor, router_w, experts_gate, experts_up,
                experts_down, top_k: int, cap: int):
    """Dispatch, grouped expert matmuls and combine for ``rows`` token
    blocks.  x: (R, T, D).  Returns (y (R, T, D), aux (R,) f32)."""
    r, t, d = x.shape
    e = experts_gate.shape[0]
    logits = x @ router_w                                   # (R, T, E)
    w, ix = route_topk(logits, top_k)                       # (R, T, k)
    if _PINS:
        w, ix = _PINS[-1](logits, w, ix)
    me = torch.softmax(logits.to(torch.float32), -1).mean(1)
    ce = torch.zeros((r, e), dtype=torch.float32, device=x.device
                     ).scatter_add(1, ix.reshape(r, -1).long(),
                                   torch.ones((r, t * top_k),
                                              dtype=torch.float32,
                                              device=x.device))
    aux = e * (me * (ce / (t * top_k))).sum(-1)
    # ---- dispatch: sort-group (the global-WC primitive) ----
    row = torch.arange(r, dtype=torch.int32, device=x.device)[:, None]
    slot, dropped = _group_by_expert((ix.reshape(r, -1) + row * e).reshape(-1),
                                     r * e, cap)
    src_tok = torch.arange(r * t, device=x.device).repeat_interleave(top_k)
    xg = x.new_zeros((r * e * cap + 1, d))
    xg[slot.long()] = x.reshape(r * t, d)[src_tok]   # dropped: the last row
    xg = xg[:-1].view(r, e, cap, d).transpose(0, 1).reshape(e, r * cap, d)
    # ---- expert computation: grouped matmuls ----
    hg = F.silu(torch.bmm(xg, experts_gate)) * torch.bmm(xg, experts_up)
    yg = torch.bmm(hg, experts_down)                        # (E, R*C, D)
    y_slot = yg.view(e, r, cap, d).transpose(0, 1).reshape(r * e * cap, d)
    # ---- combine: each token's k weighted contributions, in lane order ----
    wk = torch.where(dropped, 0.0, w.reshape(-1)).to(yg.dtype)
    contrib = (y_slot[torch.where(dropped, 0, slot).long()] * wk[:, None]
               ).view(r, t, top_k, d)
    y = contrib[:, :, 0]
    for j in range(1, top_k):
        y = y + contrib[:, :, j]
    return y, aux


def moe_ffn(x: torch.Tensor, router_w, experts_gate, experts_up,
            experts_down, shared_gate=None, shared_up=None, shared_down=None,
            *, top_k: int, capacity_factor: float = 1.25, rows: int = 1):
    """x: (T, D); experts_*: (E, D, F) / (E, F, D).  Returns ((T, D) in x's
    dtype, aux_loss f32 scalar)."""
    t, d = x.shape
    e = experts_gate.shape[0]
    x = shard(x, ("act_tokens", None))
    if rows > 1 and t % rows == 0:
        cap = moe_capacity(t // rows, e, top_k, capacity_factor)
        xr = shard(x.reshape(rows, t // rows, d), ("act_rows", None, None))
        y, aux = _routed_ffn(xr, router_w, experts_gate, experts_up,
                             experts_down, top_k, cap)
        y = shard(y, ("act_rows", None, None)).reshape(t, d)
        aux = aux.mean()
    else:
        cap = moe_capacity(t, e, top_k, capacity_factor)
        y, aux = _routed_ffn(x[None], router_w, experts_gate, experts_up,
                             experts_down, top_k, cap)
        y, aux = y[0], aux[0]
    y = shard(y, ("act_tokens", None))
    if shared_gate is not None:
        hs = F.silu(x @ shared_gate) * (x @ shared_up)
        y = y + hs @ shared_down
    return y.to(x.dtype), aux
