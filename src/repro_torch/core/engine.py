"""The CIDER batched dataplane engine (§4; port of ``repro.core.engine``).

Executes one *synchronization window* — a batch of concurrent KV ops —
against a pointer store under one of four synchronization schemes: OSYNC
(optimistic CAS-retry), SPIN (CAS spinlock + backoff), MCS (ShiftLock) and
CIDER (global write-combining + contention-aware credits).

* **Semantic equivalence**: all four modes produce the same logical store
  state and per-op results; the canonical serialization is queue order ==
  batch position (``OpBatch.pos``).
* **Exact I/O metering**: the modes differ only in the RDMA-verb bill they
  would issue on real disaggregated memory, metered exactly per wait queue.

Per-queue cost (m = effective concurrent UPDATE writers in the window):

  OSYNC : m heap WRITEs + m(m+1)/2 CAS
  SPIN  : m WRITEs + m ptr-CAS + m lock-CAS + m unlock-CAS + backoff polls
  MCS   : m enqueue-CAS + m WRITEs + m ptr-CAS + m epoch-FAA + 2(m-1) CN msgs
  CIDER : m enqueue-CAS + 1 tail-READ + 1 WRITE + 1 ptr-CAS + m epoch-FAA
          + (m+1) CN msgs                 (m>1; m==1 falls back to MCS cost)

Steps of ``apply_batch`` (numbered as in the reference): 1 linearize,
2 commit, 3 credit split, 4 local write combining, 5 metering, 5b orphaned-
lock repair, 5c SCAN reader probes, 5d replica fan-out, 6 credit feedback,
7 epoch FAA.  Every function is pure: it returns new tensors and leaves its
inputs untouched.  The reference's scatters with ``mode="drop"`` become
explicit masks (torch raises on an out-of-range index where JAX drops it),
and its clamped gathers explicit clamps.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import combine as wc
from repro_torch.core.credits import (CreditState, credit_decide,
                                      credit_feedback, credit_slot)
from repro_torch.core.types import (NULL_PTR, EngineConfig, IOMetrics, OpBatch,
                                    OpKind, SyncMode, as_device, as_i32)
from repro_torch.kernels.scan_probe.ops import (scan_probe_cuda,
                                                scan_probe_ref)

__all__ = ["StoreState", "Results", "store_init", "store_view", "apply_batch",
           "populate", "pack_meta"]

_NONE = -1
_I32 = torch.int32
_VER_MASK = 0xF            # the 4-bit version field of Fig 8
_STRANDED_SHIFT = 4


def pack_meta(ver: torch.Tensor, stranded: torch.Tensor) -> torch.Tensor:
    """Pack the 4-bit DELETE version (bits 0-3) and the orphaned-lock node
    count (bits 4-31) into one int32 word per slot."""
    return ver | (stranded << _STRANDED_SHIFT)


@dataclasses.dataclass
class StoreState:
    """The memory-pool resident state."""
    ptr: torch.Tensor       # (n_slots,) int32 heap index, NULL_PTR if empty
    meta: torch.Tensor      # (n_slots,) int32 packed version + stranded count
    epoch: torch.Tensor     # (n_slots,) int32 lock epoch (§4.6)
    heap: torch.Tensor      # (heap_slots,) int32 out-of-place value payloads
    heap_top: torch.Tensor  # () int32 bump cursor

    @property
    def ver(self) -> torch.Tensor:
        return self.meta & _VER_MASK

    @property
    def stranded(self) -> torch.Tensor:
        return self.meta >> _STRANDED_SHIFT


@dataclasses.dataclass
class Results:
    ok: torch.Tensor           # (B,) bool — success (IDU) / found (SEARCH)
    value: torch.Tensor        # (B,) int32 — SEARCH payload, -1 if absent
    pessimistic: torch.Tensor  # (B,) bool — CIDER path decision
    combined: torch.Tensor     # (B,) bool — write combined away by WC
    wc_batch: torch.Tensor     # (B,) int32 — wait-queue length at execution
    retries: torch.Tensor      # (B,) int32 — CAS retries / backoff polls
    rank: torch.Tensor         # (B,) int32 — wait-queue rank at execution
    orphan_wait: torch.Tensor  # (B,) int32 — orphaned locks waited on
    rows: torch.Tensor         # (B,) int32 — SCAN rows found


def store_init(cfg: EngineConfig, device: str | torch.device = "cuda"
               ) -> StoreState:
    dev = as_device(device)
    return StoreState(
        ptr=torch.full((cfg.n_slots,), NULL_PTR, dtype=_I32, device=dev),
        meta=torch.zeros((cfg.n_slots,), dtype=_I32, device=dev),
        epoch=torch.zeros((cfg.n_slots,), dtype=_I32, device=dev),
        heap=torch.full((cfg.heap_slots,), _NONE, dtype=_I32, device=dev),
        heap_top=torch.zeros((), dtype=_I32, device=dev))


def populate(cfg: EngineConfig, state: StoreState, keys, values) -> StoreState:
    """Bulk-load KV pairs (the paper pre-populates 60M items, §5.1)."""
    dev = state.ptr.device
    keys = as_i32(keys, dev).long()
    values = as_i32(values, dev)
    n = keys.shape[0]
    if n > cfg.heap_slots:
        raise ValueError(
            f"populate: {n} pairs exceed heap_slots={cfg.heap_slots}")
    loc = state.heap_top + torch.arange(n, dtype=_I32, device=dev)
    heap = state.heap.clone()
    heap[loc.long()] = values
    ptr = state.ptr.clone()
    ptr[keys] = loc
    return dataclasses.replace(state, ptr=ptr, heap=heap,
                               heap_top=state.heap_top + n)


def _heap_at(heap: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``heap[p]`` with the index clamped into range, as a JAX gather does
    (a pointer past a full heap reads its last payload)."""
    return heap[torch.clamp(p, 0, heap.shape[0] - 1).long()]


def store_view(state: StoreState):
    """Logical ``(exists, value)`` view — what tests compare across modes."""
    exists = state.ptr != NULL_PTR
    return exists, torch.where(exists, _heap_at(state.heap, state.ptr), _NONE)


def _last_before(marker, code):
    """Per lane: the ``code`` of the last marked lane STRICTLY before it
    (globally), or -1; ``code`` must grow with the lane index."""
    g = torch.cummax(torch.where(marker, code, -1), 0).values
    return torch.cat([torch.full((1,), -1, dtype=_I32, device=g.device), g[:-1]])


def _probe_sweep(keys_sorted, setcode, writer, e_init, backend):
    """The fused probe pass (existence-before + reader waits over sorted
    lanes) through the kernel seam: ``scan_probe`` or its plain version."""
    if wc.resolve_backend(backend, keys_sorted.device) == "cuda":
        return scan_probe_cuda(keys_sorted, setcode, writer, e_init)
    return scan_probe_ref(keys_sorted, setcode, writer, e_init)


def _backoff_polls(wait_rounds, cap: int):
    """Truncated-exponential-backoff poll count while waiting ``wait_rounds``
    rounds: probes at 1, 2, 4, ..., 2^cap, 2^cap, ...

    The reference computes ``ceil(log2(max(w, 1) + 1))`` capped at ``cap``,
    plus ``floor(max(w - (2^cap - 1), 0) / 2^cap)``, in float32.  For an
    integer ``w >= 1``, ``ceil(log2(w + 1))`` is the bit length of ``w``,
    and its cap is the number of ``b < cap`` with ``w >= 2^b``; the linear
    term is a shift.  Integer arithmetic gives the same counts with no
    ``log2`` rounding at powers of two (tested over ``w`` in [0, 2^20])."""
    w = wait_rounds.to(_I32)
    exp_phase = torch.zeros_like(w)
    for b in range(min(cap, 31)):
        exp_phase += (w >= 2**b).to(_I32)
    if cap < 31:
        linear = torch.clamp(w - (2**cap - 1), min=0) >> cap
    else:          # 2^cap - 1 exceeds every int32 wait: no linear phase
        linear = torch.zeros_like(w)
    return torch.where(w > 0, exp_phase + linear, 0).to(_I32)


def _scatter_set(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """A copy of ``dst`` with ``dst[idx] = src`` on the lanes of ``mask``
    whose index is in range — the reference's ``.at[].set(mode="drop")``;
    the kept lanes' indices are distinct.  The other lanes write a spare
    slot past the end, so no boolean mask sizes a tensor (which would make
    the host wait for the device)."""
    n = dst.shape[0]
    keep = mask & (idx >= 0) & (idx < n)
    out = torch.cat([dst, dst.new_zeros(1)])
    out[torch.where(keep, idx, n).long()] = src
    return out[:n]


def apply_batch(cfg: EngineConfig, state: StoreState, credits: CreditState,
                batch: OpBatch, valid=None, owned=None, slot_base=None,
                alive=None, died=None):
    """Execute one synchronization window; returns ``(state, credits,
    results, io)``.

    ``alive`` (``(n_cns,)`` bool) masks the compute nodes alive through this
    window and ``died`` those that crashed at it: ops of non-alive CNs are
    dropped, and the pessimistic writes of newly-died CNs strand orphaned
    locks that the next surviving waiter repairs (step 5b).

    Sharded execution (``repro_torch.dist.store``): ``owned`` masks the ops
    whose key's slot lives in this shard and ``slot_base`` (an int) is the
    shard's first global slot, so store arrays are indexed by
    ``keys - slot_base``.  The data plane (linearization, commits, results,
    metering) runs on the owned lanes; the credit plane (steps 3 and 6) runs
    on the full window with global keys, so every shard's replica of the
    credit table evolves identically.  Lanes a shard does not own come out
    as each ``Results`` field's neutral element (``value`` -1, ``wc_batch``
    1, the rest 0/False), so a sum over shards reassembles the results.
    """
    b = batch.kinds.shape[0]
    dev = batch.kinds.device
    kinds, keys, values, pos, cn = (batch.kinds, batch.keys, batch.values,
                                    batch.pos, batch.cn)
    if valid is None:
        valid = kinds != OpKind.NOP
    else:
        valid = valid & (kinds != OpKind.NOP)
    if cfg.scan_max == 0:
        # no probe capacity: SCAN lanes are dropped (point-op stores reject
        # them before they reach the engine)
        valid = valid & (kinds != OpKind.SCAN)
    present = valid
    if alive is not None:
        valid = valid & alive[torch.clamp(cn, 0, alive.shape[0] - 1).long()]
    # valid: the window's live ops (credit plane); valid_o: the ops whose
    # slot this shard owns (data plane).  The same lanes when unsharded.
    valid_o = valid if owned is None else valid & owned
    base = 0 if slot_base is None else int(slot_base)
    is_insert = (kinds == OpKind.INSERT) & valid_o
    is_update = (kinds == OpKind.UPDATE) & valid_o
    is_delete = (kinds == OpKind.DELETE) & valid_o
    upd_full = (kinds == OpKind.UPDATE) & valid

    # ---- 1. linearize: one sorted last-setter sweep serializes every slot
    plan_all = wc.plan_combine(keys, pos, valid_o, backend=cfg.kernel_backend)
    perm = plan_all.perm.long()
    idx = torch.arange(b, dtype=_I32, device=dev)
    seg_start = idx - plan_all.rank
    seg_end = seg_start + plan_all.run_length - 1
    seg_start_l, seg_end_l = seg_start.long(), seg_end.long()
    ks = kinds[perm]
    vals = values[perm]
    v_sorted = valid_o[perm]
    ins_s = v_sorted & (ks == OpKind.INSERT)
    upd_s = v_sorted & (ks == OpKind.UPDATE)
    del_s = v_sorted & (ks == OpKind.DELETE)
    # incoming (pre-window) state of each sorted lane's (shard-local) slot
    slot = torch.clamp(keys[perm] - base, 0, cfg.n_slots - 1)
    slot_l = slot.long()
    p = state.ptr[slot_l]
    e_init = p != NULL_PTR
    v_init = torch.where(e_init, _heap_at(state.heap, p), _NONE)
    # existence BEFORE each op: the last INSERT/DELETE strictly before it in
    # its run, else the slot's pre-window bit
    setcode = torch.where(ins_s, 1, torch.where(del_s, 0, -1)).to(_I32)
    g_excl = _last_before(setcode >= 0, 2 * idx + setcode)
    has = (g_excl >= 0) & ((g_excl >> 1) >= seg_start)
    e_before = torch.where(has, (g_excl & 1) == 1, e_init)
    # value BEFORE each op: the last value-writing event strictly before it
    w_ev = (ins_s & ~e_before) | ((upd_s | del_s) & e_before)
    val_w = torch.where(del_s, _NONE, vals)
    gv_excl = _last_before(w_ev, idx)
    hasv = (gv_excl >= 0) & (gv_excl >= seg_start)
    v_before = torch.where(hasv, val_w[torch.clamp(gv_excl, min=0).long()],
                           v_init)
    upd_or_del = (ks == OpKind.UPDATE) | (ks == OpKind.DELETE)
    ok_s = torch.where(ks == OpKind.SEARCH, e_before,
                       torch.where(ks == OpKind.INSERT, ~e_before,
                                   upd_or_del & e_before))
    ok_s = ok_s & v_sorted
    val_s = torch.where((ks == OpKind.SEARCH) & e_before & v_sorted,
                        v_before, _NONE)
    # state AFTER each op (at run tails: the new slot contents)
    e_fin = torch.where(setcode >= 0, setcode == 1, e_before)
    v_fin = torch.where(w_ev, val_w, v_before)
    sc_i = (ok_s & (ks != OpKind.SEARCH)).to(_I32)   # any successful IDU
    cw = wc.cumsum_i32(sc_i)
    seg_any_write = (cw[seg_end_l] - (cw - sc_i)[seg_start_l]) > 0

    # ---- 2. commit final slot states (one out-of-place write per queue);
    # commits past the heap's end are dropped, as in the reference
    tail = plan_all.is_last & seg_any_write & v_sorted
    tail_i = tail.to(_I32)
    n_commits = wc.sum_i32(tail_i)
    loc = state.heap_top + wc.cumsum_i32(tail_i) - 1
    heap = _scatter_set(state.heap, loc, v_fin, tail)
    ptr = _scatter_set(state.ptr, slot, torch.where(e_fin, loc, NULL_PTR),
                       tail)
    # version: +1 per successful DELETE (mod 16 — the 4-bit field of Fig 8)
    ds_i = (del_s & ok_s).to(_I32)
    cd = wc.cumsum_i32(ds_i)
    run_del = cd[seg_end_l] - (cd - ds_i)[seg_start_l]
    ver = state.ver.index_add(0, slot_l,
                              torch.where(plan_all.is_last, run_del, 0)) % 16

    # ---- 3. synchronization-mode decision (CIDER credit split, §4.3), on
    # the FULL window so every shard's credit table sees every op
    table = credits.credit.shape[0]
    if cfg.mode == SyncMode.CIDER:
        credits2, pess_full = credit_decide(credits, keys, upd_full, table)
    elif cfg.mode in (SyncMode.MCS, SyncMode.SPIN):
        credits2, pess_full = credits, upd_full
    else:  # OSYNC
        credits2, pess_full = credits, torch.zeros_like(upd_full)
    pess = pess_full if owned is None else pess_full & valid_o
    opt_upd = is_update & ~pess_full

    # ---- 4. effective writers after local WC (per (key, CN) group).  With
    # a static CN count in scope (the liveness plane's shape, always on the
    # runner path) each masked subset costs one scatter-max over (key, cn)
    # cells; otherwise one (key, cn, pos) sort serves every subset.
    n_cns_static = None
    for liveness in (alive, died):
        if liveness is not None:
            n_cns_static = liveness.shape[0]
            break
    if n_cns_static is not None:
        def _group_last(mask):
            return wc.local_executors_scatter(keys, cn, pos, mask,
                                              cfg.n_slots, n_cns_static, base)
    else:
        gplan = (wc.plan_groups(keys, cn, pos, valid_o) if cfg.local_wc
                 else None)

        def _group_last(mask):
            return wc.group_last(gplan, mask)
    loc_exec_opt = _group_last(opt_upd) if cfg.local_wc else opt_upd
    if cfg.mode in (SyncMode.CIDER, SyncMode.OSYNC) or not cfg.local_wc:
        loc_exec_pess = pess       # CIDER: global WC subsumes local
    else:
        loc_exec_pess = _group_last(pess)

    # ---- 5. per-mode I/O metering
    s = wc.sum_i32
    zero = torch.zeros((), dtype=_I32, device=dev)
    n_found_search = s((ks == OpKind.SEARCH) & ok_s)
    reads = s(valid_o) * cfg.index_read_iops + n_found_search
    mn_bytes = (s(valid_o) * cfg.index_read_bytes
                + n_found_search * cfg.value_bytes)
    ro_bytes = mn_bytes        # read-only bytes bill to ONE replica
    writes = cas = faa = cn_msgs = retries_total = combined_total = zero
    per_op_retries = torch.zeros((b,), dtype=_I32, device=dev)
    per_op_combined = torch.zeros((b,), dtype=torch.bool, device=dev)
    per_op_batch = torch.ones((b,), dtype=_I32, device=dev)
    per_op_rank = torch.zeros((b,), dtype=_I32, device=dev)
    per_op_rows = torch.zeros((b,), dtype=_I32, device=dev)

    # INSERTs: optimistic CAS on the empty pointer in every mode (§4.2.2)
    n_ins = s(is_insert)
    writes = writes + n_ins
    cas = cas + n_ins
    mn_bytes = mn_bytes + n_ins * (cfg.value_bytes + cfg.ptr_bytes)

    # DELETEs: pessimistic modes lock (enqueue-CAS + ptr-CAS + epoch-FAA);
    # under OSYNC they CAS-retry in the per-key optimistic queue below
    n_del = s(is_delete)
    if cfg.mode != SyncMode.OSYNC:
        cas = cas + 2 * n_del
        faa = faa + n_del
        mn_bytes = mn_bytes + n_del * (2 * cfg.ptr_bytes + 8)

    # optimistic CAS path: one joint queue per key
    opt_queue = (loc_exec_opt | is_delete if cfg.mode == SyncMode.OSYNC
                 else loc_exec_opt)
    plan_o = wc.stats_from_plan(plan_all, opt_queue)
    m_opt_writes = s(loc_exec_opt)                # DELETEs write no heap
    n_opt_q = s(opt_queue)
    writes = writes + m_opt_writes
    cas = cas + n_opt_q + plan_o.retry_sum
    retries_total = retries_total + plan_o.retry_sum
    mn_bytes = mn_bytes + (m_opt_writes * cfg.value_bytes
                           + (n_opt_q + plan_o.retry_sum) * cfg.ptr_bytes)
    combined_total = combined_total + s(opt_upd) - m_opt_writes
    per_op_retries = torch.where(opt_queue, plan_o.rank_of, per_op_retries)
    per_op_rank = torch.where(opt_queue, plan_o.rank_of, per_op_rank)
    per_op_combined = per_op_combined | (opt_upd & ~loc_exec_opt)

    # pessimistic subset
    m_pe = s(loc_exec_pess)                       # effective queued writers
    if cfg.mode == SyncMode.SPIN:
        plan_p = wc.stats_from_plan(plan_all, loc_exec_pess)
        polls = _backoff_polls(plan_p.rank_of * 3, cfg.backoff_cap)
        polls_sum = s(torch.where(loc_exec_pess, polls, 0))
        writes = writes + m_pe
        cas = cas + 3 * m_pe + polls_sum          # lock + ptr + unlock + polls
        retries_total = retries_total + polls_sum
        mn_bytes = mn_bytes + (m_pe * (cfg.value_bytes + 3 * cfg.ptr_bytes)
                               + polls_sum * cfg.ptr_bytes)
        per_op_retries = torch.where(loc_exec_pess, polls, per_op_retries)
        per_op_rank = torch.where(loc_exec_pess, plan_p.rank_of, per_op_rank)
    elif cfg.mode == SyncMode.MCS:
        writes = writes + m_pe
        cas = cas + 2 * m_pe                      # enqueue masked-CAS + ptr CAS
        faa = faa + m_pe                          # epoch release
        plan_p = wc.stats_from_plan(plan_all, loc_exec_pess)
        cn_msgs = cn_msgs + 2 * s(loc_exec_pess & (plan_p.mult_of > 1))
        mn_bytes = mn_bytes + m_pe * (cfg.value_bytes + 2 * cfg.ptr_bytes + 8)
        per_op_batch = torch.where(loc_exec_pess, 1, per_op_batch)
        per_op_rank = torch.where(loc_exec_pess, plan_p.rank_of, per_op_rank)
    elif cfg.mode == SyncMode.CIDER:
        # global WC: all queued writers on a key collapse to ONE write
        plan_p = wc.stats_from_plan(plan_all, loc_exec_pess)
        is_exec = loc_exec_pess & plan_p.is_tail  # queue tail = executor
        multi_exec = is_exec & (plan_p.mult_of > 1)
        n_q = s(is_exec)
        n_multi_q = s(multi_exec)
        cas = cas + m_pe + n_q                    # m enqueues + 1 ptr CAS/queue
        writes = writes + n_q                     # ONE combined write per queue
        faa = faa + m_pe                          # every client's release FAA
        reads = reads + n_multi_q                 # coordinator tail lookup
        cn_msgs = cn_msgs + s(torch.where(multi_exec, plan_p.mult_of + 1, 0))
        mn_bytes = mn_bytes + (m_pe * cfg.ptr_bytes
                               + n_q * (cfg.value_bytes + cfg.ptr_bytes)
                               + m_pe * 8 + n_multi_q * cfg.lock_bytes)
        ro_bytes = ro_bytes + n_multi_q * cfg.lock_bytes
        combined_total = combined_total + s(pess) - n_q
        per_op_combined = per_op_combined | (pess & ~is_exec)
        per_op_batch = torch.where(loc_exec_pess, plan_p.mult_of, per_op_batch)
        per_op_rank = torch.where(loc_exec_pess, plan_p.rank_of, per_op_rank)

    executed = writes

    # ---- 5b. lease/epoch orphaned-lock repair (crash recovery, §4.6)
    per_op_orphan = torch.zeros((b,), dtype=_I32, device=dev)
    repair_total = orphan_out = zero
    if cfg.mode == SyncMode.OSYNC:
        stranded = state.stranded          # lock-free: crashes strand nothing
    else:
        slot_u = torch.clamp(keys - base, 0, cfg.n_slots - 1).long()
        if died is None:
            add_slot = torch.zeros((cfg.n_slots,), dtype=_I32, device=dev)
        else:
            dead_w = (present & died[torch.clamp(cn, 0, died.shape[0] - 1).long()]
                      & ((kinds == OpKind.UPDATE) | (kinds == OpKind.DELETE)))
            if owned is not None:
                dead_w = dead_w & owned
            if cfg.mode == SyncMode.CIDER:
                # only writers the credit table routed pessimistically held
                # a lock; DELETEs always lock
                cslot = credit_slot(keys, table).long()
                dead_node = dead_w & ((credits.credit[cslot] > 0)
                                      | (kinds == OpKind.DELETE))
            elif cfg.local_wc:
                # only the local executor of each (key, CN) UPDATE group had
                # left the crashed CN; each dead DELETE strands its own node
                dead_node = (_group_last(dead_w & (kinds == OpKind.UPDATE))
                             | (dead_w & (kinds == OpKind.DELETE)))
            else:
                dead_node = dead_w
            cnt = torch.zeros((cfg.n_slots,), dtype=_I32, device=dev)
            cnt.index_add_(0, slot_u, dead_node.to(_I32))
            add_slot = (cnt if cfg.mode == SyncMode.MCS
                        else torch.clamp(cnt, max=1))
        tot = state.stranded + add_slot
        if cfg.mode != SyncMode.MCS:
            tot = torch.clamp(tot, max=1)    # one lock word/entry per key
        # any surviving locker on the slot repairs all its stranded nodes
        surv = loc_exec_pess | is_delete
        surv_cnt = torch.zeros((cfg.n_slots,), dtype=_I32, device=dev)
        surv_cnt.index_add_(0, slot_u, surv.to(_I32))
        repaired = (surv_cnt > 0) & (tot > 0)
        n_repair = s(torch.where(repaired, tot, 0))
        stranded = torch.where(repaired, 0, tot)
        orphan_out = s(stranded > 0)
        per_op_orphan = torch.where(surv & repaired[slot_u], tot[slot_u], 0)
        # bill: one stale-epoch READ of the lock entry + one break CAS each
        reads = reads + n_repair
        cas = cas + n_repair
        repair_total = repair_total + n_repair
        mn_bytes = mn_bytes + n_repair * (cfg.lock_bytes + 8)
        ro_bytes = ro_bytes + n_repair * cfg.lock_bytes
        if cfg.mode == SyncMode.SPIN:
            # spinners re-CAS the orphaned word until the lease expires
            pollc = _backoff_polls(
                torch.full((), cfg.lease_poll_rounds, dtype=_I32,
                           device=dev), cfg.backoff_cap)
            lease_polls = per_op_orphan * pollc
            polls_lease = s(lease_polls)
            cas = cas + polls_lease
            retries_total = retries_total + polls_lease
            repair_total = repair_total + polls_lease
            mn_bytes = mn_bytes + polls_lease * cfg.ptr_bytes
            per_op_retries = per_op_retries + lease_polls

    # ---- 5c. SCAN reader probes (range reads).  A SCAN(key, count) expands
    # into `count` reader probes over [key, key+count), each joining its
    # slot's wait queue as a reader at the scanning op's batch position; one
    # sort of writer+probe lanes feeds the fused scan_probe pass.  Probes
    # outside this shard's slots belong to another shard: each shard counts
    # the rows of its own sub-run of a cross-shard SCAN.
    if cfg.scan_max > 0:
        ns = cfg.scan_max
        is_scan = (kinds == OpKind.SCAN) & valid
        count = torch.clamp(values, 0, ns)            # count rides `values`
        jj = torch.arange(ns, dtype=_I32, device=dev)
        pk = keys[:, None] + jj[None, :]              # (B, ns) global slots
        p_loc = pk - base
        p_in = (is_scan[:, None] & (jj[None, :] < count[:, None])
                & (p_loc >= 0) & (p_loc < cfg.n_slots))
        keys_p = pk.reshape(b * ns)
        pv = p_in.reshape(b * ns)
        keys_c = torch.cat([keys, keys_p])
        pos_c = torch.cat([pos, pos.repeat_interleave(ns)])
        tvalid = torch.cat([valid_o, pv])
        plan_c = wc.plan_combine(keys_c, pos_c, tvalid,
                                 backend=cfg.kernel_backend)
        pc = plan_c.perm.long()
        bc = b * (1 + ns)
        # only this window's INSERT/DELETE lanes set the existence bit
        setcode_c = torch.cat([
            torch.where(is_insert, 1, torch.where(is_delete, 0, -1)).to(_I32),
            torch.full((b * ns,), -1, dtype=_I32, device=dev)])
        lockw = loc_exec_pess | is_delete              # exclusive lock holders
        writer_c = torch.cat([lockw, torch.zeros((b * ns,), dtype=torch.bool,
                                                 device=dev)])
        slot_c = torch.clamp(keys_c[pc] - base, 0, cfg.n_slots - 1).long()
        e_init_c = state.ptr[slot_c] != NULL_PTR
        e_bc, waits_s = _probe_sweep(plan_c.keys_sorted, setcode_c[pc],
                                     writer_c[pc], e_init_c,
                                     cfg.kernel_backend)
        e_probe = torch.zeros((bc,), dtype=torch.bool, device=dev)
        e_probe[pc] = e_bc & tvalid[pc]
        hit = e_probe[b:].reshape(b, ns) & p_in
        per_op_rows = hit.to(_I32).sum(1, dtype=_I32)
        n_probes = s(pv)
        n_rows = s(hit)
        # one leaf-entry READ per probed slot + one value READ per row found
        reads = reads + n_probes + n_rows
        probe_bytes = n_probes * cfg.ptr_bytes + n_rows * cfg.value_bytes
        mn_bytes = mn_bytes + probe_bytes
        ro_bytes = ro_bytes + probe_bytes
        if cfg.mode == SyncMode.OSYNC:
            # optimistic traversal re-reads each leaf's version
            reads = reads + n_probes
            mn_bytes = mn_bytes + n_probes * cfg.ptr_bytes
            ro_bytes = ro_bytes + n_probes * cfg.ptr_bytes
        elif cfg.mode == SyncMode.SPIN:
            # no shared mode: lock + unlock CAS per leaf
            cas = cas + 2 * n_probes
            mn_bytes = mn_bytes + 2 * n_probes * cfg.ptr_bytes
        elif cfg.mode == SyncMode.MCS:
            # lock-shared traversal: shared enqueue CAS + release FAA per leaf
            cas = cas + n_probes
            faa = faa + n_probes
            mn_bytes = mn_bytes + n_probes * (cfg.ptr_bytes + 8)
        else:
            # CIDER: cold leaves lock-free, credit-hot leaves shared-queued
            cslot_p = credit_slot(keys_p, table).long()
            n_hot = s(pv & (credits.credit[cslot_p] > 0))
            cas = cas + n_hot
            faa = faa + n_hot
            mn_bytes = mn_bytes + n_hot * (cfg.lock_bytes + 8)
        if cfg.mode != SyncMode.OSYNC:
            # wait rank of the anchor-leaf reader behind exclusive holders
            readers_s = torch.cat([torch.zeros((b,), dtype=torch.bool,
                                               device=dev), pv])[pc]
            waits = torch.zeros((bc,), dtype=_I32, device=dev)
            waits[pc] = torch.where(readers_s, waits_s, 0)
            per_op_rank = torch.where(p_in[:, 0], waits[b:].reshape(b, ns)[:, 0],
                                      per_op_rank)

    # ---- 5d. SNAPSHOT replica fan-out: write-class verbs go to all R
    # replica MNs, reads to one
    if cfg.n_replicas > 1:
        rep = cfg.n_replicas
        writes = writes * rep
        cas = cas * rep
        faa = faa * rep
        retries_total = retries_total * rep
        repair_total = repair_total * rep
        mn_bytes = ro_bytes + rep * (mn_bytes - ro_bytes)

    # ---- 6. credit feedback (§4.3, Algorithm 1 lines 13-22), on the FULL
    # window like the decision; unsharded the full masks are the owned ones
    if cfg.mode == SyncMode.CIDER:
        if owned is None:
            pess_fb, batch_fb = loc_exec_pess, per_op_batch
            opt_fb, retry_fb = loc_exec_opt | is_insert, per_op_retries
        else:
            # the full-window masks are subsets of `valid`, not `valid_o`:
            # the replicated credit plane pays one full-validity plan of
            # each kind and derives both feedback stats from it
            opt_upd_full = upd_full & ~pess_full
            if cfg.local_wc:
                loc_opt_full = wc.group_last(
                    wc.plan_groups(keys, cn, pos, valid), opt_upd_full)
            else:
                loc_opt_full = opt_upd_full
            plan_full = wc.plan_combine(keys, pos, valid,
                                        backend=cfg.kernel_backend)
            plan_p_fb = wc.stats_from_plan(plan_full, pess_full)
            plan_o_fb = wc.stats_from_plan(plan_full, loc_opt_full)
            pess_fb = pess_full
            batch_fb = torch.where(pess_full, plan_p_fb.mult_of, 1)
            opt_fb = loc_opt_full | ((kinds == OpKind.INSERT) & valid)
            retry_fb = torch.where(loc_opt_full, plan_o_fb.rank_of, 0)
        credits3 = credit_feedback(
            credits2, keys, table, pess=pess_fb, wc_batch=batch_fb,
            opt=opt_fb, n_retry=retry_fb,
            initial_credit=cfg.initial_credit,
            hotness_threshold=cfg.hotness_threshold,
            aimd_factor=cfg.aimd_factor)
    else:
        credits3 = credits2

    # ---- 7. epoch FAA bookkeeping (fault-tolerance heartbeat, §4.6)
    if cfg.mode in (SyncMode.MCS, SyncMode.CIDER):
        rel = loc_exec_pess | is_delete
        k_loc = keys - base
        in_range = rel & (k_loc >= 0) & (k_loc < cfg.n_slots)
        epoch = state.epoch.index_add(
            0, torch.clamp(k_loc, 0, cfg.n_slots - 1).long(),
            in_range.to(_I32))
    else:
        epoch = state.epoch

    new_state = StoreState(ptr=ptr, meta=pack_meta(ver, stranded),
                           epoch=epoch, heap=heap,
                           heap_top=state.heap_top + n_commits)
    # unsort results; a SCAN succeeds when it found any row
    ok = torch.zeros((b,), dtype=torch.bool, device=dev)
    ok[perm] = ok_s
    ok = ok | (per_op_rows > 0)
    value = torch.empty((b,), dtype=_I32, device=dev)
    value[perm] = val_s
    res = Results(ok=ok, value=value, pessimistic=pess,
                  combined=per_op_combined, wc_batch=per_op_batch,
                  retries=per_op_retries, rank=per_op_rank,
                  orphan_wait=per_op_orphan, rows=per_op_rows)
    io = IOMetrics(reads=reads, writes=writes, cas=cas, faa=faa,
                   cn_msgs=cn_msgs, mn_bytes=mn_bytes, retries=retries_total,
                   combined=combined_total, executed=executed,
                   repair_cas=repair_total, orphan_windows=orphan_out)
    return new_state, credits3, res, io
