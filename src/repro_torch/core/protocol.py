"""Per-client protocol state machines for the four synchronization schemes,
vectorized over client lanes (port of ``repro.core.protocol``; §2.2, §2.3,
§4.2-4.4, Figs 9-10).

Each lane executes a closed-loop YCSB client.  One ``tick`` advances every
lane by at most one protocol event; lock/queue state lives in hashed tables
(ticket-FIFO == MCS queue order; hash collisions between two concurrently
hot keys falsely serialize them, as in the reference).

Phase map:
  THINK -> IDX -> { KV                         (SEARCH)
                  | OW -> OCAS*                (optimistic write; CAS retry loop)
                  | SLOCK* -> SW -> SCAS -> SUNL        (CAS spinlock + backoff)
                  | ENQ -> [MNOTIFY -> MWAIT] -> MW -> MCAS -> MFAA   (MCS)
                  | ENQ -> ... -> CREAD -> CMSG -> MW -> MCAS -> MFAA (CIDER
                      coordinator: combined write for the whole wait queue)
                  | MWAIT -> PWAIT -> PFAA     (CIDER participant: combined) }

The tick never synchronizes with the host: ``t`` is a 0-dim int32 tensor,
every scatter is a fixed-shape tensor op, and a masked-off lane's update is
dropped by an explicit mask (a zero added, or no winner in the slot), never
by an out-of-range index.  So ``core.sim`` can capture ticks into a CUDA
graph and replay them.  A ``set`` scatter whose lanes may write different
values to one slot keeps the last lane's value, as the reference does on
the CPU (its updates apply in lane order); ``_set_at`` makes that
deterministic on the card too.
"""
from __future__ import annotations

import dataclasses
import functools
import operator

import torch

from repro_torch.core.simnet import (NetState, SimParams, issue_mn, net_init,
                                     run_rank)
from repro_torch.core.types import OpKind, SyncMode

__all__ = ["SimState", "sim_init", "tick", "PHASES"]

(THINK, IDX, KV, OW, OCAS, ORD, SLOCK, SBACK, SW, SCAS, SUNL, ENQ, MNOTIFY,
 MWAIT, MW, MCAS, MFAA, CREAD, CMSG, PWAIT, PFAA, LWAIT, DEAD) = range(23)
PHASES = dict(THINK=THINK, IDX=IDX, KV=KV, OW=OW, OCAS=OCAS, ORD=ORD,
              SLOCK=SLOCK, SBACK=SBACK, SW=SW, SCAS=SCAS, SUNL=SUNL, ENQ=ENQ,
              MNOTIFY=MNOTIFY, MWAIT=MWAIT, MW=MW, MCAS=MCAS, MFAA=MFAA,
              CREAD=CREAD, CMSG=CMSG, PWAIT=PWAIT, PFAA=PFAA, LWAIT=LWAIT,
              DEAD=DEAD)

V_READ, V_WRITE, V_CAS, V_FAA, V_CN = range(5)
_BIG = 2**30
_I32 = torch.int32


def _fail_lanes(p: SimParams) -> tuple[int, ...]:
    """All lanes scheduled to die at ``fail_tick``: the single ``fail_lane``
    plus the ``fail_lanes`` set."""
    lanes = tuple(int(x) for x in p.fail_lanes)
    if p.fail_lane >= 0:
        lanes += (p.fail_lane,)
    return tuple(sorted(set(lanes)))


@dataclasses.dataclass
class SimState:
    # ---- per-lane ----
    phase: torch.Tensor       # (N,)
    ready: torch.Tensor       # (N,) next event tick
    kind: torch.Tensor        # (N,) current OpKind
    hkey: torch.Tensor        # (N,) hashed key -> lock/ticket tables
    hc: torch.Tensor          # (N,) credit-table slot
    hl: torch.Tensor          # (N,) local-WC slot
    ticket: torch.Tensor      # (N,) MCS ticket
    att: torch.Tensor         # (N,) CAS/lock attempt count for current op
    kver_seen: torch.Tensor   # (N,) pointer version read before CAS
    comb_tail: torch.Tensor   # (N,) coordinator: executor's ticket
    comb_pend: torch.Tensor   # (N,) coordinator: combined write in flight
    own_local: torch.Tensor   # (N,) I hold the local-WC flag
    idx_left: torch.Tensor    # (N,) remaining index reads for current op
    op_start: torch.Tensor    # (N,) issue tick of current op
    op_idx: torch.Tensor      # (N,) position in my op stream
    is_pess: torch.Tensor     # (N,) current write takes the pessimistic path
    wait_start: torch.Tensor  # (N,) MWAIT entry tick (deadlock detection §4.6)
    # ---- hashed key tables ----
    next_ticket: torch.Tensor  # (H,)
    now_serving: torch.Tensor  # (H,)
    kver: torch.Tensor         # (H,) pointer version (optimistic CAS conflicts)
    lockw: torch.Tensor        # (H,) spinlock word
    comb_time: torch.Tensor    # (H,) last combined batch: release tick
    comb_base: torch.Tensor    # (H,)   "  : coordinator ticket
    comb_upto: torch.Tensor    # (H,)   "  : executor ticket
    epoch: torch.Tensor        # (H,) lock epoch (FAA'd on release, §4.6)
    del_q: torch.Tensor        # (H,) ticket-assigned, unreleased DELETEs
                               # queued on the key: gates write combining
    # ---- per-CN tables (flattened G x 2^bits) ----
    lflag: torch.Tensor        # local WC busy flags
    credit: torch.Tensor       # contention credits (§4.3)
    rrec: torch.Tensor         # retryRecord (§4.3)
    # ---- network + counters ----
    net: NetState
    verbs: torch.Tensor        # (5,) per-class verb counts
    done: torch.Tensor         # () completed ops
    done_w: torch.Tensor       # () completed writes
    retries: torch.Tensor      # () redundant CAS/poll attempts
    comb_g: torch.Tensor       # () globally combined writes
    comb_l: torch.Tensor       # () locally combined writes
    pess_w: torch.Tensor       # () writes that took the pessimistic path
    exec_w: torch.Tensor       # () executed (non-combined) writes
    batch_sum: torch.Tensor    # () sum of WC batch sizes
    batch_cnt: torch.Tensor    # () number of combined batches
    hot_ideal: torch.Tensor    # () ops finishing with att >= HOTNESS_THRESHOLD
    deadlocks: torch.Tensor    # () deadlock repairs performed
    hist: torch.Tensor         # (HB,) latency histogram (1-tick buckets)


# the scalar counters, in the order ``tick`` sums them in one reduction
COUNTERS = ("done", "done_w", "retries", "comb_g", "comb_l", "pess_w",
            "exec_w", "batch_sum", "batch_cnt", "hot_ideal", "deadlocks")


def sim_init(p: SimParams, streams: dict) -> SimState:
    """The state before tick 0, on the device of ``streams``."""
    n = p.n_lanes
    h = 1 << p.h_bits
    g = (n + p.lanes_per_cn - 1) // p.lanes_per_cn
    dev = streams["kinds"].device

    def z(size):
        return torch.zeros(size, dtype=_I32, device=dev)

    def col0(name):
        return streams[name][:, 0].to(_I32).contiguous()

    return SimState(
        phase=torch.full((n,), THINK, dtype=_I32, device=dev),
        ready=torch.arange(n, dtype=_I32, device=dev) % 7,  # staggered start
        kind=col0("kinds"), hkey=col0("hkey"), hc=col0("hc"), hl=col0("hl"),
        ticket=z(n), att=z(n), kver_seen=z(n), comb_tail=z(n),
        comb_pend=z(n), own_local=z(n), idx_left=z(n), op_start=z(n),
        op_idx=z(n), is_pess=z(n), wait_start=z(n),
        next_ticket=z(h), now_serving=z(h), kver=z(h), lockw=z(h),
        comb_time=z(h), comb_base=torch.full((h,), -1, dtype=_I32, device=dev),
        comb_upto=torch.full((h,), -1, dtype=_I32, device=dev), epoch=z(h),
        del_q=z(h),
        lflag=z(g << p.hl_bits), credit=z(g << p.hc_bits),
        rrec=z(g << p.hc_bits),
        net=net_init(2 * h, dev), verbs=z(5),
        **{name: z(()) for name in COUNTERS},
        hist=z(p.hist_buckets))


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx)


def _add_at(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
            val) -> torch.Tensor:
    """``table.at[where(mask, idx, size)].add(val, mode="drop")``: a masked
    lane adds 0 at slot 0 instead of being dropped."""
    if isinstance(val, int):
        src = mask.to(_I32) * val
    else:
        src = val * mask
    return torch.index_add(table, 0, idx * mask, src)


def _set_at(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
            val, ids: torch.Tensor) -> torch.Tensor:
    """``table.at[where(mask, idx, size)].set(val, mode="drop")`` with the
    last lane winning a slot that several lanes set: the highest masked
    lane id of each slot is found by a ``scatter_reduce`` into a spare slot
    past the end (where masked-off lanes go), then each slot with a winner
    takes the winner's value."""
    size = table.shape[0]
    win = torch.full((size + 1,), -1, dtype=_I32, device=table.device)
    win.scatter_reduce_(0, torch.where(mask, idx, size).long(), ids, "amax")
    win = win[:size]
    if isinstance(val, int):
        return table.masked_fill(win >= 0, val)
    if val.dim() == 0:       # a device scalar: masked_fill would read it
        return torch.where(win >= 0, val, table)
    return torch.where(win >= 0, _gather(val, win.clamp_min(0)), table)


def _put(x: torch.Tensor, mask: torch.Tensor, val: torch.Tensor) -> None:
    """``x[mask] = val`` in place, one kernel, no boolean indexing."""
    torch.where(mask, val, x, out=x)


def _scatter_min_id(h_idx, mask, h_size, ids, prio=None):
    """One winner per hashed key among masked lanes.  ``prio`` (a permutation
    of lane ids) models RNIC timing jitter: without it, fixed min-id
    arbitration starves high-id lanes completely (§4.6 Fairness)."""
    if prio is None:
        prio = ids
    tmp = torch.full((h_size + 1,), _BIG, dtype=_I32, device=ids.device)
    tmp.scatter_reduce_(0, torch.where(mask, h_idx, h_size).long(), prio,
                        "amin")
    return mask & (_gather(tmp, h_idx) == prio)


def _group_rank(h_idx, mask, h_size, ids):
    """0-based rank by lane id within each hashed-key group of masked lanes
    (the ``wc_combine`` run rank of a stable sort on the masked key)."""
    return run_rank(torch.where(mask, h_idx, h_size), ids)


def tick(p: SimParams, mode: SyncMode, streams: dict, state: SimState,
         t: torch.Tensor) -> SimState:
    """Advance every lane by one event.  ``t``: the current tick, a 0-dim
    int32 tensor on the state's device."""
    n, H = p.n_lanes, 1 << p.h_bits
    s = state
    dev = s.phase.device
    active = s.phase != DEAD
    ev = (s.ready == t) & active
    ids = torch.arange(n, dtype=_I32, device=dev)
    cn = ids // p.lanes_per_cn
    li = cn * (1 << p.hl_bits) + s.hl     # local-WC slot
    ci = cn * (1 << p.hc_bits) + s.hc     # credit slot

    is_search = s.kind == OpKind.SEARCH
    is_insert = s.kind == OpKind.INSERT
    is_delete = s.kind == OpKind.DELETE

    ev_phase = torch.where(ev, s.phase, -1)   # -1: no event this tick
    t1, t_cn = t + 1, t + p.cn_rtt

    def at(phase_id):
        return ev_phase == phase_id

    def hk(table):
        return _gather(table, s.hkey)

    # accumulators for this tick
    issue_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    issue_bytes = torch.zeros((n,), dtype=_I32, device=dev)
    issue_cost = torch.zeros((n,), dtype=_I32, device=dev)
    issue_atomic = torch.zeros((n,), dtype=torch.bool, device=dev)
    issue_repl = torch.zeros((n,), dtype=torch.bool, device=dev)
    # the tick's own buffers, updated in place (one kernel an update)
    new_phase = s.phase.clone()
    new_ready = s.ready.clone()
    lane_verbs = [[] for _ in range(5)]   # per verb class: per-lane counts
    complete = torch.zeros((n,), dtype=torch.bool, device=dev)
    issue_addr = s.hkey.clone()
    lock_entry = s.hkey + H

    def issue(m, phase_id, verb, nbytes, lock_addr=False):
        """``lock_addr``: the verb targets the key's LOCK ENTRY, a different
        memory word than the data pointer: atomics on the two serialize
        independently at the RNIC.

        SNAPSHOT replication: write-class verbs fan out to all
        ``p.n_replicas`` replica MNs (xR tokens, bytes and verbs on the
        shared MN fleet) and the lane waits ``p.replica_rtt`` extra ticks
        for the slowest replica's ack (applied after ``issue_mn``).  Reads
        go to one replica.  R = 1 builds the unreplicated program."""
        atomic = verb in (V_CAS, V_FAA)
        rep = p.n_replicas if (p.n_replicas > 1
                               and verb in (V_WRITE, V_CAS, V_FAA)) else 1
        issue_mask.bitwise_or_(m)
        issue_bytes.masked_fill_(m, nbytes * rep)
        issue_cost.masked_fill_(m, (p.atomic_cost if atomic else 1) * rep)
        if atomic:
            issue_atomic.bitwise_or_(m)
        if rep > 1:
            issue_repl.bitwise_or_(m)
        if lock_addr:
            _put(issue_addr, m, lock_entry)
        new_phase.masked_fill_(m, phase_id)
        lane_verbs[verb].append(m.to(_I32) * rep if rep > 1 else m)

    def cn_hop(m, phase_id):
        new_phase.masked_fill_(m, phase_id)
        _put(new_ready, m, t_cn)
        lane_verbs[V_CN].append(m)

    # ============ THINK -> first index read =================================
    m = at(THINK)
    idx_left = s.idx_left.masked_fill(m, p.index_reads - 1)
    issue(m, IDX, V_READ, p.index_bytes)

    # ============ IDX completion =============================================
    m = at(IDX)
    more = m & (idx_left > 0)
    idx_left = torch.where(more, idx_left - 1, idx_left)
    issue(more, IDX, V_READ, p.index_bytes)
    disp = m & ~more
    # SEARCH -> KV read
    issue(disp & is_search, KV, V_READ, p.value_bytes)
    w_disp = disp & ~is_search
    # ---- synchronization-mode decision (§4.3) ----
    if mode == SyncMode.CIDER:
        have_credit = (_gather(s.credit, ci) > 0) | p.cas_off
        pess = w_disp & ((~is_insert & have_credit) | is_delete)
        credit = _add_at(s.credit, ci, pess & ~is_delete, -1).clamp_min(0)
    elif mode in (SyncMode.SPIN, SyncMode.MCS):
        pess = w_disp & ~is_insert      # INSERTs bypass locks in ALL schemes
        credit = s.credit
    else:
        pess = torch.zeros((n,), dtype=torch.bool, device=dev)
        credit = s.credit
    opt = w_disp & ~pess
    is_pess = torch.where(w_disp, pess, s.is_pess.to(torch.bool))
    # ---- local write combining (baselines only; global WC subsumes it) ----
    lflag = s.lflag
    own_local = s.own_local
    if p.local_wc and mode != SyncMode.CIDER:
        wc_cand = w_disp & ~is_insert & ~is_delete
        busy = _gather(lflag, li) > 0
        join = wc_cand & busy
        claim_c = wc_cand & ~busy
        claim_w = _scatter_min_id(li, claim_c, lflag.shape[0], ids)
        join = join | (claim_c & ~claim_w)
        lflag = _set_at(lflag, li, claim_w, 1, ids)
        own_local = own_local.masked_fill(claim_w, 1)
        new_phase.masked_fill_(join, LWAIT)
        _put(new_ready, join, t1)
        go = ~join
        o = opt & go
        pess_go = pess & go
    else:
        o = opt
        pess_go = pess
    # ---- dispatch the write ----
    kver_hk = hk(s.kver)
    kver_seen = torch.where(o & is_delete, kver_hk, s.kver_seen)
    issue(o & is_delete, OCAS, V_CAS, 8)          # DELETE: no heap write
    issue(o & ~is_delete, OW, V_WRITE, p.value_bytes)
    if mode == SyncMode.SPIN:
        issue(pess_go, SLOCK, V_CAS, 8, lock_addr=True)
    elif mode in (SyncMode.MCS, SyncMode.CIDER):
        issue(pess_go, ENQ, V_CAS, 16, lock_addr=True)  # masked-CAS on lock entry

    # ============ KV read completion -> op done ==============================
    complete = complete | at(KV)

    # ============ optimistic path ============================================
    m = at(OW)
    kver_seen = torch.where(m, kver_hk, kver_seen)
    issue(m, OCAS, V_CAS, 8)

    m = at(OCAS)
    elig = m & (kver_seen == kver_hk)
    prio = (ids + t * 40503) % n          # rotating arbitration (NIC jitter)
    win = _scatter_min_id(s.hkey, elig, H, ids, prio)
    kver = _add_at(s.kver, s.hkey, win, 1)
    lose = m & ~win
    att = torch.where(lose, s.att + 1, s.att)
    # a failed CAS returns the current value, so the client re-CASes
    # immediately with the returned (version, pointer): the staleness
    # window of each retry is exactly one CAS RTT (§2.2)
    kver_seen = torch.where(lose, hk(kver), kver_seen)
    lane_retries = [lose]
    complete = complete | win
    if mode == SyncMode.CIDER:
        # retry-budget escape: an optimistic UPDATE that keeps losing re-runs
        # Algorithm 1's decision mid-op and self-promotes the key
        escape = lose & (att >= p.escape_retries) & ~is_insert
        credit = _add_at(credit, ci, escape, p.initial_credit)
        is_pess = is_pess | escape
        issue(escape, ENQ, V_CAS, 16, lock_addr=True)
        lose = lose & ~escape
    issue(lose, OCAS, V_CAS, 8)

    # ============ spinlock path ==============================================
    m = at(SLOCK)
    free = m & (hk(s.lockw) == 0)
    swin = _scatter_min_id(s.hkey, free, H, ids)
    lockw = _set_at(s.lockw, s.hkey, swin, 1, ids)
    slose = m & ~swin
    att = torch.where(slose, att + 1, att)
    lane_retries.append(slose)
    boff = att.clamp_max(p.backoff_cap)
    new_phase.masked_fill_(slose, SBACK)
    _put(new_ready, slose, t + (1 << boff))
    issue(swin & is_delete, SCAS, V_CAS, 8)
    issue(swin & ~is_delete, SW, V_WRITE, p.value_bytes)

    issue(at(SBACK), SLOCK, V_CAS, 8, lock_addr=True)
    issue(at(SW), SCAS, V_CAS, 8)

    m = at(SCAS)
    kver = _add_at(kver, s.hkey, m, 1)
    issue(m, SUNL, V_CAS, 8, lock_addr=True)

    m = at(SUNL)
    lockw = _set_at(lockw, s.hkey, m, 0, ids)
    complete = complete | m

    # ============ MCS / CIDER pessimistic path ===============================
    # ENQ completion: assign FIFO tickets (get-and-set on the lock entry tail)
    m = at(ENQ)
    rank = _group_rank(s.hkey, m, H, ids)
    ticket = torch.where(m, hk(s.next_ticket) + rank, s.ticket)
    next_ticket = _add_at(s.next_ticket, s.hkey, m, 1)
    del_q = _add_at(s.del_q, s.hkey, m & is_delete, 1)
    next_hk = hk(next_ticket)
    tail = next_hk - 1
    now_serving_hk = hk(s.now_serving)
    if mode == SyncMode.CIDER and not p.wc_off:
        # never combine while a DELETE holds an unreleased ticket on the
        # key: a combined release completes every covered ticket without
        # its own pointer MCAS, so a covered DELETE would be lost
        may_coord = (tail > ticket) & ~is_delete & (hk(del_q) == 0)
    else:
        may_coord = None

    def acquire(acq, comb_tail_in):
        """Dispatch lanes that just acquired the lock (head of queue)."""
        if may_coord is None:
            coord = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            coord = acq & may_coord
        plain = acq & ~coord
        return coord, plain, torch.where(coord, tail, comb_tail_in)

    acq = m & (ticket == now_serving_hk)
    coord, plain, comb_tail = acquire(acq, s.comb_tail)
    issue(coord, CREAD, V_READ, 16)               # read lock entry -> find tail
    issue(plain & is_delete, MCAS, V_CAS, 8)
    issue(plain & ~is_delete, MW, V_WRITE, p.value_bytes)
    waitq = m & ~acq
    cn_hop(waitq, MNOTIFY)                        # notify predecessor
    wait_start = torch.where(waitq, t, s.wait_start)

    m = at(MNOTIFY)
    new_phase.masked_fill_(m, MWAIT)
    _put(new_ready, m, t1)

    # MWAIT polling (local; no MN traffic: ShiftLock's design point)
    m = at(MWAIT)
    if mode == SyncMode.CIDER:
        # stale-batch safety: tickets are monotone, so an old comb_upto can
        # never cover a ticket issued after that batch was released
        comb_base_hk = hk(s.comb_base)
        combed = m & (hk(s.comb_upto) >= ticket) & (comb_base_hk < ticket)
        relay = hk(s.comb_time) + (ticket - comb_base_hk) * p.cn_rtt
        new_phase.masked_fill_(combed, PWAIT)
        _put(new_ready, combed, torch.maximum(relay, t1))
        m_open = m & ~combed
    else:
        m_open = m
    acq2 = m_open & (now_serving_hk == ticket)
    coord2, plain2, comb_tail = acquire(acq2, comb_tail)
    issue(coord2, CREAD, V_READ, 16)
    issue(plain2 & is_delete, MCAS, V_CAS, 8)
    issue(plain2 & ~is_delete, MW, V_WRITE, p.value_bytes)
    # deadlock detection & repair (§4.6): epoch stagnant for max_wait
    still = m_open & ~acq2
    if _fail_lanes(p):
        stuck = still & (t - s.wait_start > p.max_wait)
        repair = _scatter_min_id(s.hkey, stuck, H, ids)
        now_serving = _add_at(s.now_serving, s.hkey, repair, 1)
        lane_repairs = repair
        wait_start = torch.where(stuck, t, wait_start)
    else:
        now_serving = s.now_serving
        lane_repairs = None
    _put(new_ready, still, t1)

    # coordinator: READ done -> CN msg to executor -> combined write
    cn_hop(at(CREAD), CMSG)
    m = at(CMSG)
    comb_pend = s.comb_pend.masked_fill(m, 1)
    issue(m, MW, V_WRITE, p.value_bytes)

    issue(at(MW), MCAS, V_CAS, 8)

    m = at(MCAS)
    kver = _add_at(kver, s.hkey, m, 1)
    issue(m, MFAA, V_FAA, 8, lock_addr=True)

    # release (epoch FAA done)
    m = at(MFAA)
    epoch = _add_at(s.epoch, s.hkey, m, 1)
    del_q = _add_at(del_q, s.hkey, m & is_delete, -1)
    comb_rel = m & (comb_pend > 0)
    batch = (comb_tail - ticket) * comb_rel + 1   # 1 off a combined release
    now_serving = _set_at(now_serving, s.hkey, comb_rel, comb_tail + 1, ids)
    plain_rel = m & ~comb_rel
    now_serving = _set_at(now_serving, s.hkey, plain_rel, ticket + 1, ids)
    comb_time = _set_at(s.comb_time, s.hkey, comb_rel, t, ids)
    comb_base = _set_at(s.comb_base, s.hkey, comb_rel, ticket, ids)
    comb_upto = _set_at(s.comb_upto, s.hkey, comb_rel, comb_tail, ids)
    # handoff message if someone is queued behind (counted, client-side)
    lane_verbs[V_CN].append(plain_rel & (next_hk > ticket + 1))
    comb_pend = comb_pend.masked_fill(m, 0)
    complete = complete | m

    # participants: relay arrives -> FAA -> done
    issue(at(PWAIT), PFAA, V_FAA, 8, lock_addr=True)
    combined_g_fin = at(PFAA)
    complete = complete | combined_g_fin
    epoch = _add_at(epoch, s.hkey, combined_g_fin, 1)

    # local-WC joiners: owner cleared the flag -> done (result = combiner's)
    m = at(LWAIT)
    combined_l_fin = m & (_gather(lflag, li) == 0)
    complete = complete | combined_l_fin
    _put(new_ready, m & ~combined_l_fin, t1)

    # ============ op completion ==============================================
    fin = complete
    # release local-WC ownership
    lflag = _set_at(lflag, li, fin & (own_local > 0), 0, ids)
    own_local = own_local.masked_fill(fin, 0)
    # latency histogram
    lat = (t - s.op_start).clamp(0, p.hist_buckets - 1)
    hist = _add_at(s.hist, lat, fin, 1)
    # contention-aware feedback (§4.3, Algorithm 1)
    fin_w = fin & ~is_search
    if mode == SyncMode.CIDER:
        fin_opt = fin_w & ~is_pess
        promote = fin_opt & (att >= p.hotness_threshold) \
            & (_gather(s.rrec, ci) >= p.hotness_threshold)
        credit = _add_at(credit, ci, promote, p.initial_credit)
        rrec = _set_at(s.rrec, ci, fin_opt, att, ids)
        # Algorithm 1 lines 13-16 run on EVERY pessimisticUpdate call:
        # coordinators AND participants of a multi-element batch see
        # WCBatchSize > 1 and add +2 on their own CN's credit table
        grow = (fin & comb_rel & (batch > 1)) | (fin & combined_g_fin)
        # executor found no peers to combine -> multiplicative decrease
        shrink = fin & plain_rel & is_pess & ~is_delete
        credit = _add_at(credit, ci, grow, 2)
        newc = _gather(credit, ci) // p.aimd_factor
        credit = _set_at(credit, ci, shrink, newc, ids)
    else:
        rrec = s.rrec

    # counters: every per-lane contribution of this tick (bool or int32
    # rows), summed in one reduction; a group of rows sums its slice
    fin_comb = fin & comb_rel
    groups = [(f"verb{v}", rs) for v, rs in enumerate(lane_verbs)] + [
        ("done", [fin]), ("done_w", [fin_w]), ("retries", lane_retries),
        ("comb_g", [combined_g_fin & fin]), ("comb_l", [combined_l_fin & fin]),
        ("pess_w", [fin_w & is_pess]),
        ("exec_w", [fin_w & ~combined_g_fin & ~combined_l_fin]),
        ("batch_sum", [batch * fin_comb]),
        ("batch_cnt", [fin_comb]),
        ("hot_ideal", [fin_w & (att >= p.hotness_threshold)])]
    if lane_repairs is not None:
        groups.append(("deadlocks", [lane_repairs]))
    sums = torch.stack([r for _, rs in groups for r in rs]).sum(
        1, dtype=_I32)
    total, k = {}, 0
    for name, rs in groups:
        total[name] = sums[k] if len(rs) == 1 else sums[k:k + len(rs)].sum(
            dtype=_I32)
        k += len(rs)
    # (every verb class is issued by some branch of every program)
    verbs = s.verbs + torch.stack([total[f"verb{v}"] for v in range(5)])
    counters = {name: getattr(s, name) + total[name] if name in total
                else getattr(s, name) for name in COUNTERS}

    # load next op
    op_idx = torch.where(fin, s.op_idx + 1, s.op_idx)
    flat = ids * p.max_ops + op_idx % p.max_ops

    def nxt(name, cur):
        return torch.where(
            fin, _gather(streams[name].reshape(-1), flat).to(_I32), cur)

    kind = nxt("kinds", s.kind)
    hkey = nxt("hkey", s.hkey)
    hc = nxt("hc", s.hc)
    hl = nxt("hl", s.hl)
    att = att.masked_fill(fin, 0)
    is_pess_i = is_pess.to(_I32).masked_fill(fin, 0)
    new_phase.masked_fill_(fin, THINK)
    t_think = t + p.think
    _put(new_ready, fin, t_think)
    op_start = torch.where(fin, t_think, s.op_start)

    # ============ inject failure (§4.6) ======================================
    # (the lanes are compared one by one: no host list reaches the device)
    fl = _fail_lanes(p)
    if fl:
        dying = functools.reduce(operator.or_, [ids == lane for lane in fl])
        new_phase.masked_fill_(dying & (t >= p.fail_tick), DEAD)

    # ============ network: issue all MN verbs of this tick ===================
    net2, done_at = issue_mn(s.net, t, issue_mask, issue_bytes, issue_cost,
                             issue_atomic, issue_addr, p)
    if p.n_replicas > 1:
        # replicated write-class verbs complete at the SLOWEST replica: one
        # extra replica_rtt on top of the primary's completion tick
        done_at = done_at + issue_repl.to(_I32) * p.replica_rtt
    _put(new_ready, issue_mask, done_at)

    return SimState(
        phase=new_phase, ready=new_ready, kind=kind, hkey=hkey, hc=hc, hl=hl,
        ticket=ticket, att=att, kver_seen=kver_seen, comb_tail=comb_tail,
        comb_pend=comb_pend, own_local=own_local, idx_left=idx_left,
        op_start=op_start, op_idx=op_idx, is_pess=is_pess_i,
        wait_start=wait_start,
        next_ticket=next_ticket, now_serving=now_serving, kver=kver,
        lockw=lockw, comb_time=comb_time, comb_base=comb_base,
        comb_upto=comb_upto, epoch=epoch, del_q=del_q,
        lflag=lflag, credit=credit, rrec=rrec,
        net=net2, verbs=verbs, **counters, hist=hist)
