"""Exhaustive protocol race-checker (port of ``repro.analysis.race_check``;
analysis pass 3, DESIGN.md §11).

An explicit-state model checker for the per-mode synchronization machines
of ``core/protocol.py`` / ``core/sim.py``: a small, faithful model (2 keys,
2-3 clients, one op each, at most one crash injected at *any* step) is
explored over **every** interleaving, and every reachable state is checked
against the invariants the paper's argument rests on:

* **mutual exclusion** — at most one live client inside a key's critical
  section (SPIN lock word, MCS/CIDER ticket) at any reachable state;
* **no lost updates / lost deletes** — every completed live client has
  committed exactly one event, and replaying the committed events in commit
  order through ``core/oracle.OracleStore`` reproduces every per-op
  ``ok``/value/row-count *and* the final store;
* **wait-queue rank order** — per key, ticketed (pessimistic) ops commit in
  strictly increasing ticket order, i.e. queue order is serialization
  order (the serialization contract of DESIGN.md §2.2);
* **liveness** — no live client is stuck once no real step remains;
* **§4.6 orphan repair never breaks a live lock** — every recorded repair
  names a crashed owner.

The model abstracts time (no backoff/lease counters — any enabled step may
fire next, which only *adds* interleavings), folds CIDER's combined write
into one atomic action (faithful: the combined result is installed by a
single pointer CAS) and replaces Algorithm 1's credit dynamics with a
per-key ``hot`` flag choosing the optimistic vs pessimistic UPDATE path
(both settings are explored).  INSERT is always the optimistic slot-claim
CAS (§4.2.2); SEARCH/SCAN are lock-free atomic reads.

``ModelFlags`` re-introduces three seeded bugs so ``tests/test_analysis.py``
can prove the checker *detects* what it claims to:

* ``combine_covers_deletes=True`` — the lost-delete race this checker
  originally surfaced in ``protocol.py`` (a queued DELETE covered by a
  coordinator's combined batch completes without its own MCAS; fixed by
  the ``del_q`` coordinator gate);
* ``repair_requires_dead_holder=False`` — §4.6 repair that may break a
  live lock (mutual-exclusion and skipped-waiter violations follow);
* ``stale_replica_read=True`` — a replicated read served from one
  arbitrary replica instead of the max-version resolution the
  client-centric replication contract requires (DESIGN.md §13).

A second, replicated machine (``ReplScenario`` / ``explore_replicated``)
models the DESIGN.md §13 client-centric replication plane over
``N_REPLICAS = 2`` memory nodes: a write commits at the primary CAS,
then fans out to the secondary as a separate step guarded by a
last-writer-wins version CAS, and the injected crash may land *between*
the two — leaving the replicas divergent.  Real reads resolve the
max-version cell across all replicas and repair laggards (roll-forward);
the seeded ``stale_replica_read`` bug serves whichever single replica
the scheduler picks, and the checker catches the divergence twice over
(the oracle replay and an explicit stale-read record naming the
divergent replicas).

``run()`` additionally executes a tick-level conformance scenario on the
port's *real* ``protocol.tick`` machine (``core.sim._run``: CUDA graphs on
a card), proving the model's delete gate and the shipped ``del_q`` gate
agree.  The model checker itself is pure Python over ``core/oracle``.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import Counter
from typing import NamedTuple

from repro_torch.analysis import Violation
from repro_torch.core.oracle import OracleStore
from repro_torch.core.types import OpKind, SyncMode

__all__ = ["ModelFlags", "Scenario", "explore", "scenarios", "run",
           "ReplScenario", "explore_replicated", "repl_scenarios",
           "N_KEYS", "SCAN_COUNT", "N_REPLICAS"]

N_KEYS = 2           # model key space {0, 1}
SCAN_COUNT = 2       # SCAN covers [0, 2) — both keys
N_REPLICAS = 2       # replicated-write model: primary + one secondary

# client program counters
START, OCAS, WAIT, CS, REL, DONE = range(6)
_PC_NAME = ("START", "OCAS", "WAIT", "CS", "REL", "DONE")


@dataclasses.dataclass(frozen=True)
class ModelFlags:
    """Protocol variants: the real machine, plus seeded-bug re-injections."""
    combine_covers_deletes: bool = False      # True = pre-fix lost-delete bug
    repair_requires_dead_holder: bool = True  # False = repair may break live locks
    stale_replica_read: bool = False          # True = read one arbitrary replica


REAL = ModelFlags()


class Cl(NamedTuple):
    pc: int
    ticket: int            # -1 = no ticket assigned
    aux: tuple | None      # ("snap", val, ver) optimistic | ("tail", t) coordinator
    ok: bool
    out: int


class Ev(NamedTuple):
    cid: int
    ticket: int            # -1 for lock-free / optimistic commits
    kind: int
    key: int
    value: int
    ok: bool
    out: int               # SEARCH: value read; SCAN: rows; else -1


class St(NamedTuple):
    store: tuple           # per key: (val | None, ver)
    locks: tuple           # per key: holder id (SPIN) | (next_ticket, now_serving)
    clients: tuple         # Cl per client
    crashed: tuple
    events: tuple          # Ev, commit order
    repairs: tuple         # (key, owner_cid, owner_was_crashed)


@dataclasses.dataclass(frozen=True)
class Scenario:
    mode: SyncMode
    ops: tuple                       # per client: (kind, key)
    init_keys: tuple                 # keys present at start (value 0)
    hot: tuple = (False,) * N_KEYS   # CIDER: per-key Algorithm-1 verdict
    flags: ModelFlags = REAL

    def value(self, cid: int) -> int:
        # SCAN carries its range count in the value lane (oracle contract)
        return SCAN_COUNT if self.ops[cid][0] == OpKind.SCAN else 100 + cid

    def describe(self) -> str:
        ops = ",".join(f"{OpKind(k).name}{key}" for k, key in self.ops)
        hot = f" hot={''.join('01'[h] for h in self.hot)}" \
            if self.mode == SyncMode.CIDER else ""
        return f"{self.mode.name}[{ops}] init={list(self.init_keys)}{hot}"


# ---------------------------------------------------------------- helpers
def _set(tup: tuple, i: int, v) -> tuple:
    return tup[:i] + (v,) + tup[i + 1:]


def _pess(sc: Scenario, cid: int) -> bool:
    kind, key = sc.ops[cid]
    if kind == OpKind.UPDATE:
        if sc.mode == SyncMode.OSYNC:
            return False
        if sc.mode == SyncMode.CIDER:
            return bool(sc.hot[key])
        return True
    if kind == OpKind.DELETE:
        return sc.mode != SyncMode.OSYNC
    return False   # SEARCH/SCAN lock-free; INSERT optimistic slot claim


def _apply(store: tuple, kind: int, key: int, value: int):
    """Sequential point/scan semantics (mirrors OracleStore.apply)."""
    val, ver = store[key]
    if kind == OpKind.SEARCH:
        return store, val is not None, (val if val is not None else -1)
    if kind == OpKind.SCAN:
        rows = sum(1 for k in range(key, min(key + SCAN_COUNT, N_KEYS))
                   if store[k][0] is not None)
        return store, rows > 0, rows
    if kind == OpKind.INSERT:
        if val is None:
            return _set(store, key, (value, ver + 1)), True, -1
        return store, False, -1
    if kind == OpKind.UPDATE:
        if val is not None:
            return _set(store, key, (value, ver + 1)), True, -1
        return store, False, -1
    if kind == OpKind.DELETE:
        if val is not None:
            return _set(store, key, (None, ver + 1)), True, -1
        return store, False, -1
    raise AssertionError(kind)


def _commit(st: St, cid: int, kind: int, key: int, value: int,
            ok: bool, out: int, store2: tuple) -> St:
    cl = st.clients[cid]
    ev = Ev(cid, cl.ticket, kind, key, value, ok, out)
    return st._replace(
        store=store2, events=st.events + (ev,),
        clients=_set(st.clients, cid,
                     cl._replace(pc=DONE, aux=None, ok=ok, out=out)))


def _ticket_owner(sc: Scenario, st: St, key: int, t: int) -> int | None:
    for i, c in enumerate(st.clients):
        if sc.ops[i][1] == key and c.ticket == t and c.pc != DONE:
            return i
    return None


def _queued_delete(sc: Scenario, st: St, key: int) -> bool:
    """Model of the ``del_q`` gate: a DELETE with an assigned, unreleased
    ticket on the key (crashed ones included — they never release)."""
    return any(sc.ops[i] == (OpKind.DELETE, key)
               and c.ticket >= 0 and c.pc != DONE
               for i, c in enumerate(st.clients))


def _combine(sc: Scenario, st: St, cid: int) -> St:
    """Coordinator commit + release: the combined result is installed by a
    SINGLE pointer CAS (§4.2.1), so own + covered writes apply atomically;
    events stay per-member in ticket order for the oracle replay."""
    kind, key = sc.ops[cid]
    cl = st.clients[cid]
    tail = cl.aux[1]
    store, events, clients = st.store, st.events, st.clients
    store, ok, out = _apply(store, kind, key, sc.value(cid))
    events = events + (Ev(cid, cl.ticket, kind, key, sc.value(cid), ok, out),)
    clients = _set(clients, cid, cl._replace(pc=DONE, aux=None, ok=ok, out=out))
    for t in range(cl.ticket + 1, tail + 1):
        m = _ticket_owner(sc, st, key, t)
        if m is None or st.crashed[m]:
            continue   # crashed member: ticket passed over, op never completes
        mkind = sc.ops[m][0]
        mcl = clients[m]
        if mkind == OpKind.DELETE:
            # only reachable with flags.combine_covers_deletes: the covered
            # DELETE "completes" without its own MCAS — the lost delete
            clients = _set(clients, m, mcl._replace(pc=DONE, ok=True, out=-1))
            continue
        store, mok, mout = _apply(store, mkind, key, sc.value(m))
        events = events + (Ev(m, mcl.ticket, mkind, key, sc.value(m), mok, mout),)
        clients = _set(clients, m, mcl._replace(pc=DONE, ok=mok, out=mout))
    nt, _ = st.locks[key]
    return st._replace(store=store, events=events, clients=clients,
                       locks=_set(st.locks, key, (nt, tail + 1)))


# ---------------------------------------------------------------- stepper
def _steps(sc: Scenario, st: St, cid: int) -> list[St]:
    """All real (non-crash) successor states from client ``cid``."""
    kind, key = sc.ops[cid]
    cl = st.clients[cid]
    value = sc.value(cid)
    out: list[St] = []

    if kind in (OpKind.SEARCH, OpKind.SCAN):
        store2, ok, res = _apply(st.store, kind, key, value)
        return [_commit(st, cid, kind, key, value, ok, res, store2)]

    if not _pess(sc, cid):
        if cl.pc == START:   # one-sided READ of the pointer (snapshot)
            val, ver = st.store[key]
            if kind == OpKind.INSERT and val is not None:
                out.append(_commit(st, cid, kind, key, value, False, -1, st.store))
            elif kind != OpKind.INSERT and val is None:
                out.append(_commit(st, cid, kind, key, value, False, -1, st.store))
            else:
                out.append(st._replace(clients=_set(
                    st.clients, cid, cl._replace(pc=OCAS, aux=("snap", val, ver)))))
        elif cl.pc == OCAS:  # the CAS linearization point
            val, ver = st.store[key]
            if kind == OpKind.INSERT:
                # slot-claim CAS: succeeds iff the slot is (still) empty —
                # a raced INSERT fails, it does not retry (§4.2.2)
                store2, ok, res = _apply(st.store, kind, key, value)
                out.append(_commit(st, cid, kind, key, value, ok, res, store2))
            elif ver == cl.aux[2]:
                store2, ok, res = _apply(st.store, kind, key, value)
                out.append(_commit(st, cid, kind, key, value, ok, res, store2))
            else:            # CAS lost: re-read and retry (§2.2)
                out.append(st._replace(clients=_set(
                    st.clients, cid, cl._replace(pc=START, aux=None))))
        return out

    if sc.mode == SyncMode.SPIN:
        holder = st.locks[key]
        if cl.pc == START:
            if holder == -1:
                out.append(st._replace(
                    locks=_set(st.locks, key, cid),
                    clients=_set(st.clients, cid, cl._replace(pc=CS))))
            elif holder != cid and (st.crashed[holder]
                                    or not sc.flags.repair_requires_dead_holder):
                out.append(st._replace(     # §4.6: break the orphaned lock
                    locks=_set(st.locks, key, -1),
                    repairs=st.repairs + ((key, holder, st.crashed[holder]),)))
        elif cl.pc == CS:
            store2, ok, res = _apply(st.store, kind, key, value)
            ev = Ev(cid, cl.ticket, kind, key, value, ok, res)
            out.append(st._replace(
                store=store2, events=st.events + (ev,),
                clients=_set(st.clients, cid,
                             cl._replace(pc=REL, ok=ok, out=res))))
        elif cl.pc == REL:   # unlock CAS (unconditional reset, as SUNL)
            out.append(st._replace(
                locks=_set(st.locks, key, -1),
                clients=_set(st.clients, cid, cl._replace(pc=DONE))))
        return out

    # MCS / CIDER ticket queue
    nt, ns = st.locks[key]
    if cl.pc == START:       # ENQ: fetch-and-add the tail
        out.append(st._replace(
            locks=_set(st.locks, key, (nt + 1, ns)),
            clients=_set(st.clients, cid, cl._replace(pc=WAIT, ticket=nt))))
    elif cl.pc == WAIT:
        if ns == cl.ticket:  # acquired
            aux = None
            if (sc.mode == SyncMode.CIDER and kind == OpKind.UPDATE
                    and nt - 1 > cl.ticket
                    and (sc.flags.combine_covers_deletes
                         or not _queued_delete(sc, st, key))):
                aux = ("tail", nt - 1)   # coordinator: tail latched at acquire
            out.append(st._replace(clients=_set(
                st.clients, cid, cl._replace(pc=CS, aux=aux))))
        else:                # §4.6: advance now_serving past a dead owner
            owner = _ticket_owner(sc, st, key, ns)
            if owner is not None and owner != cid and (
                    st.crashed[owner]
                    or not sc.flags.repair_requires_dead_holder):
                out.append(st._replace(
                    locks=_set(st.locks, key, (nt, ns + 1)),
                    repairs=st.repairs + ((key, owner, st.crashed[owner]),)))
    elif cl.pc == CS:
        if cl.aux is None:   # plain pessimistic: MW + MCAS
            store2, ok, res = _apply(st.store, kind, key, value)
            ev = Ev(cid, cl.ticket, kind, key, value, ok, res)
            out.append(st._replace(
                store=store2, events=st.events + (ev,),
                clients=_set(st.clients, cid,
                             cl._replace(pc=REL, ok=ok, out=res))))
        else:                # coordinator: combined CAS + release to tail
            out.append(_combine(sc, st, cid))
    elif cl.pc == REL:       # MFAA release
        out.append(st._replace(
            locks=_set(st.locks, key, (nt, cl.ticket + 1)),
            clients=_set(st.clients, cid, cl._replace(pc=DONE))))
    return out


def _successors(sc: Scenario, st: St) -> tuple[list[St], list[St]]:
    real: list[St] = []
    crash: list[St] = []
    can_crash = not any(st.crashed)   # at most one crash per run (§4.6 scope)
    for cid, cl in enumerate(st.clients):
        if st.crashed[cid] or cl.pc == DONE:
            continue
        real.extend(_steps(sc, st, cid))
        if can_crash:
            crash.append(st._replace(crashed=_set(st.crashed, cid, True)))
    return real, crash


# ---------------------------------------------------------------- checks
def _op_name(sc: Scenario, cid: int) -> str:
    kind, key = sc.ops[cid]
    return f"client {cid} ({OpKind(kind).name} key {key})"


def _check_state(sc: Scenario, st: St, msgs: set) -> None:
    for key in range(N_KEYS):
        holders = [i for i, c in enumerate(st.clients)
                   if not st.crashed[i] and c.pc in (CS, REL)
                   and sc.ops[i][1] == key]
        if len(holders) > 1:
            msgs.add(f"mutual exclusion broken on key {key}: live clients "
                     f"{holders} are inside the critical section together")


def _check_terminal(sc: Scenario, st: St, msgs: set) -> None:
    for i, c in enumerate(st.clients):
        if not st.crashed[i] and c.pc != DONE:
            msgs.add(f"liveness: {_op_name(sc, i)} is stuck at "
                     f"pc={_PC_NAME[c.pc]} with no step left")
    counts = Counter(ev.cid for ev in st.events)
    for i, c in enumerate(st.clients):
        if not st.crashed[i] and c.pc == DONE and counts.get(i, 0) != 1:
            msgs.add(f"{_op_name(sc, i)} completed with {counts.get(i, 0)} "
                     f"committed events — its op was lost (or duplicated)")
    for key in range(N_KEYS):
        ranks = [ev.ticket for ev in st.events
                 if ev.key == key and ev.ticket >= 0]
        if ranks != sorted(ranks):
            msgs.add(f"commit order breaks wait-queue rank order on key "
                     f"{key}: tickets committed as {ranks}")
    for key, owner, owner_was_crashed in st.repairs:
        if not owner_was_crashed:
            msgs.add(f"§4.6 repair broke a LIVE lock on key {key} "
                     f"(owner client {owner} had not crashed)")
    _replay_oracle(sc, st.events,
                   {k: v for k, (v, _) in enumerate(st.store)
                    if v is not None}, msgs)


def _replay_oracle(sc, events: tuple, model_kv: dict, msgs: set) -> None:
    """Oracle replay: commit order must be a correct sequential history
    and the terminal (resolved) store must match the oracle's."""
    oracle = OracleStore()
    oracle.populate(list(sc.init_keys), [0] * len(sc.init_keys))
    for ev in events:
        ok, out = oracle.apply([ev.kind], [ev.key], [ev.value],
                               scan_max=SCAN_COUNT)
        if bool(ok[0]) != ev.ok:
            msgs.add(f"oracle replay diverges: {_op_name(sc, ev.cid)} "
                     f"committed ok={ev.ok}, oracle says {bool(ok[0])}")
        elif ev.kind == OpKind.SEARCH and int(out[0]) != ev.out:
            msgs.add(f"oracle replay diverges: {_op_name(sc, ev.cid)} read "
                     f"{ev.out}, oracle says {int(out[0])}")
        elif ev.kind == OpKind.SCAN and int(oracle.rows[0]) != ev.out:
            msgs.add(f"oracle replay diverges: {_op_name(sc, ev.cid)} saw "
                     f"{ev.out} rows, oracle says {int(oracle.rows[0])}")
    if model_kv != oracle.kv:
        msgs.add(f"terminal store diverges from oracle replay: "
                 f"model={model_kv} oracle={oracle.kv}")


# ---------------------------------------------------------------- explore
def explore(sc: Scenario, allow_crash: bool = True,
            max_states: int = 500_000) -> tuple[list[Violation], int]:
    """DFS every interleaving of ``sc``; returns (violations, #states)."""
    init = St(
        store=tuple((0, 0) if k in sc.init_keys else (None, 0)
                    for k in range(N_KEYS)),
        locks=tuple((-1 if sc.mode == SyncMode.SPIN else (0, 0))
                    for _ in range(N_KEYS)),
        clients=tuple(Cl(START, -1, None, False, -1) for _ in sc.ops),
        crashed=(False,) * len(sc.ops), events=(), repairs=())
    seen = {init}
    stack = [init]
    msgs: set[str] = set()
    n = 0
    while stack:
        st = stack.pop()
        n += 1
        if n > max_states:
            msgs.add(f"state-space blowup: more than {max_states} states")
            break
        _check_state(sc, st, msgs)
        real, crash = _successors(sc, st)
        if not real:
            # terminal modulo crashes: no live client can take a real step
            _check_terminal(sc, st, msgs)
        for nxt in real + (crash if allow_crash else []):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return ([Violation("race_check", sc.describe(), m) for m in sorted(msgs)],
            len(seen))


def scenarios(quick: bool = True):
    """The checked scenario space: every mode x op-multiset x initial store
    (x CIDER hotness).  2 clients range over both keys and every OpKind;
    3 clients (the coordinator/member/straggler shapes) stay on key 0."""
    point = [OpKind.SEARCH, OpKind.INSERT, OpKind.UPDATE, OpKind.DELETE]
    ops = [(k, key) for k in point for key in range(N_KEYS)] \
        + [(OpKind.SCAN, 0)]
    stores2 = [(), (0,), (1,), (0, 1)]
    stores3 = [(), (0,), (0, 1)] if quick else stores2
    ops3 = [o for o in ops if o[1] == 0]
    for mode in SyncMode:
        hots = ([(True, True), (False, False)] if mode == SyncMode.CIDER
                else [(False,) * N_KEYS])
        for hot in hots:
            for pair in itertools.combinations_with_replacement(ops, 2):
                for init in stores2:
                    yield Scenario(mode, pair, tuple(init), hot)
            for trip in itertools.combinations_with_replacement(ops3, 3):
                for init in stores3:
                    yield Scenario(mode, trip, tuple(init), hot)


# ---------------------------------------------- replicated-write machine
# Client-centric MN replication (DESIGN.md §13): no replica runs a CPU —
# the WRITING client updates every replica itself.  The write commits at
# the primary CAS; the secondary fan-out is a separate step guarded by a
# last-writer-wins version CAS, and the (single) injected crash may land
# between the two, leaving the replicas divergent.  Real reads resolve
# the max-version cell across ALL replicas and write the laggards back
# (repair modeled atomic with the read — dropping interleavings never
# hides a bug, it only strengthens the machine the seeded fixture must
# still defeat).  ``ModelFlags.stale_replica_read`` serves whichever
# single replica the scheduler picks instead: after a partial fan-out the
# read returns the stale cell and the checker flags it twice — the oracle
# replay diverges, and an explicit record names the divergent replicas.

RSTART, RFAN, RDONE = range(3)
_R_PC_NAME = ("START", "FAN", "DONE")


@dataclasses.dataclass(frozen=True)
class ReplScenario:
    """A replicated-write model instance: per-client (kind, key) programs
    over ``N_REPLICAS`` replica stores."""
    ops: tuple                       # per client: (kind, key)
    init_keys: tuple                 # keys present at start on ALL replicas
    flags: ModelFlags = REAL

    def value(self, cid: int) -> int:
        return SCAN_COUNT if self.ops[cid][0] == OpKind.SCAN else 100 + cid

    def describe(self) -> str:
        ops = ",".join(f"{OpKind(k).name}{key}" for k, key in self.ops)
        bug = " stale_replica_read" if self.flags.stale_replica_read else ""
        return f"REPL[{ops}] init={list(self.init_keys)}{bug}"


class RSt(NamedTuple):
    stores: tuple          # per replica: per key (val | None, ver)
    clients: tuple         # Cl per client (ticket unused, -1)
    crashed: tuple
    events: tuple          # Ev, commit order (= primary CAS order)
    stale: tuple           # (key, replica, got_ver, best_replica, best_ver)


def _resolved(stores: tuple) -> tuple:
    """Per-key last-writer-wins resolution: the max-version cell wins."""
    return tuple(max((stores[r][k] for r in range(N_REPLICAS)),
                     key=lambda cell: cell[1])
                 for k in range(N_KEYS))


def _r_read_keys(kind: int, key: int) -> range:
    return range(key, min(key + SCAN_COUNT, N_KEYS)) \
        if kind == OpKind.SCAN else range(key, key + 1)


def _r_steps(sc: ReplScenario, st: RSt, cid: int) -> list[RSt]:
    """All real (non-crash) successor states from client ``cid``."""
    kind, key = sc.ops[cid]
    cl = st.clients[cid]
    value = sc.value(cid)

    if kind in (OpKind.SEARCH, OpKind.SCAN):
        if sc.flags.stale_replica_read:
            # seeded bug: serve ONE arbitrary replica, no resolution/repair
            best = _resolved(st.stores)
            outs = []
            for r in range(N_REPLICAS):
                _, ok, res = _apply(st.stores[r], kind, key, value)
                stale = st.stale
                for k in _r_read_keys(kind, key):
                    if st.stores[r][k][1] < best[k][1]:
                        br = max(range(N_REPLICAS),
                                 key=lambda i: st.stores[i][k][1])
                        stale = stale + (
                            (k, r, st.stores[r][k][1], br, best[k][1]),)
                ev = Ev(cid, -1, kind, key, value, ok, res)
                outs.append(st._replace(
                    events=st.events + (ev,), stale=stale,
                    clients=_set(st.clients, cid,
                                 cl._replace(pc=RDONE, ok=ok, out=res))))
            return outs
        # real machine: max-version resolution + roll-forward repair
        best = _resolved(st.stores)
        _, ok, res = _apply(best, kind, key, value)
        stores = tuple(
            tuple(best[k] if k in _r_read_keys(kind, key) else store[k]
                  for k in range(N_KEYS))
            for store in st.stores)
        ev = Ev(cid, -1, kind, key, value, ok, res)
        return [st._replace(
            stores=stores, events=st.events + (ev,),
            clients=_set(st.clients, cid,
                         cl._replace(pc=RDONE, ok=ok, out=res)))]

    if cl.pc == RSTART:
        # primary CAS: the commit point — the event lands here
        store2, ok, res = _apply(st.stores[0], kind, key, value)
        ev = Ev(cid, -1, kind, key, value, ok, res)
        nxt = cl._replace(pc=RFAN if ok else RDONE,
                          aux=("fan", key, store2[key]) if ok else None,
                          ok=ok, out=res)
        return [st._replace(
            stores=_set(st.stores, 0, store2),
            events=st.events + (ev,),
            clients=_set(st.clients, cid, nxt))]
    if cl.pc == RFAN:
        # secondary fan-out: last-writer-wins version CAS per replica
        _, fkey, cell = cl.aux
        stores = st.stores
        for r in range(1, N_REPLICAS):
            if stores[r][fkey][1] < cell[1]:
                stores = _set(stores, r, _set(stores[r], fkey, cell))
        return [st._replace(
            stores=stores,
            clients=_set(st.clients, cid,
                         cl._replace(pc=RDONE, aux=None)))]
    return []


def _r_check_terminal(sc: ReplScenario, st: RSt, msgs: set) -> None:
    for i, c in enumerate(st.clients):
        if not st.crashed[i] and c.pc != RDONE:
            msgs.add(f"liveness: {_op_name(sc, i)} is stuck at "
                     f"pc={_R_PC_NAME[c.pc]} with no step left")
    counts = Counter(ev.cid for ev in st.events)
    for i, c in enumerate(st.clients):
        if not st.crashed[i] and c.pc == RDONE and counts.get(i, 0) != 1:
            msgs.add(f"{_op_name(sc, i)} completed with {counts.get(i, 0)} "
                     f"committed events — its op was lost (or duplicated)")
    for k, r, got_ver, best_r, best_ver in st.stale:
        msgs.add(f"stale-replica read on key {k}: served replica {r} at "
                 f"version {got_ver} while replica {best_r} held version "
                 f"{best_ver} — replicas diverge and the read skipped "
                 f"last-writer-wins resolution")
    if not any(st.crashed):
        # no crash: every fan-out completed, so replicas must agree
        for k in range(N_KEYS):
            cells = {st.stores[r][k] for r in range(N_REPLICAS)}
            if len(cells) > 1:
                per = ", ".join(f"replica {r}={st.stores[r][k]}"
                                for r in range(N_REPLICAS))
                msgs.add(f"replicas diverge at quiescence on key {k} "
                         f"with no crash: {per}")
    best = _resolved(st.stores)
    _replay_oracle(sc, st.events,
                   {k: v for k, (v, _) in enumerate(best)
                    if v is not None}, msgs)


def explore_replicated(sc: ReplScenario, allow_crash: bool = True,
                       max_states: int = 200_000
                       ) -> tuple[list[Violation], int]:
    """DFS every interleaving of the replicated machine for ``sc``."""
    init = RSt(
        stores=tuple(tuple((0, 0) if k in sc.init_keys else (None, 0)
                           for k in range(N_KEYS))
                     for _ in range(N_REPLICAS)),
        clients=tuple(Cl(RSTART, -1, None, False, -1) for _ in sc.ops),
        crashed=(False,) * len(sc.ops), events=(), stale=())
    seen = {init}
    stack = [init]
    msgs: set[str] = set()
    n = 0
    while stack:
        st = stack.pop()
        n += 1
        if n > max_states:
            msgs.add(f"state-space blowup: more than {max_states} states")
            break
        real: list[RSt] = []
        crash: list[RSt] = []
        can_crash = allow_crash and not any(st.crashed)
        for cid, cl in enumerate(st.clients):
            if st.crashed[cid] or cl.pc == RDONE:
                continue
            real.extend(_r_steps(sc, st, cid))
            if can_crash:
                crash.append(st._replace(crashed=_set(st.crashed, cid, True)))
        if not real:
            _r_check_terminal(sc, st, msgs)
        for nxt in real + crash:
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return ([Violation("race_check", sc.describe(), m) for m in sorted(msgs)],
            len(seen))


def repl_scenarios(quick: bool = True):
    """The replicated scenario space: every op pair over both keys plus
    the writer/writer/reader triples on key 0, each against every initial
    store — crash-at-any-step lands between primary CAS and fan-out."""
    point = [OpKind.SEARCH, OpKind.INSERT, OpKind.UPDATE, OpKind.DELETE]
    ops = [(k, key) for k in point for key in range(N_KEYS)] \
        + [(OpKind.SCAN, 0)]
    stores = [(), (0,), (0, 1)] if quick else [(), (0,), (1,), (0, 1)]
    ops3 = [o for o in ops if o[1] == 0]
    for pair in itertools.combinations_with_replacement(ops, 2):
        for init in stores:
            yield ReplScenario(pair, tuple(init))
    for trip in itertools.combinations_with_replacement(ops3, 3):
        for init in stores:
            yield ReplScenario(trip, tuple(init))


# ------------------------------------------------- tick-level conformance
def _sim_conformance(notes: list[str] | None, device="cuda",
                     record: list | None = None) -> list[Violation]:
    """Prove the shipped ``del_q`` gate on the real ``protocol.tick``
    machine agrees with the model: with a DELETE queued behind two UPDATEs
    on one key, no combined batch may form (and the delete must drain the
    gate); the delete-free control still combines.  The runs go through
    ``core.sim._run`` on ``device`` (its CUDA graphs are appended to
    ``record``, a list, to count their launches)."""
    import numpy as np  # deferred: keeps the model checker import-light
    import torch
    from repro_torch.core.sim import _run
    from repro_torch.core.simnet import SimParams
    from repro_torch.core.types import as_device

    dev = as_device(device)

    def streams(first):
        n, m = 3, 4
        kinds = np.full((n, m), OpKind.SEARCH, np.int32)
        kinds[:, 0] = first
        hkey = np.full((n, m), 9, np.int32)
        hkey[:, 0] = 5
        hc = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, m))
        return {k: torch.as_tensor(v, device=dev) for k, v in (
            ("kinds", kinds), ("hkey", hkey), ("hc", hc), ("hl", hc.copy()))}

    def counters(s):
        host = torch.stack([s.comb_g, s.del_q[5], s.deadlocks, s.done]).cpu()
        return [int(x) for x in host]

    p = SimParams(n_lanes=3, lanes_per_cn=1, max_ops=4, ticks=400,
                  cas_off=True, local_wc=False, h_bits=4, hc_bits=2,
                  hl_bits=2)
    out = []
    comb_g, del_q5, deadlocks, done = counters(_run(
        p, SyncMode.CIDER,
        streams([OpKind.UPDATE, OpKind.UPDATE, OpKind.DELETE]), 3,
        record=record))
    if comb_g != 0:
        out.append(Violation(
            "race_check", "protocol.tick del_q gate",
            f"combined batch formed over a queued DELETE "
            f"(comb_g={comb_g}) — the lost-delete gate is broken"))
    if del_q5 != 0:
        out.append(Violation(
            "race_check", "protocol.tick del_q gate",
            f"del_q did not drain (del_q[5]={del_q5}) — "
            f"increments/decrements are unbalanced"))
    if deadlocks != 0 or done == 0:
        out.append(Violation(
            "race_check", "protocol.tick del_q gate",
            f"delete-gated run wedged (done={done}, "
            f"deadlocks={deadlocks})"))
    ctl_comb_g = counters(_run(p, SyncMode.CIDER,
                               streams([OpKind.UPDATE] * 3), 3,
                               record=record))[0]
    if ctl_comb_g == 0:
        out.append(Violation(
            "race_check", "protocol.tick del_q gate",
            "delete-free control never combined — the gate is firing "
            "without a queued DELETE (combining disabled outright)"))
    if notes is not None:
        notes.append(f"race_check: tick conformance comb_g="
                     f"{comb_g}/{ctl_comb_g} (delete/control) on {dev}")
    return out


def run(notes: list[str] | None = None, quick: bool = True,
        max_report: int = 64, device="cuda") -> list[Violation]:
    """Model-check every scenario with the REAL protocol flags — the
    per-mode machines, then the replicated-write machine — then the
    tick-level conformance check against ``protocol.tick`` on ``device``."""
    out: list[Violation] = []
    n_sc = n_states = 0
    truncated = False
    for sc in scenarios(quick=quick):
        viols, states = explore(sc)
        out.extend(viols)
        n_sc += 1
        n_states += states
        if len(out) >= max_report:
            out.append(Violation("race_check", "(reporting)",
                                 f"truncated after {max_report} violations"))
            truncated = True
            break
    n_rsc = n_rstates = 0
    if not truncated:
        for rsc in repl_scenarios(quick=quick):
            viols, states = explore_replicated(rsc)
            out.extend(viols)
            n_rsc += 1
            n_rstates += states
            if len(out) >= max_report:
                out.append(Violation("race_check", "(reporting)",
                                     f"truncated after {max_report} "
                                     f"violations"))
                break
    if notes is not None:
        notes.append(f"race_check: {n_sc} scenarios, {n_states} states + "
                     f"{n_rsc} replicated scenarios, {n_rstates} states")
    out.extend(_sim_conformance(notes, device))
    return out
