"""YCSB workload generation (Cooper et al., SoCC'10; port of
``repro.workloads.ycsb``: the same numpy generators, identical arrays from
identical seeds).  Host-side op streams that ``runner.make_stream`` stacks
into ``WindowStream``s.

Two families:

* the paper's three ad-hoc mixes (Table 1: ``WORKLOADS`` — write-intensive
  50/50, read-intensive 95/5, write-only 100) via ``generate_ops`` /
  ``generate_window_stream``; "write" means UPDATE of an existing key, with
  configurable fresh-key INSERT / DELETE fractions partitioning the write
  budget disjointly;
* the full **YCSB core suite A–F** (``YCSB`` + ``generate_ycsb_stream``) —
  the benchmark behind the paper's "up to 6.6x under YCSB" headline:

  ====  =======================  =====================================
  A     50% read / 50% update    Zipf(0.99) over the populated universe
  B     95% read /  5% update    same
  C     100% read                same
  D     95% read /  5% insert    reads follow the *latest* distribution
                                 (Zipf over recency behind the insert
                                 frontier)
  E     95% scan /  5% insert    scan start Zipf, length ~ U[1, scan_max]
                                 (count rides ``values`` — OpKind.SCAN)
  F     50% read / 50% RMW       each read-modify-write occupies two
                                 adjacent lanes: SEARCH then UPDATE of the
                                 same key (serialized by batch position)
  ====  =======================  =====================================

Keys are drawn Zipf(theta=0.99 by default) over a populated universe of
``n_keys`` (paper: 60M, 8-byte keys / 8-byte values).  D and E grow the
universe: INSERTs take distinct fresh keys at the frontier (``n_keys``
upward), and window w's reads/scans draw over the frontier as of the start
of window w, so every generated point read targets a key that exists.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import OpKind
from repro_torch.workloads.zipf import ZipfSampler

__all__ = ["WorkloadSpec", "WORKLOADS", "generate_ops",
           "generate_window_stream", "YCSBSpec", "YCSB",
           "generate_ycsb_stream"]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    write_ratio: float
    read_ratio: float
    theta: float = 0.99
    insert_fraction: float = 0.0   # fraction of writes that are fresh-key INSERTs
    delete_fraction: float = 0.0   # fraction of writes that are DELETEs


WORKLOADS = {
    "write-intensive": WorkloadSpec("write-intensive", 0.50, 0.50),
    "read-intensive": WorkloadSpec("read-intensive", 0.05, 0.95),
    "write-only": WorkloadSpec("write-only", 1.00, 0.00),
}


@dataclasses.dataclass
class OpBatchNp:
    """Host-side generated op stream (numpy)."""

    kinds: np.ndarray   # (T,) uint8 OpKind
    keys: np.ndarray    # (T,) int64 key ids
    values: np.ndarray  # (T,) int64 payload (value id written by this op)
    clients: np.ndarray  # (T,) int32 issuing client id


def generate_ops(spec: WorkloadSpec, n_ops: int, n_keys: int, n_clients: int,
                 seed: int = 0, theta: float | None = None) -> OpBatchNp:
    """Generate a flat op stream; ops are interleaved round-robin over clients
    (client c issues ops c, c+n_clients, ... — matching closed-loop clients)."""
    df, inf = spec.delete_fraction, spec.insert_fraction
    if df + inf > 1.0:
        raise ValueError(
            f"delete_fraction ({df}) + insert_fraction ({inf}) must be <= 1")
    rng = np.random.default_rng(seed + 1)
    theta = spec.theta if theta is None else theta
    zipf = ZipfSampler(n_keys, theta, seed=seed)
    keys = zipf.sample(n_ops)
    kinds = np.full(n_ops, OpKind.SEARCH, dtype=np.uint8)
    u = rng.random(n_ops)
    is_write = u < spec.write_ratio
    kinds[is_write] = OpKind.UPDATE
    if df > 0 or inf > 0:
        # ONE draw partitions the write fraction disjointly:
        # [0, df) -> DELETE, [df, df+inf) -> INSERT, the rest stay UPDATE.
        v = rng.random(n_ops)
        kinds[is_write & (v < df)] = OpKind.DELETE
        is_ins = is_write & (v >= df) & (v < df + inf)
        if inf > 0:
            kinds[is_ins] = OpKind.INSERT
            # fresh keys beyond the populated universe
            keys = np.where(is_ins, rng.integers(n_keys, 2 * n_keys, n_ops),
                            keys)
    values = rng.integers(1, 2**31 - 1, size=n_ops, dtype=np.int64)
    clients = (np.arange(n_ops) % n_clients).astype(np.int32)
    return OpBatchNp(kinds=kinds, keys=keys, values=values, clients=clients)


def generate_window_stream(spec: WorkloadSpec, windows: int, n_ops: int,
                           n_keys: int, n_clients: int, seed: int = 0,
                           theta: float | None = None) -> OpBatchNp:
    """Generate ``windows`` stacked synchronization windows, arrays ``(W, n_ops)``.

    Window ``w`` is exactly ``generate_ops(spec, n_ops, ..., seed=seed + w)``,
    so a stream fed to ``repro_torch.core.runner.run_windows`` replays the batches a
    per-window loop over ``generate_ops`` would have produced.
    """
    wins = [generate_ops(spec, n_ops, n_keys, n_clients, seed=seed + w,
                         theta=theta) for w in range(windows)]
    return OpBatchNp(kinds=np.stack([o.kinds for o in wins]),
                     keys=np.stack([o.keys for o in wins]),
                     values=np.stack([o.values for o in wins]),
                     clients=np.stack([o.clients for o in wins]))


# ---------------------------------------------------------------------------
# The YCSB core suite (A-F)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class YCSBSpec:
    """One YCSB core workload: request-type fractions + key distribution.

    Fractions are over *requests*; an ``rmw`` request (workload F) occupies
    two adjacent lanes (SEARCH then UPDATE of the same key), so its lane
    share is twice its request share.  ``latest`` switches reads to the
    recency distribution (workload D); ``scan_max`` bounds E's uniform
    scan-length draw.  Keep it <= the engine's static
    ``EngineConfig.scan_max``: the engine truncates longer runs
    (``Results.rows`` covers the clipped range only) and
    ``runner.modeled_latency`` clips its per-leaf bill to the same bound,
    so an oversized draw degrades to the engine's range, never diverges.
    """
    name: str
    read: float = 0.0
    update: float = 0.0
    insert: float = 0.0
    scan: float = 0.0
    rmw: float = 0.0
    theta: float = 0.99
    latest: bool = False
    scan_max: int = 16

    def __post_init__(self):
        tot = self.read + self.update + self.insert + self.scan + self.rmw
        if abs(tot - 1.0) > 1e-9:
            raise ValueError(f"request fractions must sum to 1, got {tot}")


YCSB = {
    "A": YCSBSpec("A", read=0.50, update=0.50),
    "B": YCSBSpec("B", read=0.95, update=0.05),
    "C": YCSBSpec("C", read=1.00),
    "D": YCSBSpec("D", read=0.95, insert=0.05, latest=True),
    "E": YCSBSpec("E", scan=0.95, insert=0.05),
    "F": YCSBSpec("F", read=0.50, rmw=0.50),
}


def generate_ycsb_stream(spec: YCSBSpec, windows: int, n_ops: int,
                         n_keys: int, n_clients: int, seed: int = 0,
                         theta: float | None = None) -> OpBatchNp:
    """Generate the full-suite op stream: ``(windows, n_ops)`` arrays.

    * INSERTs (D, E) take distinct fresh keys at the frontier (``n_keys``
      upward), one per insert — the caller must size the engine keyspace
      (``EngineConfig.n_slots``) for ``n_keys`` plus the expected inserts.
    * Window ``w``'s reads/scans draw over the frontier as of the *start*
      of window ``w``, so every point read targets an existing key.
    * D's reads draw a recency rank r ~ Zipf(theta) and touch key
      ``frontier - 1 - r`` — YCSB's "latest" distribution.
    * E's SCAN lanes carry their length (uniform on [1, scan_max]) in
      ``values``; lengths past the keyspace end are truncated by the engine.
    * F's RMW requests emit two adjacent lanes — SEARCH then UPDATE of the
      same key — serialized by batch position exactly like a client that
      reads, modifies, then writes.
    * ``clients`` records the closed-loop issuing client (round-robin over
      ``n_clients``), the same bookkeeping ``generate_ops`` emits for the
      simulator path; the engine path assigns CNs in
      ``runner.make_stream(n_cns=...)`` independently of this field.
    """
    theta = spec.theta if theta is None else theta
    frontier = n_keys
    kinds_w, keys_w, vals_w = [], [], []
    probs = np.array([spec.read, spec.update, spec.insert, spec.scan,
                      spec.rmw])
    for w in range(windows):
        rng = np.random.default_rng((seed, w))
        zipf = ZipfSampler(frontier, theta, seed=seed * 7919 + w)
        # request draw; RMW requests expand to 2 lanes, so draw n_ops
        # requests and truncate the expansion back to n_ops lanes
        req = rng.choice(5, size=n_ops, p=probs)
        lens = np.where(req == 4, 2, 1)
        lane_req = np.repeat(np.arange(n_ops), lens)[:n_ops]
        first = np.concatenate([[True], lane_req[1:] != lane_req[:-1]])
        rk = req[lane_req]
        kinds = np.full(n_ops, OpKind.SEARCH, dtype=np.uint8)
        kinds[rk == 1] = OpKind.UPDATE
        kinds[rk == 2] = OpKind.INSERT
        kinds[rk == 3] = OpKind.SCAN
        kinds[(rk == 4) & ~first] = OpKind.UPDATE      # RMW second lane
        # keys: one draw per request, shared by both RMW lanes
        if spec.latest:
            recency = zipf.sample(n_ops, scrambled=False)
            req_keys = frontier - 1 - recency
        else:
            req_keys = zipf.sample(n_ops)
        is_ins = rk == 2
        n_ins = int(is_ins.sum())
        keys = req_keys[lane_req]
        keys[is_ins] = frontier + np.arange(n_ins)     # distinct fresh keys
        values = rng.integers(1, 2**31 - 1, size=n_ops, dtype=np.int64)
        is_scan = kinds == OpKind.SCAN
        values[is_scan] = rng.integers(1, spec.scan_max + 1,
                                       size=int(is_scan.sum()))
        frontier += n_ins
        kinds_w.append(kinds)
        keys_w.append(keys)
        vals_w.append(values)
    clients = np.broadcast_to(np.arange(n_ops) % n_clients,
                              (windows, n_ops)).astype(np.int32)
    return OpBatchNp(kinds=np.stack(kinds_w), keys=np.stack(keys_w),
                     values=np.stack(vals_w), clients=clients.copy())
