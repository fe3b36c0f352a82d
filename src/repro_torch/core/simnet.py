"""Cost model of the disaggregated-memory fabric (port of
``repro.core.simnet``).

The memory-pool NIC is the bottleneck resource: a token-bucket server with
``mn_cap`` verbs and ``mn_bw`` bytes per tick (1 tick == 1 us); excess
arrivals queue FIFO by lane id within a tick, so a verb issued under backlog
*B* completes after ``rtt + B/cap`` ticks.  Atomics on one (hashed) address
serialize at ``addr_atomic_cap`` per tick behind their own backlog.  CN<->CN
messages cost ``cn_rtt`` and are uncontended.  ``runner.modeled_throughput``
/``modeled_latency`` read the constants; the protocol simulator
(``core.protocol.tick``) issues its verbs through ``issue_mn``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.combine import (_first_last_rank, _unsort, cumsum_i32,
                                      lexsort2, sum_i32)

__all__ = ["SimParams", "NetState", "net_init", "issue_mn"]

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SimParams:
    # population
    n_lanes: int = 1024          # physical client lanes (mask unused ones)
    lanes_per_cn: int = 4        # paper: 4 clients per (virtual) CN
    max_ops: int = 4096          # pregenerated ops per lane (wraps around)
    # time
    ticks: int = 32768           # simulated microseconds
    rtt: int = 2                 # MN verb round-trip (ticks)
    cn_rtt: int = 2              # client<->client message (ticks)
    think: int = 1               # client compute between ops (ticks)
    # memory-pool NIC
    mn_cap: int = 32             # capacity tokens/tick (reads: 1 token each)
    atomic_cost: int = 1         # CAS/FAA token cost
    addr_atomic_cap: int = 2     # same-ADDRESS atomics/tick
    mn_bw: int = 12500           # bytes/tick (100 Gbps)
    value_bytes: int = 8
    index_bytes: int = 8
    index_reads: int = 1         # per-op index I/O (pointer array: 1)
    # synchronization parameters
    escape_retries: int = 8
    backoff_cap: int = 6         # SPIN truncated exponential backoff
    # factor-analysis switches (Fig 20)
    wc_off: bool = False
    cas_off: bool = False
    local_wc: bool = True
    initial_credit: int = 36     # §4.3 / Fig 15
    hotness_threshold: int = 2
    aimd_factor: int = 2
    # tables
    h_bits: int = 14
    hc_bits: int = 10
    hl_bits: int = 10
    hist_buckets: int = 2048
    # SNAPSHOT client-centric replication
    n_replicas: int = 1
    replica_rtt: int = 2
    # fault tolerance (§4.6)
    fail_lane: int = -1
    fail_tick: int = -1
    fail_lanes: tuple[int, ...] = ()
    max_wait: int = 4096
    # lease a blocked queue waits out before breaking an orphaned lock
    # (runner.modeled_latency)
    lease_us: int = 512


@dataclasses.dataclass
class NetState:
    backlog: torch.Tensor       # () int32: queued MN verbs
    byte_backlog: torch.Tensor  # () int32: queued MN bytes
    addr_backlog: torch.Tensor  # (H,) int32: queued same-address atomics


def net_init(h_size: int, device: str | torch.device = "cuda") -> NetState:
    return NetState(
        backlog=torch.zeros((), dtype=_I32, device=device),
        byte_backlog=torch.zeros((), dtype=_I32, device=device),
        addr_backlog=torch.zeros((h_size,), dtype=_I32, device=device))


def run_rank(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """0-based rank of each lane among the lanes with its ``key``, by lane
    id: the run rank of a stable sort on ``key`` (``jnp.lexsort((ids,
    key))``), through the ``wc_combine`` kernel on a card."""
    order = lexsort2(ids, key)
    _, _, rank = _first_last_rank(key[order], "auto")
    return _unsort(order, rank)


def issue_mn(net: NetState, t: torch.Tensor, issue: torch.Tensor,
             nbytes: torch.Tensor, cost: torch.Tensor,
             is_atomic: torch.Tensor, hkey: torch.Tensor, p: SimParams
             ) -> tuple[NetState, torch.Tensor]:
    """Issue MN verbs for the masked lanes; returns ``(net', done_at)``.

    ``issue``: (N,) bool; ``nbytes``: (N,) int32 wire bytes; ``cost``: (N,)
    int32 capacity tokens; ``is_atomic``/``hkey``: concurrent atomics on one
    hashed address pass at ``addr_atomic_cap`` per tick behind their own
    per-address FIFO backlog.  Global queueing is FIFO by lane id within the
    tick, behind the backlog.  ``t`` is the tick as a 0-dim int32 tensor.
    """
    h = net.addr_backlog.shape[0]
    c = cost * issue
    iops_delay = (net.backlog + cumsum_i32(c) - c) // p.mn_cap
    nb_m = nbytes * issue
    bw_delay = (net.byte_backlog + cumsum_i32(nb_m) - nb_m) // p.mn_bw
    # per-address atomic serialization; lanes without an atomic sort last
    # on the sentinel H and are dropped from the arrivals
    atom = issue & is_atomic
    ah = torch.where(atom, hkey, h)
    ids = torch.arange(issue.shape[0], dtype=_I32, device=issue.device)
    arank = run_rank(ah, ids)
    addr_q = net.addr_backlog.index_select(0, hkey.clamp(0, h - 1))
    addr_delay = (addr_q + arank) // p.addr_atomic_cap * atom
    delay = torch.maximum(torch.maximum(iops_delay, bw_delay), addr_delay)
    done_at = t + p.rtt + delay * issue
    arrivals = torch.zeros((h,), dtype=_I32, device=issue.device).index_add_(
        0, hkey * atom, atom.to(_I32))
    net2 = NetState(
        backlog=(net.backlog + sum_i32(c) - p.mn_cap).clamp_min(0),
        byte_backlog=(net.byte_backlog + sum_i32(nb_m) - p.mn_bw).clamp_min(0),
        addr_backlog=(net.addr_backlog + arrivals
                      - p.addr_atomic_cap).clamp_min(0))
    return net2, done_at
