"""Cost model of the disaggregated-memory fabric (port of the ``SimParams``
half of ``repro.core.simnet``).

The memory-pool NIC is the bottleneck resource: ``mn_cap`` verbs and
``mn_bw`` bytes per tick (1 tick == 1 us); CN<->CN messages cost ``cn_rtt``
and are uncontended.  ``runner.modeled_throughput``/``modeled_latency`` read
these constants.  The tick simulator (``NetState``/``issue_mn``) belongs to
the protocol-simulator slice of the port.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SimParams"]


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
