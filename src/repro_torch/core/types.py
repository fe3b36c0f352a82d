"""Core types of the CIDER dataplane engine (port of ``repro.core.types``).

The paper's op vocabulary (§2.2): SEARCH / INSERT / UPDATE / DELETE over a
store of data pointers, plus SCAN (key + count) for range reads.  One-sided
RDMA verbs are metered per class because the paper's bottleneck argument is
on memory-node (MN) NIC *IOPS*; CN<->CN messages ride client NICs.

Every tensor here is int32 (bool for masks), as in the reference with x64
off: ``torch.cumsum``/``sum`` of int32 return int64, so the port casts back
at every reduction to keep the same dtypes and the same wrap-around.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch

__all__ = [
    "OpKind", "Verb", "SyncMode", "IOMetrics", "LatencyStats", "EngineConfig",
    "OpBatch", "NULL_PTR", "UnsupportedOpError", "io_zeros", "io_add",
    "per_replica_bill", "as_device", "as_i32", "to_numpy",
]

# A null data pointer (empty slot). Pointers are int32 heap indices >= 0.
NULL_PTR = -1

KERNEL_BACKENDS = ("auto", "torch")


def as_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` for ``device``; raises when CUDA is asked for and
    absent — the port never carries on on the CPU unless told to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' explicitly to run the plain PyTorch versions")
    return dev


def as_i32(x, device: str | torch.device) -> torch.Tensor:
    """``x`` (numpy array, list or tensor) as an int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=as_device(device), dtype=torch.int32)
    return torch.as_tensor(np.asarray(x).astype(np.int32),
                           device=as_device(device))


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class UnsupportedOpError(NotImplementedError):
    """An op kind the target index structure cannot serve *by design* —
    e.g. SCAN on a point-op store, which has no key order to traverse."""


class OpKind(enum.IntEnum):
    SEARCH = 0
    INSERT = 1
    UPDATE = 2
    DELETE = 3
    NOP = 4      # padding
    SCAN = 5     # range read: (key, count) — count rides OpBatch.values


class Verb(enum.IntEnum):
    """RDMA verb classes, for I/O metering."""
    READ = 0
    WRITE = 1
    CAS = 2          # includes masked-CAS (get-and-set) — same NIC cost
    FAA = 3
    CN_MSG = 4       # client<->client message: does NOT consume MN NIC IOPS


class SyncMode(enum.IntEnum):
    """The four synchronization schemes compared in the paper (§5.1)."""
    OSYNC = 0     # optimistic: out-of-place write + CAS-retry
    SPIN = 1      # CAS spinlock w/ truncated exponential backoff
    MCS = 2       # ShiftLock distributed MCS lock, no combining
    CIDER = 3     # MCS + global write-combining + contention-aware sync


@dataclasses.dataclass
class IOMetrics:
    """Per-verb I/O counters, each a 0-dim (or, stacked per window, (W,))
    int32 tensor.  ``mn_iops``/``mn_bytes`` are the bottleneck quantities
    (memory-pool NIC); ``cn_msgs`` ride client NICs."""
    reads: torch.Tensor
    writes: torch.Tensor
    cas: torch.Tensor
    faa: torch.Tensor
    cn_msgs: torch.Tensor
    mn_bytes: torch.Tensor
    retries: torch.Tensor         # redundant (failed) CAS attempts
    combined: torch.Tensor        # ops whose write was combined away
    executed: torch.Tensor        # ops that reached the store
    repair_cas: torch.Tensor      # orphan-repair verbs (§4.6)
    orphan_windows: torch.Tensor  # slot-windows with a stranded lock left

    @property
    def mn_iops(self) -> torch.Tensor:
        return self.reads + self.writes + self.cas + self.faa

    def as_dict(self) -> dict[str, Any]:
        d = {f.name: int(getattr(self, f.name).item())
             for f in dataclasses.fields(self)}
        d["mn_iops"] = d["reads"] + d["writes"] + d["cas"] + d["faa"]
        return d


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Modeled per-op latency percentiles (microseconds)."""
    p50_us: float
    p99_us: float
    mean_us: float
    max_us: float
    n_ops: int

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def io_zeros(device: str | torch.device = "cuda") -> IOMetrics:
    dev = as_device(device)
    return IOMetrics(*(torch.zeros((), dtype=torch.int32, device=dev)
                       for _ in dataclasses.fields(IOMetrics)))


def io_add(a: IOMetrics, b: IOMetrics) -> IOMetrics:
    return IOMetrics(*(getattr(a, f.name) + getattr(b, f.name)
                       for f in dataclasses.fields(IOMetrics)))


def per_replica_bill(io_one: IOMetrics, io_r: IOMetrics,
                     n_replicas: int) -> list[dict[str, int]]:
    """Decompose a replicated bill into per-replica-MN bills (host-side).

    ``io_one`` is the ``n_replicas=1`` bill of a run and ``io_r`` the
    ``n_replicas=R`` bill of the same run.  Write-class verbs go to every
    replica, reads to the primary only; raises ``ValueError`` when the two
    bills break the xR contract.  Summing the returned dicts field by field
    reproduces ``io_r``.
    """
    one, tot = io_one.as_dict(), io_r.as_dict()
    r = int(n_replicas)
    if r < 1:
        raise ValueError(f"n_replicas must be >= 1, got {r}")
    if r == 1:
        if one != tot:
            raise ValueError("R=1 bills differ; same run required")
        return [{k: v for k, v in one.items() if k != "mn_iops"}]
    for f in ("writes", "cas", "faa", "retries", "repair_cas"):
        if tot[f] != r * one[f]:
            raise ValueError(
                f"replicated bill violates x{r} write fan-out on '{f}': "
                f"{tot[f]} != {r} * {one[f]}")
    for f in ("reads", "cn_msgs", "combined", "executed", "orphan_windows"):
        if tot[f] != one[f]:
            raise ValueError(
                f"replicated bill changes read/observable field '{f}': "
                f"{tot[f]} != {one[f]} (reads bill to one replica)")
    wr_bytes, rem = divmod(tot["mn_bytes"] - one["mn_bytes"], r - 1)
    if rem or wr_bytes < 0 or wr_bytes > one["mn_bytes"]:
        raise ValueError(
            f"replicated byte bill inconsistent: mn_bytes {one['mn_bytes']} "
            f"-> {tot['mn_bytes']} is not ro + {r}*wr")
    secondary = {
        "reads": 0, "writes": one["writes"], "cas": one["cas"],
        "faa": one["faa"], "cn_msgs": 0, "mn_bytes": wr_bytes,
        "retries": one["retries"], "combined": 0, "executed": 0,
        "repair_cas": one["repair_cas"], "orphan_windows": 0,
    }
    primary = {k: v for k, v in one.items() if k != "mn_iops"}
    for f in ("cn_msgs", "combined", "executed", "orphan_windows"):
        primary[f] = tot[f]
    return [primary] + [dict(secondary) for _ in range(r - 1)]


@dataclasses.dataclass
class OpBatch:
    """A device batch of concurrent KV ops (one synchronization window).

    ``keys`` are slot indices into the pointer store; ``pos`` is the
    serialization priority (queue order == batch position); ``cn`` is the
    issuing compute node.  All (B,) int32 tensors on one device.
    """
    kinds: torch.Tensor
    keys: torch.Tensor
    values: torch.Tensor
    pos: torch.Tensor
    cn: torch.Tensor

    @staticmethod
    def make(kinds, keys, values, n_cns: int = 1,
             lanes_per_cn: int | None = None,
             device: str | torch.device = "cuda") -> "OpBatch":
        kinds = as_i32(kinds, device)
        keys = as_i32(keys, device)
        values = as_i32(values, device)
        b = kinds.shape[0]
        pos = torch.arange(b, dtype=torch.int32, device=kinds.device)
        if lanes_per_cn is None:
            lanes_per_cn = max(b // max(n_cns, 1), 1)
        cn = torch.div(pos, lanes_per_cn, rounding_mode="floor") % max(n_cns, 1)
        return OpBatch(kinds=kinds, keys=keys, values=values, pos=pos, cn=cn)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration for the dataplane engine (same fields and
    defaults as the reference; ``kernel_backend`` names the port's seam)."""
    n_slots: int                      # pointer-array length
    heap_slots: int                   # out-of-place heap capacity (values)
    mode: SyncMode = SyncMode.CIDER
    local_wc: bool = True             # local write combining (§5.1)
    value_bytes: int = 8              # payload size (paper: 8B values)
    ptr_bytes: int = 8                # data pointer
    lock_bytes: int = 16              # lock entry
    index_read_iops: int = 1          # per-op index I/O
    index_read_bytes: int = 8
    n_replicas: int = 1               # SNAPSHOT client-centric replication
    initial_credit: int = 36          # CIDER contention-aware params (§4.3)
    hotness_threshold: int = 2
    aimd_factor: int = 2
    backoff_cap: int = 6              # SPIN truncated exponential backoff
    lease_poll_rounds: int = 16       # SPIN lease polls on an orphaned lock
    scan_max: int = 0                 # SCAN probe bound (0: no probe pass)
    # Which implementation runs the sorted-run sweeps (wc_combine,
    # scan_probe): "auto" = the CUDA kernel for CUDA tensors and the plain
    # PyTorch version for CPU tensors; "torch" = the plain version on any
    # device, which on a card serves only to compare the kernels with it.
    kernel_backend: str = "auto"

    def __post_init__(self):
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(f"unknown kernel backend {self.kernel_backend!r} "
                             f"(expected one of {KERNEL_BACKENDS})")
