"""MN replica promotion (port of ``repro.dist.store.promote_replica``).

Only the control-plane function that single-device replicated runs call
lives here; the slot-partitioned sharded store (``sharded_store_init``,
``run_windows_sharded``, ``failover_reown``, ...) is ROADMAP item A11.
"""
from __future__ import annotations

from repro_torch.core.engine import StoreState
from repro_torch.core.types import EngineConfig

__all__ = ["promote_replica"]


def promote_replica(cfg: EngineConfig, state: StoreState,
                    survivors: tuple[int, ...], dead_replicas: tuple[int, ...],
                    ) -> tuple[StoreState, dict]:
    """Promote a surviving replica MN after replica deaths (DESIGN.md §13).

    SNAPSHOT client-centric replication keeps every replica's logical store
    identical — each acked write hit all R replicas before completing, and
    window-granular execution means no write is mid-fan-out at a window
    boundary — so promotion moves **no data**: clients drop the dead
    replicas from their replica lists and re-point reads at the lowest
    surviving replica.  What failover must still do is re-run the §4.6
    orphaned-lock repair against the promoted replica: every lock the CN
    liveness plane has stranded (``StoreState.stranded``) is re-armed with
    one break CAS on each surviving replica's copy, and the whole lock
    plane is swept (one lock-entry READ per slot) to certify that no
    acquisition was mid-fan-out when the replica died.

    Control-plane only: the returned state is the input state, and the
    sweep's bill is returned as a ``recovery_io`` dict kept OUT of
    ``IOMetrics`` — so the post-failover data-plane bill equals a plain
    segmented run that swaps ``EngineConfig.n_replicas`` at the crash
    window.
    """
    dead = sorted(dead_replicas)
    if not survivors:
        raise ValueError("promote_replica: no surviving replica")
    if set(dead) & set(survivors):
        raise ValueError(f"replicas {sorted(set(dead) & set(survivors))} "
                         f"listed both dead and surviving")
    stranded = int(state.stranded.sum().item())
    recovery_io = {
        "dead_replicas": dead,
        "survivors": sorted(survivors),
        "promoted": min(survivors),
        # one lock-entry READ per slot on the promoted replica (the
        # mid-fan-out certification sweep) ...
        "promote_reads": cfg.n_slots,
        "promote_bytes": cfg.n_slots * cfg.lock_bytes,
        # ... plus one break CAS re-arming each CN-stranded lock on every
        # surviving replica's copy of the word
        "repair_rearm_cas": stranded * len(survivors),
    }
    return state, recovery_io
