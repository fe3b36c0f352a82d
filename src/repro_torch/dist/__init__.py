"""The distribution layer of the port (``repro.dist``): the sharded CIDER
dataplane, ``store`` — ``StoreState`` partitioned over the shards of a mesh
(``repro_torch.launch.mesh``), ``engine.apply_batch`` run per shard with
ops routed to their owning shard, and MN replica promotion."""
from repro_torch.dist.store import (apply_batch_sharded, failover_reown,
                                    promote_replica, run_windows_sharded,
                                    run_windows_sharded_traced, shard_extents,
                                    sharded_populate, sharded_store_init,
                                    sharded_store_view)

__all__ = ["shard_extents", "sharded_store_init", "sharded_populate",
           "sharded_store_view", "apply_batch_sharded", "run_windows_sharded",
           "run_windows_sharded_traced", "failover_reown", "promote_replica"]
