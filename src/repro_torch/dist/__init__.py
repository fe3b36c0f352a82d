"""The distribution layer of the port (``repro.dist``):

* ``store`` — the sharded CIDER dataplane: ``StoreState`` partitioned over
  the shards of a mesh (``repro_torch.launch.mesh``), ``engine.apply_batch``
  run per shard with ops routed to their owning shard, MN replica
  promotion;
* ``sharding`` — the logical-axis rules, each leaf's spec and per-device
  shape, DTensor placements; ``ctx`` — the ambient mesh;
* ``decode_attn`` — decode attention over a sequence-split KV cache;
* ``embed_grad`` — write-combined sparse embedding gradients;
* ``compress`` — int8 gradient compression with error feedback."""
from repro_torch.dist.store import (apply_batch_sharded, failover_reown,
                                    promote_replica, run_windows_sharded,
                                    run_windows_sharded_traced, shard_extents,
                                    sharded_populate, sharded_store_init,
                                    sharded_store_view)

__all__ = ["shard_extents", "sharded_store_init", "sharded_populate",
           "sharded_store_view", "apply_batch_sharded", "run_windows_sharded",
           "run_windows_sharded_traced", "failover_reown", "promote_replica"]
