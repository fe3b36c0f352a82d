"""The distribution layer of the port (``repro.dist``): so far only the
control-plane half of the sharded store that a single device needs,
``store.promote_replica`` (MN replica failover).  The slot-partitioned
store on ``torch.distributed`` is ROADMAP item A11."""
