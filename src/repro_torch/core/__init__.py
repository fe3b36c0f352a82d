"""The CIDER synchronization engine, ported to PyTorch.

* ``engine``  — batched dataplane (4 sync modes, exact verb metering)
* ``runner``  — multi-window execution and the modeled metrics
* ``combine`` — global write-combining primitives (sort / segment / rank)
* ``credits`` — contention-aware AIMD credit tables (Algorithm 1)
* ``simnet``  — the testbed cost model constants (``SimParams``)
* ``oracle``  — sequential reference semantics
"""
from repro_torch.core.types import EngineConfig, IOMetrics, OpBatch, OpKind, SyncMode

__all__ = ["EngineConfig", "IOMetrics", "OpBatch", "OpKind", "SyncMode"]
