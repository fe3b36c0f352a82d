"""Stores on the (simulated) memory pool: index structures resolving keys to
engine slots and metering their own index I/O.

* ``pointer_array`` — the paper's micro-benchmark object store (§5.2); point
  ops only, SCAN is rejected with ``UnsupportedOpError``;
* ``race_hash`` — RACE-style two-choice hash index (ATC'21): keys resolve to
  slots via two candidate buckets read per lookup; SCAN is rejected;
* ``smart_art`` — SMART-style radix tree whose leaf entries sit in key order,
  so a key range is a contiguous slot run and SCAN is served;
* ``heap`` — offline compaction of the out-of-place value heap.
"""
from repro_torch.stores.pointer_array import PointerArray
from repro_torch.stores.race_hash import RaceHash
from repro_torch.stores.smart_art import SmartART

__all__ = ["PointerArray", "RaceHash", "SmartART"]
