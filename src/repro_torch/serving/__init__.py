"""Serving: the CIDER-managed prefix-cache page table and the
continuous-batching scheduler (port of ``repro.serving``)."""
