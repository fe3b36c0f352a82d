"""PyTorch/CUDA port of the CIDER dataplane engine.

Mirrors the layout of the JAX package ``repro`` module for module, so each
ported module's reference sits at the same relative path:

* ``core``      — op vocabulary, combine/credit primitives, the engine and
  the window runner (``repro.core``);
* ``kernels``   — hand-written CUDA kernels for Hopper replacing the Pallas
  TPU kernels (``wc_combine``, ``scan_probe``, ``paged_attention``,
  ``flash_attention``), each with its plain PyTorch version and a launch
  counter;
* ``models``    — every model family's forward and decode step
  (``repro.models``), served by ``launch.serve``;
* ``stores``    — the pointer-array and radix (SMART) stores;
* ``workloads`` — the numpy YCSB generators (identical arrays from
  identical seeds);
* ``interop``   — carries reference state (numpy arrays) into the port and
  back.

Entry points default to ``device="cuda"`` and raise when CUDA is absent;
pass ``device="cpu"`` explicitly to run the plain PyTorch versions.
"""

import os as _os


def _cap_threads_per_xdist_worker() -> None:
    """Under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` set), give each
    worker's torch an equal share of the machine's cores, at least one: n
    workers each at torch's default of one thread a core oversubscribe the
    machine n times, and a test of many small tensor ops then runs hundreds
    of times slower than alone.  Elsewhere it does nothing."""
    n = _os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not n:
        return
    import torch
    torch.set_num_threads(max(1, (_os.cpu_count() or 1) // max(int(n), 1)))


_cap_threads_per_xdist_worker()
