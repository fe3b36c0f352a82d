"""PyTorch/CUDA port of the CIDER dataplane engine.

Mirrors the layout of the JAX package ``repro`` module for module, so each
ported module's reference sits at the same relative path:

* ``core``      — op vocabulary, combine/credit primitives, the engine and
  the window runner (``repro.core``);
* ``kernels``   — hand-written CUDA kernels for Hopper replacing the Pallas
  TPU kernels on the engine path (``wc_combine``, ``scan_probe``), each with
  its plain PyTorch version and a launch counter;
* ``stores``    — the pointer-array and radix (SMART) stores;
* ``workloads`` — the numpy YCSB generators (identical arrays from
  identical seeds);
* ``interop``   — carries reference state (numpy arrays) into the port and
  back.

Entry points default to ``device="cuda"`` and raise when CUDA is absent;
pass ``device="cpu"`` explicitly to run the plain PyTorch versions.
"""
