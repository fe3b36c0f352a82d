"""Hand-written CUDA kernels (Hopper, ``sm_90a``) for the engine path.

Each kernel replaces one Pallas TPU kernel of ``repro.kernels`` and ships as
``<name>/ops.py`` (launcher, launch counter and source note) and
``<name>/ref.py`` (its plain PyTorch version); the CUDA sources live in
``csrc/`` and ``build.py`` compiles them with ``nvcc`` at first use.

* ``wc_combine`` — run boundaries and in-run rank over a sorted key array
  (the materialized §4.2 wait queues), on every window;
* ``scan_probe`` — the fused SCAN reader-probe sweep (existence before each
  lane + writers ahead of it in its run), engine step 5c.

The engine's two seams, ``combine._first_last_rank`` and
``engine._probe_sweep``, run the plain version only for CPU tensors; for a
CUDA tensor they call the launcher (``*_cuda``), which runs the kernel or
raises.
"""
