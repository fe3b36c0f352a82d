"""The dense model family in PyTorch (port of ``repro.models``).

* ``config``      — ``ModelConfig`` (a copy of the reference dataclass);
* ``common``      — RMSNorm, RoPE and seeded initialisers;
* ``mlp``         — SwiGLU;
* ``attention``   — ``gqa_attention`` (prefill) and ``decode_attention``
  (one token over the cache), on the ``flash_attention`` and
  ``paged_attention`` CUDA kernels for CUDA tensors;
* ``transformer`` — parameters, forward, decode state and decode step;
* ``model``       — the ``Model`` API the serve entry point calls.
"""
