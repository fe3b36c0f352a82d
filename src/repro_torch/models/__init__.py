"""Every model family in PyTorch (port of ``repro.models``).

* ``config``      — ``ModelConfig`` (a copy of the reference dataclass);
* ``common``      — RMSNorm, RoPE, seeded initialisers and
  ``associative_scan``;
* ``mlp``         — SwiGLU;
* ``attention``   — ``gqa_attention`` (prefill) and ``decode_attention``
  (one token over the cache), on the ``flash_attention`` and
  ``paged_attention`` CUDA kernels for CUDA tensors;
* ``moe``         — top-k routing, the sort-and-rank dispatch (the
  ``wc_combine`` kernel on a card) and the grouped expert matmuls;
* ``ssm``         — Mamba-2 SSD: chunked prefill, O(1) decode;
* ``rglru``       — the RG-LRU recurrence and the causal conv;
* ``frontend``    — the audio and vision frontend stubs;
* ``transformer`` — parameters, forward, decode state and decode step of
  the dense, moe, ssm, hybrid, encoder and vlm families;
* ``model``       — the ``Model`` API the serve entry point calls.
"""
