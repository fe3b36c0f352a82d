"""Launcher of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py`` (``flash_attention``,
``pallas_call`` at :82) and the chunked jnp path of
``repro.models.attention.gqa_attention`` that it stands for.  Bound on an
H100 SXM: 4 * B * H * D * (unmasked query-key pairs) operations over 989
TFLOP/s in bf16 (67 TFLOP/s in f32), or the bytes of q, k, v and out over
3.35 TB/s, whichever is larger; at the prefill shape (B 2, S 4096, H 16,
KH 8, D 128, causal) about 137 GFLOP, 0.14 ms.  Design in bf16 at D 32,
64 and 128: one block per (128-query tile, head, batch), longest tiles
first; a producer warp streams the Q tile and a ring of 64-key K/V tiles
into shared memory with TMA (tensor maps encoded in the C launcher,
128-byte swizzle); two consumer warpgroups run S = Q K^T and O += P V as
``wgmma`` on the tensor cores, the online softmax in registers, with P
split into bf16 hi + lo so that the output stays within two bf16 ulps of
the f32 reference.  In f32 at every D, and in bf16 at D 80, 96 and 256
(which the 64-column tensor-core boxes do not take): one block per
(64-query tile, head, batch), inputs converted to f32 as they are staged,
products as f32 FMAs on the CUDA cores, one rounding at the store.  Both
skip key tiles their masks cover wholly; any S (rows past S read as zeros
and are masked), any strides with a contiguous, 16-byte aligned D axis, D
in ``HEAD_DIMS``.

``flash_attention_cuda`` launches the kernel on CUDA tensors and raises on
any other; ``repro_torch.models.attention.gqa_attention`` sends CPU tensors
to its plain chunked version instead.  ``counter`` counts one per launch,
tallied by head dim.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref", "counter",
           "HEAD_DIMS"]

counter = build.LaunchCounter("flash_attention")
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_launch": (
    ctypes.c_int,
    [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 12
    + [_I, _I, ctypes.c_float, _P])}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, KH, S, D), any strides with a contiguous
    D axis and rows on 16-byte boundaries.  Returns (B, H, S, D) in q's dtype, laid out like q when q is
    dense (a transposed view of a (B, S, H, D) tensor stays one)."""
    build.require_cuda_views(
        "flash_attention", {"q": q, "k": k, "v": v},
        dtypes={"q": tuple(_DTYPES), "k": (q.dtype,), "v": (q.dtype,)},
        ndims={"q": 4, "k": 4, "v": 4}, rows16=("q", "k", "v"))
    b, h, s, d = q.shape
    kh = k.shape[1]
    if k.shape != v.shape or k.shape != (b, kh, s, d):
        raise ValueError(f"flash_attention: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if h > 65535 or b > 65535 or s >= 2**31 - 128 \
            or -(-s // 128) * h * b >= 2**31:
        raise ValueError(f"flash_attention: grid too large for {q.shape}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    dev = q.device
    lib = build.library("flash_attention", _SIGNATURES)
    err = lib.flash_attention_launch(
        dev.index, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, kh, s, d,
        q.stride(0), q.stride(2), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        out.stride(0), out.stride(2), out.stride(1),
        int(bool(causal)), int(window), d ** -0.5, build.stream_of(q))
    build.check(lib, err, "flash_attention")
    counter.add(d)
    return out
