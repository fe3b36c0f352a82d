"""Launcher of the ``paged_attention`` CUDA kernel
(``csrc/paged_attention.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/paged_attention/paged_attention.py``
(``paged_attention``, ``pallas_call`` at :74) and the dense decode path of
``repro.models.attention.decode_attention`` (a dense cache is a pool of
one page per sequence under the identity block table).  Bound on an H100
SXM: the K and V rows of the valid positions over 3.35 TB/s (up to
1.07 GB, 0.32 ms, at decode_32k: B 8, KH 8, D 128, bf16, lengths up to
32,768).  Design: one block per (kv head, sequence) serves that kv head's
g query heads, walking the sequence in 64-position tiles through the block
table (any page size; a page may end inside a tile; entries past
ceil(length / page) are never read), with an online softmax in f32.

``paged_attention_cuda`` launches the kernel on CUDA tensors and raises on
any other; ``repro_torch.models.attention.decode_attention`` sends CPU
tensors to the dense plain version instead.  A sequence of length <= 0
averages every row of its pages, as the reference does.
``counter.count`` grows by one per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention_cuda", "paged_attention_ref", "counter",
           "HEAD_DIMS"]

counter = build.LaunchCounter("paged_attention")
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"paged_attention_launch": (
    ctypes.c_int,
    [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 11
    + [ctypes.c_float, _P])}


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k/v_pages: (NPOOL, page, KH, D), any strides with a
    contiguous D axis and rows on 16-byte boundaries; block_table: (B, NP) int32 page ids; lengths: (B,)
    int32.  Returns (B, H, D) in q's dtype."""
    build.require_cuda_views(
        "paged_attention",
        {"q": q, "k_pages": k_pages, "v_pages": v_pages,
         "block_table": block_table, "lengths": lengths},
        dtypes={"q": tuple(_DTYPES), "k_pages": (q.dtype,),
                "v_pages": (q.dtype,), "block_table": (torch.int32,),
                "lengths": (torch.int32,)},
        ndims={"q": 3, "k_pages": 4, "v_pages": 4, "block_table": 2,
               "lengths": 1},
        rows16=("q", "k_pages", "v_pages"))
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    np_ = block_table.shape[1]
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"paged_attention: page pools {tuple(k_pages.shape)}"
                         f", {tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"paged_attention: {h} query heads are not a "
                         f"multiple of {kh} kv heads")
    if block_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_attention: block_table/lengths batch "
                         "mismatch")
    if page < 1 or np_ < 1 or np_ * page >= 2**31 - 64:
        raise ValueError(f"paged_attention: page {page} x {np_} pages")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {d} not in {HEAD_DIMS}")
    if kh > 65535 or b > 65535:
        raise ValueError(f"paged_attention: grid too large for {q.shape}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    dev = q.device
    lib = build.library("paged_attention", _SIGNATURES)
    err = lib.paged_attention_launch(
        dev.index, _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, kh, page, np_, d,
        q.stride(0), q.stride(1),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        block_table.stride(0), out.stride(0), out.stride(1),
        d ** -0.5, build.stream_of(q))
    build.check(lib, err, "paged_attention")
    counter.count += 1
    return out
