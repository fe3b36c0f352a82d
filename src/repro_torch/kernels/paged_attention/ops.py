"""Launcher of the ``paged_attention`` CUDA kernel
(``csrc/paged_attention.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/paged_attention/paged_attention.py``
(``paged_attention``, ``pallas_call`` at :74) and the dense decode path of
``repro.models.attention.decode_attention`` (a dense cache is a pool of
one page per sequence under the identity block table).  Bound on an H100
SXM: the K and V rows of the valid positions over 3.35 TB/s (up to
1.07 GB, 0.32 ms, at decode_32k: B 8, KH 8, D 128, bf16, lengths up to
32,768).  Design (flash decoding): the sequence is split across blocks,
one per (kv head, group of its query heads, sequence, split of ``split``
positions); a block double-buffers 32-position tiles of K/V rows with
``cp.async`` through the block table (any page size; a page may end
inside a tile; entries past ceil(length / page) are never read) and runs
an online softmax in f32 for its group's heads.  The plan comes from
shapes, never from ``lengths`` (which stay on the device):
``split_plan`` sizes the split from the block table's span -- with one
split (any span up to ``SPLIT``, the serve's 40-row slots) the blocks
write the output in one launch; with more, they write f32 partials to
scratch and a second launch merges them by their log-sum-exp weights --
and ``head_group_plan`` splits a kv head's g query heads over
``n_hgroups`` blocks while the grid would have fewer blocks than the card
has streaming multiprocessors (``fill_blocks``: 132 on an H100 SXM): one
group, so each K/V row is read once, wherever the grid fills the card
(decode_32k: 4,096 blocks), and up to g groups of one head at
recurrentgemma's MQA (KH 1, g 16: at B 1 the 40-row slot would be one
block).  The kernel is compiled at the widths ``INSTANCES``, and every D
>= 1 runs by its plan (``plan_of``): up to 256 on the smallest width at or
above it (D 80 on 96, recurrentgemma-9b's smoke D 16 on 32), past 256 on
256.  Where D is a compiled width and the pools' rows are whole 16-byte
chunks on 16-byte boundaries (every published head dim), that is the
split kernel above, D a compile-time constant; any other D or row runs a
column-pass kernel of the same design with D at run time: a block loads,
reads and stores only the D columns of its tiles, which are laid out at
the instance's width; a row's score is summed over chunks of W columns,
each streamed as a stage of its own; past 256 the grid has ceil(D / 256)
column passes, each block accumulating 256 of the output's columns; and a
pool whose rows are not whole 16-byte chunks, or lie off 16-byte
boundaries, is loaded element by element into tiles zero-filled to whole
chunks.  The pools, which hold the KV cache, are never copied; q is read
element by element in every design.

``paged_attention_cuda`` launches the kernel on CUDA tensors and raises on
any other; ``repro_torch.models.attention.decode_attention`` sends CPU
tensors to the dense plain version instead.  A sequence of length <= 0
averages every row of its pages, as the reference does.  ``return_lse``
makes each sequence a part of a split sequence, as
``repro_torch.dist.decode_attn`` launches it (serving never does): the same
launches also write each head's log-sum-exp of its scaled, masked scores
(f32, natural log), the weight by which the parts are merged; the output
comes in f32, unrounded, so that the merge rounds once; and a length <= 0
(a part past its sequence's length, whose weight is 0) reads nothing:
output 0, lse -inf.
``counter`` counts one per call that launches the kernel, tallied by head
dim, ``counter_plan`` the same launches tallied by the grid the C
launcher reports it ran (a ``Plan``), ``counter_instance`` by their plan
(``build.HeadDimPlan``: head dim, the instance and column passes the
launcher reports, never padded), and ``counter_narrow`` the launches
that loaded rows element by element.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention_cuda", "paged_attention_ref", "counter",
           "counter_plan", "counter_instance", "counter_narrow", "split_plan",
           "head_group_plan", "groups_to_fill", "fill_blocks", "plan_of",
           "instance_of", "Plan", "INSTANCES", "SPLIT", "TILE"]

counter = build.LaunchCounter("paged_attention")
counter_plan = build.LaunchCounter("paged_attention_plan")
counter_instance = build.LaunchCounter("paged_attention_instance")
counter_narrow = build.LaunchCounter("paged_attention_narrow")
INSTANCES = (32, 64, 96, 112, 128, 256)     # the compiled widths
TILE = 32           # positions per tile of the kernel
SPLIT = 512         # positions per block, unless the span needs more
_MAX_SPLITS = 65535  # the grid's z extent
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"paged_attention_launch": (
    ctypes.c_int,
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 10 + [_L] * 11
    + [ctypes.c_float, ctypes.POINTER(ctypes.c_int * 3),
       ctypes.POINTER(ctypes.c_int * 3), _P])}


def plan_of(d: int, dtype: torch.dtype) -> build.HeadDimPlan:
    """The plan (``build.head_dim_plan``) on which the kernel runs head dim
    ``d`` in ``dtype``, whatever the pools' strides: never padded, the
    kernel loading a row that is not whole 16-byte chunks, or lies off
    16-byte boundaries, itself.  Every ``d >= 1`` has one."""
    return build.head_dim_plan("paged_attention", d, dtype, INSTANCES, False)


def instance_of(d: int, dtype: torch.dtype) -> int:
    """The instance (of ``INSTANCES``) on which the kernel runs head dim
    ``d`` in ``dtype`` (``plan_of``'s width)."""
    return plan_of(d, dtype).w


class Plan(NamedTuple):
    """The grid of one launch, as the C launcher reports it:
    ``head_groups`` blocks per kv head (and column pass), ``splits`` per
    sequence, ``blocks`` in all, column passes included (of the split
    launch; the merge adds H x B when ``splits > 1``)."""
    head_groups: int
    splits: int
    blocks: int


def split_plan(span: int) -> tuple[int, int]:
    """``(split, n_split)`` for a block table that spans ``span`` rows:
    ``split`` positions per block (``SPLIT``, or more, in whole tiles, when
    the span would need more than 65,535 blocks), ``n_split`` blocks per
    (kv head, sequence).  The merge launches only when ``n_split > 1``."""
    split = max(SPLIT, -(-span // _MAX_SPLITS))
    split = -(-split // TILE) * TILE
    return split, -(-span // split)


def groups_to_fill(blocks: int, g: int, fill: int) -> int:
    """The fewest groups (a divisor of ``g``) over which to split each
    block of a grid of ``blocks`` so that it has ``fill`` blocks, or ``g``
    when none does."""
    n = 1
    while n < g and blocks * n < fill:
        n = next(d for d in range(n + 1, g + 1) if g % d == 0)
    return n


def head_group_plan(b: int, kh: int, g: int, span: int, fill: int) -> int:
    """``n_hgroups``, the blocks over which each kv head's ``g`` query
    heads are split, for ``b`` sequences of ``kh`` kv heads over a block
    table that spans ``span`` rows: the fewest groups (a divisor of ``g``)
    that give the grid ``fill`` blocks (``fill_blocks``), or ``g`` groups
    of one head when none does (``groups_to_fill``).  One group reads each
    K/V row once; more read it once a group (from L2 after the first) but
    put more SMs on a small grid."""
    return groups_to_fill(b * kh * split_plan(span)[1], g, fill)


@functools.cache
def fill_blocks(device: torch.device) -> int:
    """The grid that fills the card: one block a streaming multiprocessor
    (132 on an H100 SXM, 114 on an H100 PCIe)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, *, return_lse: bool = False):
    """q: (B, H, D); k/v_pages: (NPOOL, page, KH, D), any strides with a
    contiguous D axis; block_table: (B, NP)
    int32 page ids; lengths: (B,) int32.  Returns (B, H, D) in q's dtype;
    a length <= 0 averages every row of the sequence's pages (the
    reference's).  With ``return_lse``: ``(out, lse)``, out (B, H, D) in
    f32 and lse (B, H) f32, and a length <= 0 reads nothing (out 0, lse
    -inf)."""
    return _launch(q, k_pages, v_pages, block_table, lengths, return_lse,
                   None)


def _launch(q, k_pages, v_pages, block_table, lengths, return_lse,
            n_hgroups):
    """``paged_attention_cuda`` with ``n_hgroups`` head groups (a divisor
    of H / KH), or ``head_group_plan``'s when None."""
    build.require_cuda_views(
        "paged_attention",
        {"q": q, "k_pages": k_pages, "v_pages": v_pages,
         "block_table": block_table, "lengths": lengths},
        dtypes={"q": tuple(_DTYPES), "k_pages": (q.dtype,),
                "v_pages": (q.dtype,), "block_table": (torch.int32,),
                "lengths": (torch.int32,)},
        ndims={"q": 3, "k_pages": 4, "v_pages": 4, "block_table": 2,
               "lengths": 1})
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
    plan = plan_of(d, q.dtype)
    if kh > 65535 or b > 65535:
        raise ValueError(f"paged_attention: grid too large for {q.shape}")
    split, n_split = split_plan(np_ * page)
    if n_hgroups is None:
        n_hgroups = head_group_plan(b, kh, h // kh, np_ * page,
                                    fill_blocks(q.device))
    elif n_hgroups < 1 or (h // kh) % n_hgroups:
        raise ValueError(f"paged_attention: {n_hgroups} head groups do not "
                         f"divide {h // kh} query heads a kv head")
    out = torch.empty((b, h, d), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    part = None
    if n_split > 1:     # (B, KH, n_split, g, D + 2): acc, m, l per split
        part = torch.empty((b, kh, n_split, h // kh, d + 2),
                           dtype=torch.float32, device=q.device)
    dev = q.device
    lib = build.library("paged_attention", _SIGNATURES)
    grid, ran = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    err = lib.paged_attention_launch(
        dev.index, _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, kh, n_hgroups, page,
        np_, d, plan.w, split, n_split, q.stride(0), q.stride(1),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        block_table.stride(0), out.stride(0), out.stride(1),
        d ** -0.5, ctypes.byref(grid), ctypes.byref(ran),
        build.stream_of(q))
    build.check(lib, err, "paged_attention")
    counter.add(d)
    counter_instance.add(build.HeadDimPlan(d, ran[0], ran[1], False))
    if ran[2]:
        counter_narrow.add(d)
    counter_plan.add(Plan(grid[0] // (kh * ran[1]), grid[2],
                          grid[0] * grid[1] * grid[2]))
    return (out, lse) if return_lse else out
