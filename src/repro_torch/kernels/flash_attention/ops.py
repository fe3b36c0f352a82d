"""Launcher of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py`` (``flash_attention``,
``pallas_call`` at :82) and the chunked jnp path of
``repro.models.attention.gqa_attention`` that it stands for.  Bound on an
H100 SXM: 4 * B * H * D * (unmasked query-key pairs) operations over 989
TFLOP/s in bf16 (67 TFLOP/s in f32), or the bytes of q, k, v and out over
3.35 TB/s, whichever is larger; at the prefill shape (B 2, S 4096, H 16,
KH 8, D 128, causal) about 137 GFLOP, 0.14 ms.  Design in bf16, at every
D (``FWD_TENSOR_CORE_DIMS``): one block per (128-query tile, head, batch),
longest tiles first; a producer streams the Q tile and a ring of 64-key
K/V tiles into shared memory with TMA (tensor maps encoded in the C
launcher, 128-byte swizzle; at D 80 and 96 a row is a 64-column box and a
tail box of 16 or 32 columns with its own map and swizzle, at D 112 two
64-column boxes whose last 16 columns TMA fills with zeros, and every
product runs at the true width); two consumer warpgroups run S = Q K^T
and O += P V as ``wgmma`` on the tensor cores, the online softmax in
registers, with P split into bf16 hi + lo so that the output stays within
two bf16 ulps of the f32 reference.  Up to D 128 the producer is one warp
and the ring three stages; at D 256 (64 KB a Q tile, 64 KB a K+V stage, a
128-register output fragment a consumer thread) the ring has two stages
and the producer is a warpgroup that hands its registers to the consumers
(``setmaxnreg``: 240 a consumer thread).  In f32, at every D: one block
per (64-query tile, head, batch), products as f32 FMAs on the CUDA cores.
Both skip key tiles their masks cover wholly; any S (rows
past S read as zeros and are masked), any strides with a contiguous D
axis.  Both directions are compiled at the widths ``INSTANCES``, and
every head dim D >= 1 runs by its plan (``plan_of``, a
``build.HeadDimPlan``): up to 256 on the smallest instance at or above
it, the kernels taking D at run time, loading columns D and beyond as
zeros (TMA's fill past the tensor maps' D columns, or the f32 loads),
running every product at the instance's width over them, and storing
none of them; past 256 on a CUDA-core kernel in both dtypes
(``flash_fwd_cols``, ``flash_bwd_*_cols``) whose blocks each own 256 of
the output's columns (ceil(D / 256) column passes) and compute the
scores over the whole row in chunks of 256 columns.  Where a row is not
whole 16-byte chunks (D not a multiple of 8 in bf16, of 4 in f32) or a
view's rows are off 16-byte boundaries (base pointer or a stride), which
TMA's tensor maps and the 16-byte loads cannot describe, the wrapper runs
the kernels on dense copies at ``build.padded_width`` (zero columns past
D; a view that fits is passed as it is) and copies the outputs' D
columns out: glue, not attention arithmetic, since zero columns add exact
zeros and the scale stays D^-1/2.  Every published head dim is an
instance of its own, unpadded, in one pass; recurrentgemma-9b's smoke D
16 runs on 32, D 48 on 64, D 200 on 256, D 20 in bf16 on copies 24 wide
on 32, D 320 in two passes.

``flash_attention_cuda`` launches the kernel on CUDA tensors and raises on
any other; ``repro_torch.models.attention.gqa_attention`` sends CPU tensors
to its plain chunked version instead.  ``counter`` counts one per launch,
tallied by head dim, ``counter_tc`` the launches the C launcher reports
it ran on the tensor-core kernel, ``counter_cols`` those on the
column-pass kernel, and ``counter_instance`` the launches by their plan
(head dim, the instance and passes the launcher reports it dispatched
on, padded); a failed build or launch raises, with no other design to
fall back to.  With ``return_lse``
(training) the forward also writes the backward's residuals: each row's
log-sum-exp of its scaled scores (f32, natural log) and, in bf16, the
output in f32 before its rounding (in f32 it is the output itself), from
which the backward takes delta, as the reference takes delta from its f32
forward output.

``flash_attention_bwd_cuda`` launches the backward kernels
(``csrc/flash_attention_bwd.cu``), which replace the jnp FlashAttention
backward ``_flash_vjp_bwd`` of ``src/repro/models/attention.py`` (:95, the
``custom_vjp`` backward of ``_flash``; not a Pallas kernel).  Bound on an
H100 SXM: five products of 2 * B * H * D * (unmasked pairs) operations, at
the training shape (B 2, S 4096, H 16, KH 8, D 128, causal) about 344
GFLOP: 0.35 ms in bf16 on the tensor cores, 5.1 ms in f32 on the CUDA
cores.  Three launches, no atomics, so the result is the same bits every
run: ``delta = rowsum(dO * O)``; a dK/dV pass, one block per (key tile, kv
head, batch) looping over the query tiles its masks leave and the query
heads of its group; a dQ pass, one block per (query tile, head, batch).
Both recompute P from ``lse``, so S and dP are computed twice (7 products
for 5).  In bf16, at every D (``BWD_TENSOR_CORE_DIMS``), both passes have
the forward's design: a TMA producer streams 64-row tiles past the
block's own rows, and two consumer warpgroups run every product as
``wgmma`` -- S^T = K Q^T and dP^T = V dO^T with both operands in shared
memory, dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers
(and S = Q K^T, dP = dO V^T, dQ += dS K in the dQ pass) -- with P and dS
split into bf16 hi + lo, as one bf16 P or dS misses the backward's
tolerance.  Up to D 128 a block owns 128 rows, 64 a warpgroup (at D 80
and 96 a row is the forward's 64-column box and 16- or 32-column tail
box, at D 112 its two boxes, every product at the true width).  At D 256 a block owns 64 rows and
its two warpgroups split each tile pair's products (one makes P, the
other dP and dS, handed over through shared memory; each accumulates dV
or dK, or half of dQ's columns); where that dK/dV grid would leave SMs
idle, a kv head's query heads are split over ``bwd_head_groups`` groups,
each writing f32 partial dK and dV to a scratch that a fourth launch sums
in group order and rounds once.  In f32, at every D: the same three
launches with f32 FMAs on the CUDA cores.  The dispatch is fixed by dtype
and D in the C launcher, which reports the design and the dK/dV plan it
launched; a failure raises.  Past 256, in both dtypes: the same three
launches on the CUDA cores, each block of the dK/dV and dQ passes owning
256 columns of its rows' gradients and recomputing S and dP over the
whole row in chunks of 256 columns; still no atomics.  ``counter_bwd``
counts one per backward (three or four kernel launches), tallied by head
dim, ``counter_bwd_tc`` the backwards the launcher ran on the tensor-core
kernels, ``counter_bwd_cols`` those on the column-pass kernels,
``counter_bwd_plan`` the backwards by the dK/dV grid it reported (a
``BwdPlan``), and ``counter_bwd_instance`` the backwards by their plan
(a ``build.HeadDimPlan``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                    flash_attention_ref)
from repro_torch.kernels.paged_attention.ops import (fill_blocks,
                                                    groups_to_fill)

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "flash_attention_ref", "flash_attention_bwd_ref", "counter",
           "counter_tc", "counter_cols", "counter_instance", "counter_bwd",
           "counter_bwd_tc", "counter_bwd_cols", "counter_bwd_plan",
           "counter_bwd_instance", "bwd_head_groups", "BwdPlan", "plan_of",
           "instance_of", "INSTANCES", "FWD_TENSOR_CORE_DIMS",
           "BWD_TENSOR_CORE_DIMS", "BWD_GROUPED_DIMS"]

counter = build.LaunchCounter("flash_attention")
counter_tc = build.LaunchCounter("flash_attention_tc")
counter_cols = build.LaunchCounter("flash_attention_cols")
counter_instance = build.LaunchCounter("flash_attention_instance")
counter_bwd = build.LaunchCounter("flash_attention_bwd")
counter_bwd_tc = build.LaunchCounter("flash_attention_bwd_tc")
counter_bwd_cols = build.LaunchCounter("flash_attention_bwd_cols")
counter_bwd_plan = build.LaunchCounter("flash_attention_bwd_plan")
counter_bwd_instance = build.LaunchCounter("flash_attention_bwd_instance")
# the widths both directions are compiled at (the C launchers' instances)
INSTANCES = (32, 64, 80, 96, 112, 128, 256)
# the instances at which bf16 runs the tensor-core (wgmma) kernels, by
# direction (``kTensorCoresFwd`` and ``kTensorCoresBwd`` of
# csrc/attention_common.cuh): every one; f32 runs the CUDA-core kernels
FWD_TENSOR_CORE_DIMS = (32, 64, 80, 96, 112, 128, 256)
BWD_TENSOR_CORE_DIMS = (32, 64, 80, 96, 112, 128, 256)
# the instances whose bf16 dK/dV pass (64-key blocks, ``Geom<D>::SPLIT``)
# may split a kv head's query heads over groups; the others run one group
BWD_GROUPED_DIMS = (256,)
_BWD_KEY_ROWS = 64      # keys a dK/dV block owns at BWD_GROUPED_DIMS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COLS = 2   # the launchers' design code of the column-pass kernels

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_INT_OUT = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {"flash_attention_launch": (
    ctypes.c_int,
    [_I, _I, _P, _P, _P, _P] + [_I] * 6 + [_L] * 12
    + [_I, _I, ctypes.c_float, _P, _P, _INT_OUT, _INT_OUT, _INT_OUT, _P])}
_BWD_SIGNATURES = {"flash_attention_bwd_launch": (
    ctypes.c_int,
    [_I, _I] + [_P] * 11 + [_I] * 7 + [_L] * 24
    + [_I, _I, ctypes.c_float, _INT_OUT, ctypes.POINTER(ctypes.c_int * 2),
       _INT_OUT, _INT_OUT, _P])}


def plan_of(d: int, dtype: torch.dtype, *views: torch.Tensor
            ) -> build.HeadDimPlan:
    """The plan (``build.head_dim_plan``) on which both directions run head
    dim ``d`` in ``dtype`` with the inputs ``views`` (dense ones when none
    are given): padded where a row of ``d`` elements is not whole 16-byte
    chunks or a view's rows are off 16-byte boundaries (``build.rows16``).
    Every ``d >= 1`` has one."""
    padded = (d * dtype.itemsize % 16 != 0
              or not all(build.rows16(t) for t in views))
    return build.head_dim_plan("flash_attention", d, dtype, INSTANCES, padded)


def instance_of(d: int, dtype: torch.dtype) -> int:
    """The instance (of ``INSTANCES``) on which both directions run head
    dim ``d`` in ``dtype`` on dense inputs (``plan_of``'s width)."""
    return plan_of(d, dtype).w


def _fit(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` itself where its rows are ``width`` wide and whole 16-byte
    chunks on 16-byte boundaries, else a dense copy with zero columns up to
    ``width``."""
    if t.shape[-1] == width and build.rows16(t):
        return t
    out = t.new_zeros(t.shape[:-1] + (width,))
    out[..., :t.shape[-1]] = t
    return out


class BwdPlan(NamedTuple):
    """The dK/dV pass of one backward, as the C launcher reports it:
    ``head_groups`` blocks per (key tile, kv head, batch), each over its
    share of the kv head's query heads, and ``blocks`` in all; a fourth
    launch sums the groups when ``head_groups > 1``."""
    head_groups: int
    blocks: int


def bwd_head_groups(b: int, kh: int, g: int, s: int, fill: int) -> int:
    """The head groups of a grouped dK/dV pass (``BWD_GROUPED_DIMS``) of
    ``b`` sequences of ``s`` positions and ``kh`` kv heads of ``g`` query
    heads each: the fewest (a divisor of ``g``) that give the grid of
    64-key blocks ``fill`` blocks (``fill_blocks``), or ``g`` when none
    does (``paged_attention``'s ``head_group_plan`` rule).  One group reads
    each Q and dO tile once and rounds in the kernel; more read K and V
    once a group and sum f32 partials in a fourth launch, but put more SMs
    on a short grid."""
    return groups_to_fill(b * kh * -(-s // _BWD_KEY_ROWS), g, fill)


def _check_shapes(what: str, q, k, v, window: int) -> None:
    b, h, s, d = q.shape
    kh = k.shape[1]
    if k.shape != v.shape or k.shape != (b, kh, s, d):
        raise ValueError(f"{what}: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"{what}: {h} query heads are not a multiple of "
                         f"{kh} kv heads")
    if h > 65535 or b > 65535 or s >= 2**31 - 128 \
            or -(-s // 64) * h * b >= 2**31:
        raise ValueError(f"{what}: grid too large for {q.shape}")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")


def _strides(t: torch.Tensor):
    """(batch, position, head) element strides of a (B, heads, S, D) view."""
    return t.stride(0), t.stride(2), t.stride(1)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q: (B, H, S, D); k/v: (B, KH, S, D), any strides with a contiguous
    D axis.  Returns (B, H, S, D) in q's dtype, laid out like q when q is
    dense (a transposed view of a (B, S, H, D) tensor stays one).  With
    ``return_lse``: ``(out, lse, out32)``, lse the (B, H, S) f32
    log-sum-exp of each row's scaled, masked scores and out32 the output in
    f32 before its rounding, laid out as out (out itself in f32)."""
    build.require_cuda_views(
        "flash_attention", {"q": q, "k": k, "v": v},
        dtypes={"q": tuple(_DTYPES), "k": (q.dtype,), "v": (q.dtype,)},
        ndims={"q": 4, "k": 4, "v": 4})
    _check_shapes("flash_attention", q, k, v, window)
    b, h, s, d = q.shape
    kh = k.shape[1]
    plan = plan_of(d, q.dtype, q, k, v)
    width = build.padded_width(d, q.dtype) if plan.padded else d
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    out32 = None
    if return_lse:
        out32 = out if q.dtype == torch.float32 else \
            torch.empty_like(out, dtype=torch.float32)
        if out32.stride() != out.stride():
            raise ValueError("flash_attention: the f32 output's strides "
                             f"{out32.stride()} differ from the output's "
                             f"{out.stride()}")
    # the kernels' inputs and outputs: the padded copies' width
    kq, kk, kv = (_fit(x, width) for x in (q, k, v))
    kout = out if width == d else kq.new_empty(kq.shape)
    kout32 = out32 if width == d or out32 is None else (
        kout if q.dtype == torch.float32 else
        torch.empty_like(kout, dtype=torch.float32))
    lib = build.library("flash_attention", _SIGNATURES)
    design, ran, passes = ctypes.c_int(-1), ctypes.c_int(0), ctypes.c_int(0)
    err = lib.flash_attention_launch(
        q.device.index, _DTYPES[q.dtype], kq.data_ptr(), kk.data_ptr(),
        kv.data_ptr(), kout.data_ptr(), b, h, kh, s, width, plan.w,
        *_strides(kq), *_strides(kk), *_strides(kv), *_strides(kout),
        int(bool(causal)), int(window), d ** -0.5,
        None if lse is None else lse.data_ptr(),
        None if kout32 is None or kout32 is kout else kout32.data_ptr(),
        ctypes.byref(design), ctypes.byref(ran), ctypes.byref(passes),
        build.stream_of(q))
    build.check(lib, err, "flash_attention")
    counter.add(d)
    counter_instance.add(build.HeadDimPlan(d, ran.value, passes.value,
                                           plan.padded))
    if design.value == 1:
        counter_tc.add(d)
    elif design.value == _COLS:
        counter_cols.add(d)
    if width != d:
        out.copy_(kout[..., :d])
        if out32 is not None and out32 is not out:
            out32.copy_(kout32[..., :d])
    return (out, lse, out32) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention_cuda``'s output
    with respect to q, k and v, given its f32 output ``out`` before its
    rounding (the forward's ``out32``, from which delta is taken), the
    output's gradient ``dout`` (both (B, H, S, D); dout in q's dtype) and
    the forward's ``lse`` ((B, H, S) f32, contiguous).  Views as in the
    forward (padded copies where the plan pads: q, k, v, out and dout,
    each unless it fits).  dq is (B, H, S, D), dk and dv (B, KH, S, D),
    dense, in q's dtype: the scale D^-1/2 is in dq, and a kv head's dk and
    dv sum over its query heads."""
    build.require_cuda_views(
        "flash_attention_bwd",
        {"q": q, "k": k, "v": v, "out": out, "dout": dout, "lse": lse},
        dtypes={"q": tuple(_DTYPES), "k": (q.dtype,), "v": (q.dtype,),
                "out": (torch.float32,), "dout": (q.dtype,),
                "lse": (torch.float32,)},
        ndims={"q": 4, "k": 4, "v": 4, "out": 4, "dout": 4, "lse": 3})
    _check_shapes("flash_attention_bwd", q, k, v, window)
    b, h, s, d = q.shape
    kh = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, h, s) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)} and contiguous lse "
                         f"{tuple(lse.shape)} must fit q {tuple(q.shape)}")
    plan = plan_of(d, q.dtype, q, k, v, out, dout)
    width = build.padded_width(d, q.dtype) if plan.padded else d
    q, k, v, out, dout = (_fit(x, width) for x in (q, k, v, out, dout))
    dq = torch.empty((b, h, s, width), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kh, s, width), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    n_groups = (bwd_head_groups(b, kh, h // kh, s, fill_blocks(q.device))
                if q.dtype == torch.bfloat16 and plan.passes == 1
                and plan.w in BWD_GROUPED_DIMS else 1)
    # the groups' f32 partial dK and dV, which the fourth launch sums
    part = (torch.empty((2, n_groups, b, kh, s, width), dtype=torch.float32,
                        device=q.device) if n_groups > 1 else None)
    lib = build.library("flash_attention_bwd", _BWD_SIGNATURES)
    design, ran, passes = ctypes.c_int(-1), ctypes.c_int(0), ctypes.c_int(0)
    grid = (ctypes.c_int * 2)()
    err = lib.flash_attention_bwd_launch(
        q.device.index, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, h, kh, s, width,
        plan.w, n_groups, *_strides(q), *_strides(k), *_strides(v),
        *_strides(out), *_strides(dout), *_strides(dq), *_strides(dk),
        *_strides(dv), int(bool(causal)), int(window), d ** -0.5,
        ctypes.byref(design), ctypes.byref(grid), ctypes.byref(ran),
        ctypes.byref(passes), build.stream_of(q))
    build.check(lib, err, "flash_attention_bwd")
    counter_bwd.add(d)
    counter_bwd_instance.add(build.HeadDimPlan(d, ran.value, passes.value,
                                               plan.padded))
    if design.value == 1:
        counter_bwd_tc.add(d)
    elif design.value == _COLS:
        counter_bwd_cols.add(d)
    counter_bwd_plan.add(BwdPlan(grid[0], grid[1]))
    if width != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv
