"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library with a
plain C interface -> ``ctypes``.

Every source in ``csrc/`` compiles to its own library, named by a hash of
the source and the shared headers (``csrc/*.cuh``), under ``build/kernels/``
at the repository root (listed in ``.gitignore``); a library that exists is
reused.  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them.  Each C entry
point takes the device ordinal, raw pointers and the caller's stream, and
returns ``cudaGetLastError()`` after its launches; ``check`` raises on any
non-zero code.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Hashable, NamedTuple

import torch

__all__ = ["SOURCES", "LaunchCounter", "launch_tag", "build", "library",
           "library_path", "check", "stream_of", "require_cuda",
           "require_cuda_views", "rows16", "padded_width", "HeadDimPlan",
           "head_dim_plan"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("wc_combine", "scan_probe", "paged_attention",
           "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_TAGS: list[str] = []


@contextlib.contextmanager
def launch_tag(tag: str):
    """Tally the launches made inside the block under ``tag`` as well, in
    every counter's ``by_tag`` (the innermost tag when blocks nest)."""
    _TAGS.append(tag)
    try:
        yield
    finally:
        _TAGS.pop()


class LaunchCounter:
    """Launches of one kernel: its wrapper calls ``add`` once per launch,
    nowhere else; ``by_size`` tallies them by problem size (N, the head
    dim of an attention kernel, or the grid a launcher reports) and
    ``by_tag`` by the caller's ``launch_tag``."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_size: dict[Hashable, int] = {}
        self.by_tag: dict[str, int] = {}

    def add(self, size: Hashable) -> None:
        """One launch at problem size ``size``."""
        self.count += 1
        self.by_size[size] = self.by_size.get(size, 0) + 1
        if _TAGS:
            self.by_tag[_TAGS[-1]] = self.by_tag.get(_TAGS[-1], 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_size.clear()
        self.by_tag.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from csrc/ at first use")
    return path


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header in ``csrc/`` (a header change rebuilds every library)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile each library of ``names`` that is missing, one ``nvcc`` per
    source, all started together.  Returns ``{name: nvcc output}`` for the
    libraries built by this call (ptxas register/spill report included)."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), with
    ``signatures`` = ``{symbol: (restype, argtypes)}`` declared on it."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        for sym, (restype, argtypes) in signatures.items():
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = restype, argtypes
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on CUDA tensor ``t``'s device,
    read without building a ``torch.cuda.Stream`` (the raw handle that
    ``torch.cuda.current_stream(...).cuda_stream`` holds)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(what: str, *tensors: torch.Tensor, dtypes=()) -> None:
    """Check that the kernel's inputs are 1-D, contiguous, equally long CUDA
    tensors of the expected dtypes on one device; raise otherwise."""
    n = tensors[0].shape[0]
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: input {i} is on {t.device}, expected "
                             f"one CUDA device ({dev})")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{what}: input {i} must be a contiguous (N,) "
                             f"tensor with N={n}, got {tuple(t.shape)}")
        if dtypes and t.dtype != dtypes[i]:
            raise ValueError(f"{what}: input {i} is {t.dtype}, expected "
                             f"{dtypes[i]}")
    if n >= 2**31:
        raise ValueError(f"{what}: N={n} exceeds the kernel's int32 indexing")


def require_cuda_views(what: str, named: dict, dtypes, ndims: dict) -> None:
    """Check the N-D inputs of a kernel that reads strided views: every
    tensor of ``named`` (``{name: tensor}``) is on one CUDA device, has the
    rank ``ndims[name]`` and a contiguous last axis, and its dtype is in
    ``dtypes[name]``.  Raise ``ValueError`` otherwise."""
    dev = None
    for name, t in named.items():
        if t.device.type != "cuda" or (dev is not None and t.device != dev):
            raise ValueError(f"{what}: {name} is on {t.device}, expected one "
                             f"CUDA device{f' ({dev})' if dev else ''}")
        dev = t.device
        if t.dim() != ndims[name]:
            raise ValueError(f"{what}: {name} must have {ndims[name]} axes, "
                             f"got shape {tuple(t.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last axis, "
                             f"got strides {t.stride()}")
        if t.dtype not in dtypes[name]:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected one of "
                             f"{dtypes[name]}")


def rows16(t: torch.Tensor) -> bool:
    """Whether every row (last axis) of ``t`` is whole 16-byte chunks that
    start on 16-byte boundaries: base pointer, every stride but the last
    and the row's bytes multiples of 16 -- what TMA's tensor maps and the
    kernels' 16-byte loads need."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * es % 16 == 0
            and all(st * es % 16 == 0 for st in t.stride()[:-1]))


def padded_width(d: int, dtype: torch.dtype) -> int:
    """``d`` rounded up to whole 16-byte chunks of ``dtype`` (a multiple of
    8 in bf16, of 4 in f32): the row width of a padded copy."""
    step = 16 // dtype.itemsize
    return -(-d // step) * step


class HeadDimPlan(NamedTuple):
    """How an attention kernel runs head dim ``d``: on the compiled width
    ``w``, in ``passes`` column passes (1 up to 256; past it ceil(width /
    256) passes of 256 output columns, each computing the scores over the
    whole row), on dense zero-padded copies of its inputs when
    ``padded``.  A launcher counts each launch under the plan it ran."""
    d: int
    w: int
    passes: int
    padded: bool


def head_dim_plan(what: str, d: int, dtype: torch.dtype,
                  instances: tuple[int, ...], padded: bool) -> HeadDimPlan:
    """The plan of head dim ``d`` (any ``d >= 1``) in ``dtype`` on a kernel
    compiled at ``instances`` (ascending, the widest 256): the width it
    runs at is ``d``, or ``padded_width`` when ``padded``; up to 256 the
    smallest instance at or above it, past 256 the widest in ceil(width /
    256) column passes.  Zero columns add exact zeros to every product and
    nothing is stored past ``d``, so the plan changes no result but by
    the order of its sums.  Raise ``ValueError`` for ``d < 1``."""
    if d < 1:
        raise ValueError(f"{what}: head dim {d} < 1")
    width = padded_width(d, dtype) if padded else d
    top = instances[-1]
    if width > top:
        return HeadDimPlan(d, top, -(-width // top), padded)
    return HeadDimPlan(d, next(w for w in instances if w >= width), 1, padded)
