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

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["SOURCES", "LaunchCounter", "build", "library", "check",
           "stream_of", "require_cuda", "require_cuda_views"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("wc_combine", "scan_probe", "paged_attention",
           "flash_attention")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch, nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from csrc/ at first use")
    return path


def _target(name: str) -> Path:
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
        out = _target(name)
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
        lib = ctypes.CDLL(str(_target(name)))
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
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


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


def require_cuda_views(what: str, named: dict, dtypes, ndims: dict,
                       rows16=()) -> None:
    """Check the N-D inputs of a kernel that reads strided views: every
    tensor of ``named`` (``{name: tensor}``) is on one CUDA device, has the
    rank ``ndims[name]`` and a contiguous last axis, and its dtype is in
    ``dtypes[name]``; the rows of each tensor named in ``rows16`` start on
    16-byte boundaries (base pointer and every stride but the last), as the
    kernel loads them 16 bytes at a time.  Raise ``ValueError`` otherwise."""
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
        if name in rows16 and (
                t.data_ptr() % 16
                or any(st * t.element_size() % 16 for st in t.stride()[:-1])):
            raise ValueError(f"{what}: the rows of {name} must start on "
                             f"16-byte boundaries, got strides {t.stride()} "
                             f"at address {t.data_ptr():#x}")

