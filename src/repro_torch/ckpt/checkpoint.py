"""Checkpointing with restore by leaf path (port of
``repro.ckpt.checkpoint``, on one device).

Format: one ``.npz`` per step plus a JSON manifest keyed by leaf path, the
reference's: a path joins dict keys, sequence indices and ``.field`` for a
dataclass field (``OptState``'s ``m``, ``v``, ``step``) with "/".  bf16
tensors are stored as their raw 2-byte payload, as ``np.savez`` stores the
reference's ml_dtypes bf16 arrays, and are reinterpreted on restore.
``AsyncCheckpointer.save_async`` copies the tree to host memory before
its writer thread starts, so the training step only waits for the
previous save.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import torch

__all__ = ["save", "latest_step", "restore", "AsyncCheckpointer"]


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of nested dicts, tuples, lists and dataclasses."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in sorted(tree.items()))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif dataclasses.is_dataclass(tree):
        items = ((f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(_flatten(value, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(tree, leaves, prefix: str = ""):
    """The structure of ``tree`` with its leaves from ``leaves`` by path."""
    def at(key):
        return f"{prefix}/{key}" if prefix else key
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, at(str(k))) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves, at(str(i)))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _unflatten(getattr(tree, f.name), leaves,
                                                at(f".{f.name}"))
                             for f in dataclasses.fields(tree)})
    return leaves[prefix]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save(path: str, step: int, tree) -> None:
    """Write ``tree``'s tensors as ``step_<step>.npz`` under ``path``, then
    the manifest (atomically replaced)."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(path, f"step_{step:08d}.npz"),
             **{k: _to_numpy(v) for k, v in flat.items()})
    manifest = {"step": step,
                "leaves": {k: {"shape": list(v.shape),
                               "dtype": _dtype_name(v)}
                           for k, v in flat.items()}}
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def latest_step(path: str) -> int | None:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


def restore(path: str, tree_like, step: int | None = None):
    """``(tree, step)``: the structure of ``tree_like`` with every tensor
    read back from the checkpoint, in the like tensor's dtype and on its
    device; raises on a missing checkpoint or a shape that differs."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    data = np.load(os.path.join(path, f"step_{step:08d}.npz"))
    leaves = {}
    for name, like in _flatten(tree_like).items():
        arr = data[name]
        if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
                and arr.dtype.kind in "Vui":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr)).to(like.dtype)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name}: ckpt {tuple(t.shape)} != model "
                             f"{tuple(like.shape)}")
        leaves[name] = t.to(like.device)
    return _unflatten(tree_like, leaves), step


class AsyncCheckpointer:
    """Fire-and-forget saves; ``wait()`` joins the in-flight save."""

    def __init__(self, path: str):
        self.path = path
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree) -> None:
        self.wait()
        # snapshot to host memory before the thread starts
        host = _unflatten(tree, {k: v.detach().to("cpu", copy=True)
                                 for k, v in _flatten(tree).items()})
        self._thread = threading.Thread(target=save,
                                        args=(self.path, step, host),
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
