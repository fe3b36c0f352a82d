"""Assigned-architecture registry: ``get_config(name, smoke=False)`` (port
of ``repro.configs``, shapes only: weights are random).

Each module defines CONFIG (the exact published dims) and SMOKE (a reduced
same-family config for CPU smoke tests).  Select with ``--arch <id>``.
"""
from __future__ import annotations

import importlib

ALL_ARCHS = [
    "mistral-large-123b", "minitron-8b", "qwen2.5-32b", "qwen3-0.6b",
    "hubert-xlarge", "mamba2-1.3b", "phi-3-vision-4.2b", "kimi-k2-1t-a32b",
    "deepseek-moe-16b", "recurrentgemma-9b",
]

_MOD = {n: n.replace("-", "_").replace(".", "_") for n in ALL_ARCHS}


def get_config(name: str, smoke: bool = False):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; choose from {ALL_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
