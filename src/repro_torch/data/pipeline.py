"""Deterministic, resumable, per-host-sharded synthetic data pipeline (port
of ``repro.data.pipeline``).

Batch ``i`` of host ``h`` is a pure function of (seed, i, h): it is drawn on
the pipeline's device from a ``torch.Generator`` seeded by a 64-bit mix of
the three, so a restart at step k needs no state beyond the step counter.
Tokens are Zipf-distributed (``workloads.zipf.sample_zipf_torch``: the
reference's table, tail bucket and scramble).  The reference draws from
JAX's threefry, which is not reproduced: batches equal the reference's in
distribution and determinism, not bit for bit, so the tests that compare
the two feed both the same numpy batches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import as_device
from repro_torch.workloads.zipf import sample_zipf_torch, zipf_cdf_table

__all__ = ["DataConfig", "Pipeline"]

_M64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    theta: float = 1.0       # token-frequency skew (~natural language)
    seed: int = 0


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class Pipeline:
    def __init__(self, cfg: DataConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide over hosts")
        self.per_host = cfg.global_batch // cfg.n_hosts
        self.device = as_device(device)
        self._cdf = torch.as_tensor(zipf_cdf_table(cfg.vocab, cfg.theta),
                                    device=self.device)

    def batch_at(self, step: int) -> dict:
        """The (host-local) batch for ``step``: ``tokens`` and ``targets``,
        each (per_host, seq_len) int32 on the device, targets the tokens
        shifted by one."""
        cfg = self.cfg
        seed = _mix(_mix(_mix(cfg.seed) ^ step) ^ cfg.host_id) >> 1
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = sample_zipf_torch(gen, (self.per_host, cfg.seq_len + 1),
                                 self._cdf, cfg.vocab) % cfg.vocab
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
