"""Zipfian sampling for YCSB-style skewed workloads (port of the numpy half
of ``repro.workloads.zipf``: identical draws from identical seeds).

* ``ZipfSampler`` — Hörmann & Derflinger rejection-inversion, O(1) per
  sample and O(1) setup, usable for 60M-key universes;
* ``zipf_cdf_table`` — a truncated-CDF table (explicit head + uniform tail).

References: W. Hörmann, G. Derflinger, "Rejection-inversion to generate
variates from monotone discrete distributions", TOMACS 6(3), 1996; YCSB
(Cooper et al., SoCC'10).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ZipfSampler", "zipf_cdf_table", "scramble"]

_GOLDEN64 = np.uint64(0x9E3779B97F4A7C15)


def scramble(ids: np.ndarray, n: int) -> np.ndarray:
    """YCSB-style scrambling: map rank->key id via a 64-bit mix so that the
    hot ranks are scattered over the key space (hot keys are not adjacent)."""
    x = ids.astype(np.uint64)
    x = (x + np.uint64(1)) * _GOLDEN64
    x ^= x >> np.uint64(31)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    return (x % np.uint64(n)).astype(np.int64)


@dataclasses.dataclass
class ZipfSampler:
    """Rejection-inversion Zipf(theta) sampler over ranks [0, n)."""

    n: int
    theta: float = 0.99
    seed: int = 0

    def __post_init__(self) -> None:
        if not (0.0 <= self.theta) or self.theta == 1.0:
            raise ValueError(f"theta must be >=0 and != 1, got {self.theta}")
        self._rng = np.random.default_rng(self.seed)
        q = self.theta
        self._q = q
        # H(x) = (x^(1-q) - 1) / (1-q)   (integral of x^-q)
        self._one_minus_q = 1.0 - q
        self._one_minus_q_inv = 1.0 / self._one_minus_q
        self._h_x1 = self._H(1.5) - 1.0
        self._h_n = self._H(self.n + 0.5)
        self._s = 2.0 - self._H_inv(self._H(2.5) - 2.0 ** -q)

    def _H(self, x: float | np.ndarray):
        return (np.power(x, self._one_minus_q) - 1.0) * self._one_minus_q_inv

    def _H_inv(self, x: float | np.ndarray):
        return np.power(1.0 + x * self._one_minus_q, self._one_minus_q_inv)

    def sample(self, size: int, scrambled: bool = True) -> np.ndarray:
        """Draw ``size`` ranks (optionally scrambled into key ids)."""
        if self.theta == 0.0:
            out = self._rng.integers(0, self.n, size=size, dtype=np.int64)
            return out
        out = np.empty(size, dtype=np.int64)
        filled = 0
        while filled < size:
            todo = size - filled
            u = self._rng.random(todo)
            hx = self._h_x1 + u * (self._h_n - self._h_x1)
            x = self._H_inv(hx)
            k = np.floor(x + 0.5)
            accept = (k - x <= self._s) | (hx >= self._H(k + 0.5) - np.power(k, -self._q))
            acc = k[accept].astype(np.int64) - 1  # 0-based rank
            take = min(todo, acc.shape[0])
            out[filled : filled + take] = acc[:take]
            filled += take
        np.clip(out, 0, self.n - 1, out=out)
        if scrambled:
            out = scramble(out, self.n)
        return out


def zipf_cdf_table(n: int, theta: float, head: int = 8192) -> np.ndarray:
    """CDF over ``head`` explicit top ranks + 1 tail bucket (uniform inside).

    Returns float32 array of shape (head + 1,): cumulative probabilities.
    """
    head = min(head, n)
    ranks = np.arange(1, head + 1, dtype=np.float64)
    w = ranks ** (-theta)
    if n > head:
        # integral approximation of the tail mass sum_{head+1..n} k^-theta
        if theta == 1.0:
            tail = np.log(n + 0.5) - np.log(head + 0.5)
        else:
            tail = ((n + 0.5) ** (1 - theta) - (head + 0.5) ** (1 - theta)) / (1 - theta)
    else:
        tail = 0.0
    total = w.sum() + tail
    cdf = np.concatenate([np.cumsum(w), [w.sum() + tail]]) / total
    return cdf.astype(np.float32)
