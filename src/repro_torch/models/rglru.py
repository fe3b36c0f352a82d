"""RG-LRU recurrent block (port of ``repro.models.rglru``; RecurrentGemma /
Griffin, arXiv:2402.19427).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))          (c = 8)

Prefill scans over time in log depth (``common.associative_scan``, the
reference's ``lax.associative_scan`` algorithm: 2 log2(S) levels of tensor
ops, not S steps); decode is the O(1) recurrence.  The temporal conv1d
(width 4) before the gate sums its taps in f32, in tap order, and rounds
once, in both ``causal_conv1d`` and ``conv1d_step``, and the decode step
computes its gates in f32 as the scan does: the reference's contract that
decode equals prefill.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import associative_scan

__all__ = ["rglru_scan", "rglru_step", "causal_conv1d", "conv1d_step"]

_C = 8.0


def _gates(x, w_input, w_rec, lam):
    i_t = torch.sigmoid(x @ w_input)
    r_t = torch.sigmoid(x @ w_rec)
    log_a = -_C * F.softplus(lam) * r_t
    return i_t, log_a


def _linear_comb(left, right):
    h_l, a_l = left
    h_r, a_r = right
    return h_r + h_l * a_r, a_l * a_r


def rglru_scan(x: torch.Tensor, w_input, w_rec, lam, h0=None):
    """x: (b, s, d).  Returns (y (b, s, d) in x's dtype, h_final (b, d) f32)."""
    f32 = torch.float32
    xf = x.to(f32)
    i_t, log_a = _gates(xf, w_input.to(f32), w_rec.to(f32), lam)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i_t * xf)
    if h0 is not None:
        # h0 enters as the first step's carry: a_0 * h0 added to its input
        gated = torch.cat([gated[:, :1] + (h0.to(f32) * a[:, 0])[:, None],
                           gated[:, 1:]], 1)
    h, _ = associative_scan(_linear_comb, (gated, a), dim=1)
    return h.to(x.dtype), h[:, -1]


def rglru_step(h: torch.Tensor, x_t: torch.Tensor, w_input, w_rec, lam):
    """One decode step.  h: (b, d) f32; x_t: (b, d).  Returns (y_t in x_t's
    dtype, h' f32)."""
    f32 = torch.float32
    xf = x_t.to(f32)
    i_t, log_a = _gates(xf, w_input.to(f32), w_rec.to(f32), lam)
    h = torch.exp(log_a) * h + torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i_t * xf)
    return h.to(x_t.dtype), h


def _taps(window: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """sum_i window[:, i:i+n] * w[i] in f32, tap after tap."""
    wf = w.to(torch.float32)
    out = window[:, 0:n] * wf[0]
    for i in range(1, w.shape[0]):
        out = out + window[:, i:i + n] * wf[i]
    return out


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (b, s, d); w: (k, d).  Accumulates in f32
    and rounds once to x's dtype."""
    k = w.shape[0]
    xp = F.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    return _taps(xp, w, x.shape[1]).to(x.dtype)


def conv1d_step(tail: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor):
    """Decode conv step.  tail: (b, k-1, d) previous inputs; x_t: (b, d).
    Returns (y_t (b, d), tail')."""
    window = torch.cat([tail, x_t[:, None, :]], 1)            # (b, k, d)
    y = _taps(window.to(torch.float32), w, 1)[:, 0]
    return y.to(x_t.dtype), window[:, 1:, :]
