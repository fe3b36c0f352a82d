"""SwiGLU feed-forward (the dense family's MLP, ``_mlp_fwd`` of
``repro.models.transformer``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["swiglu"]


def swiglu(xn: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    """``(silu(xn @ w_gate) * (xn @ w_up)) @ w_out`` in the weights' dtype."""
    return (F.silu(xn @ w_gate) * (xn @ w_up)) @ w_out
