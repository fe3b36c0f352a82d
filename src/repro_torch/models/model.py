"""The public Model API the serve entry point calls (port of
``repro.models.model``): ``init``, ``prefill``, ``decode_step`` and
``init_decode_state`` for every family.  ``loss_fn`` and ``cross_entropy``
arrive with the training slice."""
from __future__ import annotations

import torch

from repro_torch.core.types import as_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

__all__ = ["Model"]


class Model:
    """Thin wrapper binding a ModelConfig and a device to the transformer
    functions; parameters are passed in, as in the reference."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = as_device(device)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters from ``generator``, which must be on the
        model's device type."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        return tfm.init_params(self.cfg, generator)

    def prefill(self, params, tokens: torch.Tensor, frontend=None):
        """Last-position logits (B, 1, V) and the attention layers'
        ``(k, v)`` caches, each (L_attn, B, S, KH, hd), or None for a
        family without attention; ``frontend`` holds the stub features of
        the encoder and the vlm."""
        logits, _, caches = tfm.forward(self.cfg, params, tokens, frontend,
                                        return_cache=True)
        return logits[:, -1:, :], caches

    def decode_step(self, params, state: dict, token: torch.Tensor, pos: int):
        return tfm.decode_step(self.cfg, params, state, token, pos)

    def init_decode_state(self, batch: int, smax: int) -> dict:
        """Raises ``ValueError`` for the encoder (no decode state)."""
        return tfm.init_decode_state(self.cfg, batch, smax, self.device)
