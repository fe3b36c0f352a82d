"""The public Model API the serve, train and dry-run entry points call
(port of ``repro.models.model``): ``init``, ``loss_fn`` (with
``cross_entropy``), ``prefill``, ``decode_step`` and ``init_decode_state``
for every family, and the abstract model the dry-run accounts with:
``init_abstract`` (meta tensors: shapes and dtypes, no memory, no draws),
``param_axes``, ``n_params``, ``decode_state_spec`` and ``input_specs``.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import as_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import MetaGenerator
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontend import frontend_spec

__all__ = ["Model", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token cross-entropy in f32 through logsumexp; with ``mask``, the
    masked mean (over at least one token), else the mean."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


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

    def init_abstract(self) -> dict:
        """The parameter tree as meta tensors: every leaf's shape and dtype,
        with no memory behind it (kimi-k2-1t-a32b's 1.04 T parameters
        too)."""
        return tfm.init_params(self.cfg, MetaGenerator())

    def param_axes(self) -> dict:
        """The logical axes of every leaf, in the parameter tree's
        structure (``transformer.param_axes``)."""
        return tfm.param_axes(self.cfg)

    def n_params(self) -> int:
        return sum(t.numel() for t in _leaves(self.init_abstract()))

    def loss_fn(self, params, batch: dict):
        """``(loss, {"ce", "aux"})`` of ``batch`` (``tokens``, ``targets``
        and optionally ``frontend`` and ``mask``): the vlm's image-prefix
        positions carry no next-token loss, and the MoE adds 0.01 times its
        auxiliary loss."""
        cfg = self.cfg
        logits, aux, _ = tfm.forward(cfg, params, batch["tokens"],
                                     batch.get("frontend"))
        if cfg.frontend and cfg.family != "encoder":
            logits = logits[:, cfg.n_patches:, :]
        loss = cross_entropy(logits, batch["targets"], batch.get("mask"))
        if cfg.family == "moe":
            loss = loss + 0.01 * aux
        return loss, {"ce": loss, "aux": aux}

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

    def decode_state_spec(self, batch: int, smax: int) -> dict:
        """The decode state as meta tensors."""
        return tfm.init_decode_state(self.cfg, batch, smax, "meta")

    def input_specs(self, shape_cell: str, seq: int, global_batch: int
                    ) -> dict:
        """The inputs of a ``train``, ``prefill`` or ``decode`` step as meta
        tensors, with the reference's shapes and dtypes: int32 tokens (the
        vlm's text is ``seq - n_patches`` long, the encoder takes ``(B,
        0)`` tokens and ``seq`` frames), the frontend stub's bf16 features,
        and for decode one token a sequence, the position and the decode
        state of ``seq`` rows."""
        cfg = self.cfg
        gb = global_batch

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if shape_cell in ("train", "prefill"):
            s_text = seq - (cfg.n_patches if cfg.frontend == "vision" else 0)
            specs = {"tokens": meta((gb, 0 if cfg.family == "encoder"
                                     else s_text))}
            if shape_cell == "train":
                specs["targets"] = meta((gb, seq if cfg.family == "encoder"
                                         else s_text))
            fs = frontend_spec(cfg, gb, seq)
            if fs is not None:
                specs["frontend"] = meta(*fs)
            return specs
        if shape_cell == "decode":
            return {"token": meta((gb, 1)), "pos": meta(()),
                    "state": self.decode_state_spec(gb, seq)}
        raise ValueError(shape_cell)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))
