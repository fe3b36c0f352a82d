"""Training (port of ``repro.train``): AdamW with bf16 parameters and f32
moments."""
from repro_torch.train.optimizer import (OptState, adamw_init, adamw_update,
                                         clip_by_global_norm)

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm"]
