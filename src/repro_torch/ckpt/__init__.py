"""Checkpointing (port of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, latest_step,
                                         restore, save)

__all__ = ["save", "latest_step", "restore", "AsyncCheckpointer"]
