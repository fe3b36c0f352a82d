"""Data (port of ``repro.data``): the deterministic, resumable synthetic
token pipeline."""
from repro_torch.data.pipeline import DataConfig, Pipeline

__all__ = ["DataConfig", "Pipeline"]
