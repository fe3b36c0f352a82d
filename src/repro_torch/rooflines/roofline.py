"""Three-term roofline model of one step on an NVIDIA H100 SXM (port of
``repro.rooflines.roofline``, whose constants are a TPU's).

Every per-chip quantity is one device's share of the step, so:

    compute term    = chip_flops / 989e12          [s]
    memory term     = chip_hbm_bytes / 3.35e12     [s]
    collective term = chip_wire_bytes / 450e9      [s]

The dominant term is the bottleneck; a cell's roofline fraction is
useful_model_flops / (chips * peak * dominant term).  Where the collective
bytes are not known (``None``), the collective term is ``None`` and the
other two decide.

Constants (``H100``), NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the full 700 W power limit: 989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s of HBM3, and 900 GB/s of NVLink to the host's other cards,
450 GB/s each way.
"""
from __future__ import annotations

import dataclasses

__all__ = ["H100", "RooflineTerms", "roofline", "model_flops"]

PEAK_FLOPS = 989e12       # bf16, dense, tensor cores (H100 SXM data sheet)
HBM_BW = 3.35e12          # bytes/s of HBM3 (H100 SXM data sheet)
NVLINK_BW = 450e9         # bytes/s each way of 900 GB/s NVLink (data sheet)
H100 = dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, link_bw=NVLINK_BW)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float | None
    bottleneck: str
    chip_flops: float
    chip_hbm_bytes: float
    chip_wire_bytes: float | None
    model_flops: float            # 6*N_act*D (train) / 2*N_act*D (inference)
    useful_ratio: float           # model_flops / (chips * chip_flops)
    roofline_fraction: float      # model_flops / (chips*peak*dominant)
    step_time_s: float            # max of the known terms (no-overlap bound)

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline(chip_flops: float, chip_hbm_bytes: float,
             chip_wire_bytes: float | None, model_flops: float, chips: int,
             chip: dict = H100) -> RooflineTerms:
    ct = chip_flops / chip["peak_flops"]
    mt = chip_hbm_bytes / chip["hbm_bw"]
    lt = None if chip_wire_bytes is None else chip_wire_bytes / chip["link_bw"]
    terms = {"compute": ct, "memory": mt}
    if lt is not None:
        terms["collective"] = lt
    bott = max(terms, key=terms.get)
    step = max(terms.values())
    return RooflineTerms(
        compute_s=ct, memory_s=mt, collective_s=lt, bottleneck=bott,
        chip_flops=chip_flops, chip_hbm_bytes=chip_hbm_bytes,
        chip_wire_bytes=chip_wire_bytes, model_flops=model_flops,
        useful_ratio=model_flops / max(chips * chip_flops, 1.0),
        roofline_fraction=model_flops / max(
            chips * chip["peak_flops"] * step, 1e-30),
        step_time_s=step)


def model_flops(cfg, kind: str, seq: int, global_batch: int,
                n_params: int) -> float:
    """6*N*D for training, 2*N*D for inference (N = active params)."""
    n_act = n_params
    if cfg.family == "moe":
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        expert_p = cfg.n_layers * e * 3 * d * f
        n_act = n_params - expert_p + cfg.n_layers * (cfg.top_k * 3 * d * f)
    if kind == "train":
        tokens = seq * global_batch
        return 6.0 * n_act * tokens
    if kind == "prefill":
        tokens = seq * global_batch
        return 2.0 * n_act * tokens
    # decode: one token per sequence; SSM/hybrid read O(1) state, attention
    # reads the KV cache (memory-bound) — FLOPs side stays 2*N_act per token
    return 2.0 * n_act * global_batch
