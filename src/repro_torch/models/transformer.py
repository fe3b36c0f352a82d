"""The dense family's blocks, parameters, forward and decode step (port of
``repro.models.transformer``, ``dense`` only).

A parameter tree is a nested dict of tensors with the reference's keys,
shapes and dtypes (bf16 weights, f32 norms and biases); the stacked layer
weights keep their leading ``layers`` axis, and a Python loop over it
stands in for ``lax.scan`` (remat does not apply to inference).  Other
families and frontends raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.common import (apply_rope, init_dense, init_embed,
                                       init_scalar, rms_norm, rope,
                                       trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import swiglu

__all__ = ["require_dense", "init_params", "forward", "decode_step",
           "init_decode_state"]


def require_dense(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet (ROADMAP A15)."""
    if cfg.family != "dense" or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense family without a frontend;"
            f" family {cfg.family!r}"
            f"{f' with a {cfg.frontend} frontend' if cfg.frontend else ''} "
            f"is ROADMAP item A15 (moe, ssm, hybrid, encoder, vlm)")


def _layers(blocks: dict, n: int):
    """Per-layer views of the stacked block weights."""
    for i in range(n):
        yield {name: w[i] for name, w in blocks.items()}


# ===========================================================================
# Parameter init (stacked layers carry a leading "layers" axis)
# ===========================================================================

def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters from ``gen``, on ``gen``'s device, with the
    reference's tree structure, shapes, dtypes and scales."""
    require_dense(cfg)
    d, h, kh, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                          cfg.d_ff, cfg.n_layers)
    params = {"embed": init_embed(gen, cfg.vocab, d),
              "final_norm": init_scalar(gen, (d,))}
    if not cfg.tie_embed:
        params["lm_head"] = init_dense(gen, d, (cfg.vocab,))
    s_attn = 1.0 / math.sqrt(d)
    blocks = {
        "ln1": init_scalar(gen, (L, d)),
        "wq": trunc_normal(gen, (L, d, h, hd), s_attn),
        "wk": trunc_normal(gen, (L, d, kh, hd), s_attn),
        "wv": trunc_normal(gen, (L, d, kh, hd), s_attn),
        "wo": trunc_normal(gen, (L, h * hd, d), s_attn),
    }
    if cfg.qkv_bias:
        blocks["bq"] = init_scalar(gen, (L, h, hd), 0.0)
        blocks["bk"] = init_scalar(gen, (L, kh, hd), 0.0)
        blocks["bv"] = init_scalar(gen, (L, kh, hd), 0.0)
    if cfg.qk_norm:
        blocks["qnorm"] = init_scalar(gen, (L, hd))
        blocks["knorm"] = init_scalar(gen, (L, hd))
    blocks.update({
        "ln2": init_scalar(gen, (L, d)),
        "wi_gate": trunc_normal(gen, (L, d, f), 1.0 / math.sqrt(d)),
        "wi_up": trunc_normal(gen, (L, d, f), 1.0 / math.sqrt(d)),
        "wo_mlp": trunc_normal(gen, (L, f, d), 1.0 / math.sqrt(f)),
    })
    params["blocks"] = blocks
    return params


# ===========================================================================
# Blocks
# ===========================================================================

def _qkv(cfg: ModelConfig, x, blk, sin, cos):
    """Normed input -> roped q (B,S,H,hd), k, v (B,S,KH,hd) in x's dtype."""
    b, s, d = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    xn = rms_norm(x, blk["ln1"])
    q = (xn @ blk["wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = (xn @ blk["wk"].reshape(d, kh * hd)).view(b, s, kh, hd)
    v = (xn @ blk["wv"].reshape(d, kh * hd)).view(b, s, kh, hd)
    if cfg.qkv_bias:
        q, k, v = q + blk["bq"], k + blk["bk"], v + blk["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, blk["qnorm"])
        k = rms_norm(k, blk["knorm"])
    q = apply_rope(q, sin, cos).to(x.dtype)
    k = apply_rope(k, sin, cos).to(x.dtype)
    return q, k, v.to(x.dtype)


def _attn_out(cfg: ModelConfig, x, att, blk):
    b, s, _ = x.shape
    return x + att.reshape(b, s, cfg.n_heads * cfg.hd) @ blk["wo"]


def _attn_fwd(cfg: ModelConfig, x, blk, sin, cos, *, window=0):
    q, k, v = _qkv(cfg, x, blk, sin, cos)
    att = gqa_attention(q, k, v, causal=cfg.causal, window=window,
                        chunk=cfg.attn_chunk)
    return _attn_out(cfg, x, att, blk), (k, v)


def _mlp_fwd(cfg: ModelConfig, x, blk):
    xn = rms_norm(x, blk["ln2"])
    return x + swiglu(xn, blk["wi_gate"], blk["wi_up"], blk["wo_mlp"])


def _logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embed else params["lm_head"]
    return x @ head


# ===========================================================================
# Full forward (prefill)
# ===========================================================================

def forward(cfg: ModelConfig, params, tokens: torch.Tensor, positions=None,
            return_cache: bool = False):
    """Prefill forward.  tokens: (B, S) int.  Returns ``(logits (B, S, V),
    aux, caches)``: aux is a zero f32 scalar (dense has no auxiliary loss);
    caches is ``(k, v)``, each stacked ``(L, B, S, KH, hd)``, when
    ``return_cache``, else None."""
    require_dense(cfg)
    x = params["embed"][tokens]
    s = x.shape[1]
    pos = (torch.arange(s, device=x.device) if positions is None
           else positions)
    sin, cos = rope(pos, cfg.hd, cfg.rope_theta)
    ks, vs = [], []
    for blk in _layers(params["blocks"], cfg.n_layers):
        x, (k, v) = _attn_fwd(cfg, x, blk, sin, cos)
        x = _mlp_fwd(cfg, x, blk)
        if return_cache:
            ks.append(k)
            vs.append(v)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = (torch.stack(ks), torch.stack(vs)) if return_cache else None
    return _logits(cfg, params, x), aux, caches


# ===========================================================================
# Decode (single-token, stateful)
# ===========================================================================

def init_decode_state(cfg: ModelConfig, batch: int, smax: int,
                      device: str | torch.device = "cuda") -> dict:
    """Zero-filled cache ``{"k", "v"}``, each ``(L, B, Smax, KH, hd)`` bf16."""
    require_dense(cfg)
    shape = (cfg.n_layers, batch, smax, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _attn_decode(cfg: ModelConfig, x, blk, state_k, state_v, pos: int,
                 length, sin, cos):
    """Writes this token's k/v row into ``state_k``/``state_v`` (one
    layer's cache views) in place, then attends over positions < length."""
    q, k, v = _qkv(cfg, x, blk, sin, cos)
    slot = min(pos, state_k.shape[1] - 1)
    state_k[:, slot] = k[:, 0]
    state_v[:, slot] = v[:, 0]
    att = decode_attention(q, state_k, state_v, length)
    return _attn_out(cfg, x, att, blk)


def decode_step(cfg: ModelConfig, params, state: dict, token: torch.Tensor,
                pos: int):
    """One decode step.  token: (B, 1) int; pos: the current length (int).
    Returns ``(logits (B, 1, V), state)``: unlike the reference, the cache
    is updated in place (``state`` itself is returned), which saves copying
    the whole (L, B, Smax, KH, hd) cache every token."""
    require_dense(cfg)
    pos = int(pos)
    x = params["embed"][token]
    b = x.shape[0]
    sin, cos = rope(torch.full((1,), pos, device=x.device), cfg.hd,
                    cfg.rope_theta)
    length = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    for i, blk in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x = _attn_decode(cfg, x, blk, state["k"][i], state["v"][i], pos,
                         length, sin, cos)
        x = _mlp_fwd(cfg, x, blk)
    return _logits(cfg, params, x), state
