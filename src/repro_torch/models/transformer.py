"""Block definitions, parameter init, forward and decode step of every model
family (port of ``repro.models.transformer``):

  dense   — GQA attention (+qkv_bias/+qk_norm variants) + SwiGLU
  moe     — GQA attention + shared/routed top-k experts
  ssm     — Mamba-2 (SSD) mixing, no attention
  hybrid  — RecurrentGemma: (rec, rec, local-attn) triples + MLP each layer,
            then a tail of rec layers
  encoder — bidirectional dense (hubert backbone) over frontend features
  vlm     — dense decoder fed a vision-stub prefix (phi-3-vision backbone)

A parameter tree is a nested dict of tensors with the reference's keys,
shapes and dtypes (bf16 weights, f32 norms, biases and recurrence
constants); the stacked layer weights keep their leading ``layers`` axis,
and a Python loop over it stands in for ``lax.scan``.  Under grad,
``cfg.remat == "block"`` checkpoints each block (each triple of the hybrid),
as the reference's ``jax.checkpoint`` does: a block keeps only its inputs
for the backward and recomputes its activations there.  The forward writes
in place into no tensor that autograd saves.

Activations carry the reference's sharding annotations (``dist.ctx.shard``)
at the reference's sites with its logical axes: the blocks' inputs, q, k
and v, the MLP's hidden activation, the SSD block's input projection, the
embedding and the logits.  They change nothing on plain tensors; on
DTensors (the dry-run's collective count) they lay the activations out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.ctx import current_mesh, shard
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssd
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.common import (apply_rope, init_dense, init_embed,
                                       init_scalar, rms_norm, rope,
                                       trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import swiglu
from repro_torch.models.moe import moe_ffn

__all__ = ["init_params", "param_axes", "forward", "decode_step",
           "init_decode_state"]

_ATTN_FAMILIES = ("dense", "encoder", "vlm", "moe")


def _layers(blocks: dict, n: int):
    """Per-layer views of the stacked block weights."""
    for i in range(n):
        yield {name: w[i] for name, w in blocks.items()}


# ===========================================================================
# Parameter init (stacked layers carry a leading "layers" axis)
# ===========================================================================

def _mk(gen, L, shape, fan_in):
    return trunc_normal(gen, (L,) + tuple(shape), 1.0 / math.sqrt(fan_in))


def _init_attn(cfg: ModelConfig, gen, L) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {"ln1": init_scalar(gen, (L, d)),
         "wq": _mk(gen, L, (d, h, hd), d),
         "wk": _mk(gen, L, (d, kh, hd), d),
         "wv": _mk(gen, L, (d, kh, hd), d),
         "wo": _mk(gen, L, (h * hd, d), d)}
    if cfg.qkv_bias:
        p["bq"] = init_scalar(gen, (L, h, hd), 0.0)
        p["bk"] = init_scalar(gen, (L, kh, hd), 0.0)
        p["bv"] = init_scalar(gen, (L, kh, hd), 0.0)
    if cfg.qk_norm:
        p["qnorm"] = init_scalar(gen, (L, hd))
        p["knorm"] = init_scalar(gen, (L, hd))
    return p


def _init_mlp(cfg: ModelConfig, gen, L) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"ln2": init_scalar(gen, (L, d)),
            "wi_gate": _mk(gen, L, (d, f), d),
            "wi_up": _mk(gen, L, (d, f), d),
            "wo_mlp": _mk(gen, L, (f, d), f)}


def _init_moe(cfg: ModelConfig, gen, L) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"ln2": init_scalar(gen, (L, d)),
         "router": _mk(gen, L, (d, e), d),
         "eg": _mk(gen, L, (e, d, f), d),
         "eu": _mk(gen, L, (e, d, f), d),
         "ed": _mk(gen, L, (e, f, d), f)}
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["sg"] = _mk(gen, L, (d, fs), d)
        p["su"] = _mk(gen, L, (d, fs), d)
        p["sd"] = _mk(gen, L, (fs, d), fs)
    return p


def _init_ssm(cfg: ModelConfig, gen, L) -> dict:
    d = cfg.d_model
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    dev = gen.device
    a_init = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                      device=dev)).expand(L, h).clone()
    return {"ln1": init_scalar(gen, (L, d)),
            "in_proj": _mk(gen, L, (d, 2 * di + 2 * g * n + h), d),
            "conv_w": _mk(gen, L, (cfg.conv_width, conv_dim),
                          cfg.conv_width),
            "A_log": a_init,
            "Dskip": init_scalar(gen, (L, h)),
            "dt_bias": init_scalar(gen, (L, h), 0.0),
            "ssm_norm": init_scalar(gen, (L, di)),
            "out_proj": _mk(gen, L, (di, d), di)}


def _init_rec(cfg: ModelConfig, gen, L) -> dict:
    d, r = cfg.d_model, cfg.rnn_width
    lam = torch.linspace(0.9, 4.0, r, dtype=torch.float32,
                         device=gen.device).expand(L, r).clone()
    return {"ln1": init_scalar(gen, (L, d)),
            "wx": _mk(gen, L, (d, r), d),
            "wgate": _mk(gen, L, (d, r), d),
            "conv": _mk(gen, L, (cfg.conv_width, r), cfg.conv_width),
            "w_input": _mk(gen, L, (r, r), r),
            "w_rec": _mk(gen, L, (r, r), r),
            "lam": lam,
            "wy": _mk(gen, L, (r, d), r)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters from ``gen``, on ``gen``'s device, with the
    reference's tree structure, shapes, dtypes and scales."""
    d, L = cfg.d_model, cfg.n_layers
    params = {"embed": init_embed(gen, cfg.vocab, d),
              "final_norm": init_scalar(gen, (d,))}
    if not cfg.tie_embed:
        params["lm_head"] = init_dense(gen, d, (cfg.vocab,))
    if cfg.frontend:
        params["front_proj"] = init_dense(gen, cfg.frontend_dim, (d,))
    if cfg.family in ("dense", "encoder", "vlm"):
        params["blocks"] = {**_init_attn(cfg, gen, L),
                            **_init_mlp(cfg, gen, L)}
    elif cfg.family == "moe":
        params["blocks"] = {**_init_attn(cfg, gen, L),
                            **_init_moe(cfg, gen, L)}
    elif cfg.family == "ssm":
        params["blocks"] = _init_ssm(cfg, gen, L)
    elif cfg.family == "hybrid":
        nt, rem = divmod(L, 3)
        params["blocks"] = {
            "rec1": {**_init_rec(cfg, gen, nt), **_init_mlp(cfg, gen, nt)},
            "rec2": {**_init_rec(cfg, gen, nt), **_init_mlp(cfg, gen, nt)},
            "attn": {**_init_attn(cfg, gen, nt), **_init_mlp(cfg, gen, nt)}}
        if rem:
            params["tail"] = {**_init_rec(cfg, gen, rem),
                              **_init_mlp(cfg, gen, rem)}
    else:
        raise ValueError(cfg.family)
    return params


# ===========================================================================
# Logical axes of every parameter (the reference's ``Param.axes``)
# ===========================================================================

_LE, _LM = ("layers", "embed"), ("layers", "mlp")


def _attn_axes(cfg: ModelConfig) -> dict:
    p = {"ln1": _LE, "wq": ("layers", "embed", "heads", "head_dim"),
         "wk": ("layers", "embed", "kv", "head_dim"),
         "wv": ("layers", "embed", "kv", "head_dim"),
         "wo": ("layers", "heads", "embed")}
    if cfg.qkv_bias:
        p["bq"] = ("layers", "heads", "head_dim")
        p["bk"] = p["bv"] = ("layers", "kv", "head_dim")
    if cfg.qk_norm:
        p["qnorm"] = p["knorm"] = ("layers", "head_dim")
    return p


def _mlp_axes(cfg: ModelConfig) -> dict:
    return {"ln2": _LE, "wi_gate": _LE + ("mlp",), "wi_up": _LE + ("mlp",),
            "wo_mlp": _LM + ("embed",)}


def _moe_axes(cfg: ModelConfig) -> dict:
    p = {"ln2": _LE, "router": _LE + ("experts",),
         "eg": ("layers", "experts", "embed", "mlp"),
         "eu": ("layers", "experts", "embed", "mlp"),
         "ed": ("layers", "experts", "mlp", "embed")}
    if cfg.n_shared:
        p.update(sg=_LE + ("mlp",), su=_LE + ("mlp",), sd=_LM + ("embed",))
    return p


def _ssm_axes(cfg: ModelConfig) -> dict:
    heads = ("layers", "heads")
    return {"ln1": _LE, "in_proj": _LE + ("mlp",),
            "conv_w": ("layers", "conv", "mlp"), "A_log": heads,
            "Dskip": heads, "dt_bias": heads, "ssm_norm": _LM,
            "out_proj": _LM + ("embed",)}


def _rec_axes(cfg: ModelConfig) -> dict:
    return {"ln1": _LE, "wx": _LE + ("mlp",), "wgate": _LE + ("mlp",),
            "conv": ("layers", "conv", "mlp"), "w_input": _LM + ("heads",),
            "w_rec": _LM + ("heads",), "lam": _LM, "wy": _LM + ("embed",)}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in a tree of ``init_params``'s
    structure: the axes the reference boxes each leaf with
    (``repro.models.common.Param``), which ``dist.sharding.spec_for`` maps
    to mesh axes."""
    axes = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}
    if not cfg.tie_embed:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.frontend:
        axes["front_proj"] = ("front", "embed")
    if cfg.family in ("dense", "encoder", "vlm"):
        axes["blocks"] = {**_attn_axes(cfg), **_mlp_axes(cfg)}
    elif cfg.family == "moe":
        axes["blocks"] = {**_attn_axes(cfg), **_moe_axes(cfg)}
    elif cfg.family == "ssm":
        axes["blocks"] = _ssm_axes(cfg)
    elif cfg.family == "hybrid":
        rec = {**_rec_axes(cfg), **_mlp_axes(cfg)}
        axes["blocks"] = {"rec1": rec, "rec2": dict(rec),
                          "attn": {**_attn_axes(cfg), **_mlp_axes(cfg)}}
        if cfg.n_layers % 3:
            axes["tail"] = dict(rec)
    else:
        raise ValueError(cfg.family)
    return axes


# ===========================================================================
# Blocks
# ===========================================================================

def _qkv(cfg: ModelConfig, x, blk, sin, cos, annotate: bool = False):
    """Normed input -> roped q (B,S,H,hd), k, v (B,S,KH,hd) in x's dtype;
    ``annotate`` lays the projections out over heads, as the reference's
    forward does (its decode does not)."""
    b, s, d = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    xn = rms_norm(x, blk["ln1"])
    q = (xn @ blk["wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = (xn @ blk["wk"].reshape(d, kh * hd)).view(b, s, kh, hd)
    v = (xn @ blk["wv"].reshape(d, kh * hd)).view(b, s, kh, hd)
    if annotate:
        q = shard(q, ("act_batch", None, "act_heads", None))
        k = shard(k, ("act_batch", None, "act_kv", None))
        v = shard(v, ("act_batch", None, "act_kv", None))
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
    x = shard(x, ("act_batch", None, None))
    q, k, v = _qkv(cfg, x, blk, sin, cos, annotate=True)
    att = gqa_attention(q, k, v, causal=cfg.causal, window=window,
                        chunk=cfg.attn_chunk)
    return _attn_out(cfg, x, att, blk), (k, v)


def _mlp_fwd(cfg: ModelConfig, x, blk):
    xn = rms_norm(x, blk["ln2"])
    hgate = F.silu(xn @ blk["wi_gate"]) * (xn @ blk["wi_up"])
    hgate = shard(hgate, ("act_batch", None, "act_mlp"))
    return x + hgate @ blk["wo_mlp"]


def _moe_fwd(cfg: ModelConfig, x, blk):
    """Under a mesh (``dist.ctx.use_mesh``) with ``cfg.moe_local_dispatch``,
    the tokens are grouped per data shard, ``rows = pod x data`` (1 when
    that does not divide them), as in the reference; else ``rows = 1``."""
    b, s, d = x.shape
    mesh = current_mesh()
    rows = 1
    if mesh is not None and cfg.moe_local_dispatch:
        rows = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    xn = rms_norm(x, blk["ln2"]).reshape(b * s, d)
    y, aux = moe_ffn(xn, blk["router"], blk["eg"], blk["eu"], blk["ed"],
                     blk.get("sg"), blk.get("su"), blk.get("sd"),
                     top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                     rows=rows if (b * s) % rows == 0 else 1)
    return x + y.reshape(b, s, d), aux


def _ssm_split(cfg: ModelConfig, zxbcdt):
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return zxbcdt.split([di, di, gn, gn, cfg.ssm_heads], dim=-1)


def _ssm_out(cfg: ModelConfig, y, z, blk):
    return rms_norm(y * F.silu(z), blk["ssm_norm"]) @ blk["out_proj"]


def _ssm_fwd(cfg: ModelConfig, x, blk):
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_headdim
    b, s, _ = x.shape
    x = shard(x, ("act_batch", None, None))
    xn = rms_norm(x, blk["ln1"])
    z, xin, B, C, dt = _ssm_split(cfg, shard(
        xn @ blk["in_proj"], ("act_batch", None, "act_mlp")))
    conv_out = F.silu(rg.causal_conv1d(torch.cat([xin, B, C], -1),
                                       blk["conv_w"]))
    xin, B, C = conv_out.split([di, g * n, g * n], dim=-1)
    dt_a = F.softplus(dt.to(torch.float32) + blk["dt_bias"])
    y, _ = ssd.ssd_chunked(xin.reshape(b, s, h, p), dt_a,
                           -torch.exp(blk["A_log"]), B.reshape(b, s, g, n),
                           C.reshape(b, s, g, n), blk["Dskip"],
                           chunk=cfg.ssm_chunk)
    return x + _ssm_out(cfg, y.reshape(b, s, di), z, blk)


def _rec_fwd(cfg: ModelConfig, x, blk):
    x = shard(x, ("act_batch", None, None))
    xn = rms_norm(x, blk["ln1"])
    gate = F.gelu(xn @ blk["wgate"], approximate="tanh")   # jax.nn.gelu
    u = rg.causal_conv1d(xn @ blk["wx"], blk["conv"])
    y, _ = rg.rglru_scan(u, blk["w_input"], blk["w_rec"], blk["lam"])
    x = x + (gate * y) @ blk["wy"]
    return _mlp_fwd(cfg, x, blk)


def _requires_grad(tree) -> bool:
    return any(_requires_grad(v) if isinstance(v, dict) else v.requires_grad
               for v in tree.values())


def _remat(cfg: ModelConfig, fn, params):
    """``fn`` under ``cfg.remat``: with "block", grad enabled and a
    parameter that requires it, each call is checkpointed (non-reentrant),
    as the reference's ``_scan`` wraps its block in ``jax.checkpoint``;
    otherwise (serving) ``fn`` itself."""
    if cfg.remat == "block" and torch.is_grad_enabled() \
            and _requires_grad(params):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    return fn


def _logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embed else params["lm_head"]
    return shard(x @ head, ("act_batch", None, "act_vocab"))


# ===========================================================================
# Full forward (training / prefill)
# ===========================================================================

def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            frontend_feats=None, positions=None, return_cache: bool = False):
    """Training / prefill forward.  tokens: (B, S_text) int; frontend_feats: (B,
    S_front, F) audio or vision stub features (the encoder's input alone;
    prepended to the vlm's text).  Returns ``(logits (B, S, V), aux,
    caches)``: aux is the f32 sum of the MoE layers' auxiliary losses (0
    elsewhere); caches is ``(k, v)``, each stacked ``(L_attn, B, S, KH,
    hd)`` over the attention layers, when ``return_cache`` and the family
    has attention, else None."""
    x = shard(params["embed"][tokens], ("act_batch", None, None))
    if cfg.frontend:
        front = (frontend_feats @ params["front_proj"]).to(x.dtype)
        x = front if cfg.family == "encoder" else torch.cat([front, x], 1)
    s = x.shape[1]
    pos = (torch.arange(s, device=x.device) if positions is None
           else positions)
    sin, cos = rope(pos, cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    if cfg.family in _ATTN_FAMILIES:
        def block(x, blk):
            x, (k, v) = _attn_fwd(cfg, x, blk, sin, cos)
            if cfg.family == "moe":
                x, a = _moe_fwd(cfg, x, blk)
                return x, a, k, v
            return _mlp_fwd(cfg, x, blk), None, k, v

        block = _remat(cfg, block, params)
        for blk in _layers(params["blocks"], cfg.n_layers):
            x, a, k, v = block(x, blk)
            if a is not None:
                aux = aux + a
            if return_cache:
                ks.append(k)
                vs.append(v)
    elif cfg.family == "ssm":
        block = _remat(cfg, lambda x, blk: _ssm_fwd(cfg, x, blk), params)
        for blk in _layers(params["blocks"], cfg.n_layers):
            x = block(x, blk)
    elif cfg.family == "hybrid":
        def triple(x, b1, b2, b3):
            x = _rec_fwd(cfg, x, b1)
            x = _rec_fwd(cfg, x, b2)
            x, (k, v) = _attn_fwd(cfg, x, b3, sin, cos, window=cfg.window)
            return _mlp_fwd(cfg, x, b3), k, v

        triple = _remat(cfg, triple, params)
        nt = cfg.n_layers // 3
        bl = params["blocks"]
        for b1, b2, b3 in zip(_layers(bl["rec1"], nt), _layers(bl["rec2"], nt),
                              _layers(bl["attn"], nt)):
            x, k, v = triple(x, b1, b2, b3)
            if return_cache:
                ks.append(k)
                vs.append(v)
        if "tail" in params:
            for blk in _layers(params["tail"], cfg.n_layers % 3):
                x = _rec_fwd(cfg, x, blk)
    else:
        raise ValueError(cfg.family)
    caches = (torch.stack(ks), torch.stack(vs)) if ks else None
    return _logits(cfg, params, x), aux, caches


# ===========================================================================
# Decode (single-token, stateful)
# ===========================================================================

def init_decode_state(cfg: ModelConfig, batch: int, smax: int,
                      device: str | torch.device = "cuda") -> dict:
    """Zero-filled decode state with the reference's keys, shapes and
    dtypes: the attention caches ``k``/``v`` (a ring of ``min(window,
    smax)`` rows in the hybrid), the SSM state and conv tails, the RG-LRU
    states ``h*`` and conv tails ``c*``.  Raises ``ValueError`` for the
    encoder, which has no decode state."""
    L, hd, kh = cfg.n_layers, cfg.hd, cfg.n_kv
    bf, f32 = torch.bfloat16, torch.float32

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": zeros((L, batch, smax, kh, hd), bf),
                "v": zeros((L, batch, smax, kh, hd), bf)}
    if cfg.family == "ssm":
        h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        cd = cfg.d_inner + 2 * cfg.ssm_groups * n
        return {"ssm": zeros((L, batch, h, p, n), f32),
                "conv": zeros((L, batch, cfg.conv_width - 1, cd), bf)}
    if cfg.family == "hybrid":
        nt, rem = divmod(L, 3)
        w, r, cw = min(cfg.window, smax), cfg.rnn_width, cfg.conv_width - 1
        st = {"h1": zeros((nt, batch, r), f32),
              "h2": zeros((nt, batch, r), f32),
              "c1": zeros((nt, batch, cw, r), bf),
              "c2": zeros((nt, batch, cw, r), bf),
              "k": zeros((nt, batch, w, kh, hd), bf),
              "v": zeros((nt, batch, w, kh, hd), bf)}
        if rem:
            st["ht"] = zeros((rem, batch, r), f32)
            st["ct"] = zeros((rem, batch, cw, r), bf)
        return st
    raise ValueError(f"{cfg.family} has no decode state")


def _attn_decode(cfg: ModelConfig, x, blk, state_k, state_v, pos: int, sin,
                 cos, window: int = 0):
    """Writes this token's k/v row into ``state_k``/``state_v`` (one
    layer's cache views) in place, then attends over the valid rows: the
    first ``pos + 1`` of a dense cache (the last row is overwritten past
    its end, as in the reference), or, in a windowed ring of ``smax`` rows,
    row ``pos % smax`` and the ``min(pos + 1, smax)`` rows written."""
    q, k, v = _qkv(cfg, x, blk, sin, cos)
    smax = state_k.shape[1]
    slot = pos % smax if window else min(pos, smax - 1)
    state_k[:, slot] = k[:, 0]
    state_v[:, slot] = v[:, 0]
    length = min(pos + 1, smax) if window else pos + 1
    att = decode_attention(q, state_k, state_v, length)
    return _attn_out(cfg, x, att, blk)


def _ssm_decode(cfg: ModelConfig, x, blk, st_ssm, st_conv):
    """Updates ``st_ssm``/``st_conv`` (one layer's state views) in place."""
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    di, b = cfg.d_inner, x.shape[0]
    xn = rms_norm(x[:, 0, :], blk["ln1"])
    z, xin, B, C, dt = _ssm_split(cfg, xn @ blk["in_proj"])
    cy, tail = rg.conv1d_step(st_conv, torch.cat([xin, B, C], -1),
                              blk["conv_w"])
    st_conv.copy_(tail)
    xin, B, C = F.silu(cy).split([di, g * n, g * n], dim=-1)
    dt_a = F.softplus(dt.to(torch.float32) + blk["dt_bias"])
    y, state = ssd.ssd_decode_step(
        st_ssm, xin.reshape(b, h, p), dt_a, -torch.exp(blk["A_log"]),
        B.reshape(b, g, n), C.reshape(b, g, n), blk["Dskip"])
    st_ssm.copy_(state)
    return x + _ssm_out(cfg, y.reshape(b, di), z, blk)[:, None, :]


def _rec_decode(cfg: ModelConfig, x, blk, h_st, c_st):
    """Updates ``h_st``/``c_st`` (one layer's state views) in place."""
    xn = rms_norm(x[:, 0, :], blk["ln1"])
    gate = F.gelu(xn @ blk["wgate"], approximate="tanh")
    u, tail = rg.conv1d_step(c_st, xn @ blk["wx"], blk["conv"])
    c_st.copy_(tail)
    y, h = rg.rglru_step(h_st, u, blk["w_input"], blk["w_rec"], blk["lam"])
    h_st.copy_(h)
    x = x + ((gate * y.to(gate.dtype)) @ blk["wy"])[:, None, :]
    # the reference's recurrent decode writes its MLP out, unannotated
    xn = rms_norm(x, blk["ln2"])
    return x + swiglu(xn, blk["wi_gate"], blk["wi_up"], blk["wo_mlp"])


def decode_step(cfg: ModelConfig, params, state: dict, token: torch.Tensor,
                pos: int):
    """One decode step.  token: (B, 1) int; pos: the current length (int).
    Returns ``(logits (B, 1, V), state)``: unlike the reference, the state
    is updated in place (``state`` itself is returned), which saves copying
    the whole cache every token.  The vlm decodes text only, on the dense
    path, as the reference does."""
    pos = int(pos)
    x = params["embed"][token]
    sin, cos = rope(torch.full((1,), pos, device=x.device), cfg.hd,
                    cfg.rope_theta)
    if cfg.family in ("dense", "vlm", "moe"):
        for i, blk in enumerate(_layers(params["blocks"], cfg.n_layers)):
            x = _attn_decode(cfg, x, blk, state["k"][i], state["v"][i], pos,
                             sin, cos)
            if cfg.family == "moe":
                x, _ = _moe_fwd(cfg, x, blk)
            else:
                x = _mlp_fwd(cfg, x, blk)
    elif cfg.family == "ssm":
        for i, blk in enumerate(_layers(params["blocks"], cfg.n_layers)):
            x = _ssm_decode(cfg, x, blk, state["ssm"][i], state["conv"][i])
    elif cfg.family == "hybrid":
        nt = cfg.n_layers // 3
        bl = params["blocks"]
        for i, (b1, b2, b3) in enumerate(zip(_layers(bl["rec1"], nt),
                                             _layers(bl["rec2"], nt),
                                             _layers(bl["attn"], nt))):
            x = _rec_decode(cfg, x, b1, state["h1"][i], state["c1"][i])
            x = _rec_decode(cfg, x, b2, state["h2"][i], state["c2"][i])
            x = _attn_decode(cfg, x, b3, state["k"][i], state["v"][i], pos,
                             sin, cos, window=cfg.window)
            x = _mlp_fwd(cfg, x, b3)
        if "tail" in params:
            for i, blk in enumerate(_layers(params["tail"],
                                            cfg.n_layers % 3)):
                x = _rec_decode(cfg, x, blk, state["ht"][i], state["ct"][i])
    else:
        raise ValueError(cfg.family)
    return _logits(cfg, params, x), state
