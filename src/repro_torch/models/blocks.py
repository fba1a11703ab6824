"""Layer blocks of the dense family: param specs + apply fns.

The port of the dense-family part of `repro.models.blocks`: the attention
block (self-attention with no window, in the `train` (forward only),
`prefill` and `decode` modes, with the `dense`, `chunked` and `pallas`
implementations) and the dense MLP (`swiglu`, `sq_relu`, `gelu`). Weights
stay in the param dtype and are cast to the compute dtype at each use, as
the reference casts them (`.astype(x.dtype)`).

`attention_impl="pallas"` runs the flash-attention kernel K8
(`kernels.attention.ops.gqa_layout_attention`): on CUDA tensors the
hand-written kernel, on CPU tensors its plain version. Cross-attention and
windowed attention (encdec, hybrid), MoE, mamba and RG-LRU blocks raise
`NotImplementedError` naming the slice that brings them (ROADMAP Queue 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import HeadLayout
from repro_torch.kernels.attention.ops import gqa_layout_attention
from repro_torch.models import layers as L
from repro_torch.pspec import ParamSpec

Params = Dict[str, Any]

IMPLS = ("dense", "chunked", "pallas")
LATER = {"flash": "G2 (training: the custom-VJP flash path)",
         "skip_core": "G2 (the dry run's phase-attribution lowering)",
         "local": "G1b (the hybrid family's sliding window)"}


@dataclass
class Ctx:
    """Per-call context: positions, mode, cache slot. Sharding rules and
    meshes wait for slice G2."""
    cfg: ArchConfig
    layout: HeadLayout
    positions: Any = None        # (B, S)
    mode: str = "train"          # train | prefill | decode
    cache: Any = None            # layer cache dict at decode
    pos: Any = None              # (B,) decode position
    causal: bool = True
    new_cache: Any = None        # out: updated layer cache


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def attention_specs(cfg: ArchConfig, layout: HeadLayout, dt: str) -> Params:
    E, D = cfg.d_model, cfg.head_dim
    Hs, Ks = layout.n_q_stored, layout.n_kv_stored
    p: Params = {
        "wq": ParamSpec((E, Hs, D), ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((E, Ks, D), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamSpec((E, Ks, D), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamSpec((Hs, D, E), ("heads", "head_dim", "embed"), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((Hs, D), ("heads", "head_dim"), dt, "zeros")
        p["bk"] = ParamSpec((Ks, D), ("kv_heads", "head_dim"), dt, "zeros")
        p["bv"] = ParamSpec((Ks, D), ("kv_heads", "head_dim"), dt, "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((D,), (None,), dt, "ones")
        p["k_norm"] = ParamSpec((D,), (None,), dt, "ones")
    return p


def _q_head_mask(layout: HeadLayout, dtype, device):
    if layout.n_q_stored == layout.n_q:
        return None
    return torch.as_tensor(layout.q_head_mask(), dtype=dtype,
                           device=device).reshape(layout.n_kv_stored,
                                                  layout.q_per_group)


def _project(x, w, b=None):
    """x (B,S,E) @ w (E,H,D) in x's dtype, plus the bias."""
    out = torch.einsum("bse,ehd->bshd", x, w.to(x.dtype))
    return out if b is None else out + b.to(x.dtype)


def _write_cache(cache, new, pos):
    """cache[b, pos[b]] = new[b, 0], in place. The reference's
    `dynamic_update_slice` clamps an out-of-range position; here the caller
    (`model.decode_step`) has refused one, so none reaches this write."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos] = new[:, 0].to(cache.dtype)
    return cache


def attention_apply(p: Params, x, ctx: Ctx, *, kv_x=None, window: int = 0,
                    use_rope: Optional[bool] = None,
                    is_cross: bool = False):
    """x: (B, S, E). Self-attention; at decode against the layer's cache,
    which it updates in place (the reference returns a new one)."""
    if kv_x is not None or is_cross:
        raise NotImplementedError("cross-attention (the encdec family) "
                                  "waits for slice G1b (ROADMAP Queue 1)")
    if window:
        raise NotImplementedError("windowed attention (the hybrid family) "
                                  "waits for slice G1b (ROADMAP Queue 1)")
    cfg, lo = ctx.cfg, ctx.layout
    B, S, E = x.shape
    D = cfg.head_dim
    impl = cfg.attention_impl
    if impl in LATER:
        raise NotImplementedError(f"attention_impl={impl!r} waits for slice "
                                  f"{LATER[impl]}")
    if impl not in IMPLS:
        raise ValueError(f"unknown attention_impl {impl!r}")

    q = _project(x, p["wq"], p.get("bq"))
    q = q.reshape(B, S, lo.n_kv_stored, lo.q_per_group, D)
    use_rope = cfg.pos in ("rope", "mrope") if use_rope is None else use_rope
    mrope = cfg.pos == "mrope"
    k = _project(x, p["wk"], p.get("bk"))
    v = _project(x, p["wv"], p.get("bv"))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    scale = 1.0 / math.sqrt(D)

    if ctx.mode == "decode":
        if use_rope:
            pos_q = ctx.pos[:, None]  # (B,1)
            q = L.apply_rope(q, pos_q, cfg.rope_theta, mrope)
            k = L.apply_rope(k, pos_q, cfg.rope_theta, mrope)
        kc = _write_cache(ctx.cache["k"], k, ctx.pos)
        vc = _write_cache(ctx.cache["v"], v, ctx.pos)
        ctx.new_cache = {"k": kc, "v": vc}
        out = L.attn_decode(q, kc, vc, pos=ctx.pos, scale=scale)
    else:
        if use_rope:
            q = L.apply_rope(q, ctx.positions, cfg.rope_theta, mrope)
            k = L.apply_rope(k, ctx.positions, cfg.rope_theta, mrope)
        q_pos = kv_pos = torch.arange(S, device=x.device)
        if ctx.mode == "prefill":
            ctx.new_cache = {"k": k, "v": v}
        if impl == "dense" or not ctx.causal:
            out = L.attn_dense(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               causal=ctx.causal, scale=scale)
        elif impl == "pallas":
            # the flash kernel K8 (its plain version on CPU tensors);
            # forward only, as in the reference
            out = gqa_layout_attention(q, k, v, causal=True)
        else:
            out = L.attn_chunked(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                 causal=True, scale=scale,
                                 chunk=cfg.attn_chunk)

    mask = _q_head_mask(lo, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, :, None]
    out = out.reshape(B, out.shape[1], lo.n_q_stored, D)
    return torch.einsum("bshd,hde->bse", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ArchConfig, dt: str, d_ff: Optional[int] = None,
              bias: bool = False) -> Params:
    E, F_ = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": ParamSpec((E, F_), ("embed", "ffn"), dt),
         "wo": ParamSpec((F_, E), ("ffn", "embed"), dt)}
    if cfg.mlp == "swiglu":
        p["wg"] = ParamSpec((E, F_), ("embed", "ffn"), dt)
    if bias:
        p["bi"] = ParamSpec((F_,), (None,), dt, "zeros")
        p["bo"] = ParamSpec((E,), (None,), dt, "zeros")
    return p


def mlp_apply(p: Params, x, ctx: Ctx):
    cfg = ctx.cfg
    cast = lambda w: w.to(x.dtype)  # noqa: E731
    if cfg.mlp == "swiglu":
        h = F.silu(x @ cast(p["wg"])) * (x @ cast(p["wi"]))
    elif cfg.mlp == "sq_relu":
        h = torch.square(F.relu(x @ cast(p["wi"])))
    else:  # gelu; jax.nn.gelu defaults to the tanh approximation
        h = x @ cast(p["wi"])
        if "bi" in p:
            h = h + cast(p["bi"])
        h = F.gelu(h, approximate="tanh")
    out = h @ cast(p["wo"])
    if "bo" in p:
        out = out + cast(p["bo"])
    return out
