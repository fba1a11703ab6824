"""Layer blocks of the dense and ssm families: param specs + apply fns.

The port of the dense-family and ssm-family parts of `repro.models.blocks`:
the attention block (self-attention with no window, in the `train` (forward
only), `prefill` and `decode` modes, with the `dense`, `chunked` and
`pallas` implementations), the dense MLP (`swiglu`, `sq_relu`, `gelu`) and
the Mamba-1 block (`mamba_apply`, in all three modes). Weights stay in the
param dtype and are cast to the compute dtype at each use, as the reference
casts them (`.astype(x.dtype)`).

`attention_impl="pallas"` runs the flash-attention kernel K8
(`kernels.attention.ops.gqa_layout_attention`) in attention blocks and the
selective-scan kernel K9 (`kernels.ssm.ops.mamba_scan`) in mamba blocks at
train and prefill: on CUDA tensors the hand-written kernels, on CPU tensors
their plain versions. Cross-attention and windowed attention (encdec,
hybrid), MoE and RG-LRU blocks raise `NotImplementedError` naming the slice
that brings them (ROADMAP Queue 1).
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
from repro_torch.kernels.ssm.ops import mamba_scan
from repro_torch.models import layers as L
from repro_torch.pspec import ParamSpec

Params = Dict[str, Any]

IMPLS = ("dense", "chunked", "pallas")
LATER = {"flash": "G2 (training: the custom-VJP flash path)",
         "skip_core": "G2 (the dry run's phase-attribution lowering)",
         "local": "G1c (the hybrid family's sliding window)"}


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
                                  "waits for slice G1c (ROADMAP Queue 1)")
    if window:
        raise NotImplementedError("windowed attention (the hybrid family) "
                                  "waits for slice G1c (ROADMAP Queue 1)")
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


# ---------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba)
# ---------------------------------------------------------------------------


def mamba_specs(cfg: ArchConfig, dt: str) -> Params:
    E, Di = cfg.d_model, cfg.d_inner
    N, K, R = cfg.ssm.d_state, cfg.ssm.conv_k, cfg.ssm.dt_rank
    return {
        "in_proj": ParamSpec((E, 2 * Di), ("embed", "ffn"), dt),
        "conv_w": ParamSpec((K, Di), ("conv", "ffn"), dt),
        "conv_b": ParamSpec((Di,), ("ffn",), dt, "zeros"),
        "x_proj": ParamSpec((Di, R + 2 * N), ("ffn", None), dt),
        "dt_proj": ParamSpec((R, Di), ("lowrank", "ffn"), dt),
        "dt_bias": ParamSpec((Di,), ("ffn",), dt, "zeros"),
        "A_log": ParamSpec((Di, N), ("ffn", "state"), dt, "ones"),
        "D": ParamSpec((Di,), ("ffn",), dt, "ones"),
        "out_proj": ParamSpec((Di, E), ("ffn", "embed"), dt),
    }


def _softplus(x):
    """`jax.nn.softplus`, i.e. logaddexp(x, 0). `F.softplus` returns x
    itself above its threshold of 20, which this does not."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv. x (B,S,C), w (K,C). Returns y, new_cache
    (B,K-1,C): the last K-1 rows of the padded input, zero padding
    included when S < K-1. The taps are summed in order from 0, as the
    reference's Python `sum` adds them."""
    K = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    new_cache = xp[:, -(K - 1):] if K > 1 else pad
    return y + b.to(x.dtype), new_cache


def scan_chunk_for(S: int, scan_chunk: int) -> int:
    """The chunk `_mamba_chunk_scan` runs a length-S sequence in:
    S // max(S // scan_chunk, 1). Raises ValueError where that does not
    divide S (the reference's `S % n` assertion; e.g. S = 513 at
    scan_chunk 256)."""
    n = max(S // scan_chunk, 1)
    if S % n:
        raise ValueError(f"a sequence of {S} tokens does not split into "
                         f"{n} equal chunks of about scan_chunk="
                         f"{scan_chunk}; the reference's chunked scan "
                         f"refuses it too")
    return S // n


def _associative_scan(a, b):
    """Prefix composition of h -> a*h + b along axis 1 (the reference's
    `lax.associative_scan(combine, (a, b), axis=1)`), in log2(length)
    rounds: returns (pa, pb) with h_t = pa_t * h_(-1) + pb_t."""
    step = 1
    while step < a.shape[1]:
        pa, pb = a.clone(), b.clone()
        pa[:, step:] = a[:, step:] * a[:, :-step]
        pb[:, step:] = a[:, step:] * b[:, :-step] + b[:, step:]
        a, b, step = pa, pb, 2 * step
    return a, b


def _scan_dt(dt_r, p: Params):
    """dt = softplus(dt_r @ dt_proj + dt_bias), all in f32, as the
    reference's chunked scan computes it for prefill."""
    return _softplus(dt_r.float() @ p["dt_proj"].float()
                     + p["dt_bias"].float())


def _mamba_chunk_scan(xc, dt_r, Bmat, Cmat, p: Params, h0, *, chunk: int):
    """Selective scan over sequence chunks (the reference's jnp chunked
    scan): per chunk, dt in f32 (`_scan_dt`), the discretised (a, bu) of
    shape (B, chunk, Di, N), an associative scan and the C-projection. The
    chunks stream in the compute dtype and are promoted to f32 one at a
    time.

    Returns (y (B,S,Di) f32, h_final (B,Di,N) f32)."""
    S = xc.shape[1]
    chunk = scan_chunk_for(S, chunk)
    A = -torch.exp(p["A_log"].float())                     # (Di,N)
    h, ys = h0, []
    for j in range(S // chunk):
        cut = slice(j * chunk, (j + 1) * chunk)
        xj, bj, cj = (t[:, cut].float() for t in (xc, Bmat, Cmat))
        dt = _scan_dt(dt_r[:, cut], p)                     # (B,chunk,Di)
        a = torch.exp(dt[..., None] * A)                   # (B,chunk,Di,N)
        bu = (dt * xj)[..., None] * bj[..., None, :]
        pa, pb = _associative_scan(a, bu)
        h_all = pa * h[:, None] + pb                       # (B,chunk,Di,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, cj))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def _mamba_kernel_scan(xc, dt_r, Bmat, Cmat, p: Params, h0, *, chunk: int):
    """The same function through K9 (`attention_impl="pallas"`): dt in f32
    as `_mamba_chunk_scan` computes it, then `mamba_scan` with the chunk
    `_mamba_chunk_scan` would use. xc, Bmat and Cmat stay in the compute
    dtype; the kernel promotes them.

    Returns (y (B,S,Di) f32, h_final (B,Di,N) f32)."""
    chunk = scan_chunk_for(xc.shape[1], chunk)
    A = -torch.exp(p["A_log"].float())
    return mamba_scan(xc, _scan_dt(dt_r, p), Bmat, Cmat, A, h0, chunk=chunk)


def mamba_apply(p: Params, x, ctx: Ctx):
    """Mamba-1 selective SSM. Returns block output (B,S,E). At decode it
    updates the layer's `conv` and `state` caches in place (the reference
    returns new ones)."""
    cfg = ctx.cfg
    N, R = cfg.ssm.d_state, cfg.ssm.dt_rank
    Di = cfg.d_inner
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = torch.split(xz, Di, dim=-1)

    conv_cache = ctx.cache.get("conv") if ctx.mode == "decode" else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_cache)
    xc = F.silu(xc)

    proj = xc @ p["x_proj"].to(x.dtype)
    dt_r, Bmat, Cmat = torch.split(proj, [R, N, N], dim=-1)

    if ctx.mode == "decode":
        # dt in the compute dtype, then f32 (the reference's decode step)
        dt = _softplus(dt_r @ p["dt_proj"].to(x.dtype)
                       + p["dt_bias"].to(x.dtype)).float()
        A = -torch.exp(p["A_log"].float())
        a = torch.exp(dt[..., None] * A)                       # (B,1,Di,N)
        bu = ((dt * xc.float())[..., None]
              * Bmat.float()[..., None, :])
        state = ctx.cache["state"]
        h = a[:, 0] * state.float() + bu[:, 0]
        ctx.cache["conv"].copy_(new_conv)
        state.copy_(h.to(state.dtype))
        ctx.new_cache = ctx.cache
        y = torch.einsum("bdn,bsn->bsd", h, Cmat.float()).to(x.dtype)
    elif cfg.attention_impl == "skip_core":
        raise NotImplementedError(f"attention_impl='skip_core' waits for "
                                  f"slice {LATER['skip_core']}")
    else:
        scan = _mamba_kernel_scan if cfg.attention_impl == "pallas" else \
            _mamba_chunk_scan
        h0 = torch.zeros((x.shape[0], Di, N), dtype=torch.float32,
                         device=x.device)
        y, h = scan(xc, dt_r, Bmat, Cmat, p, h0, chunk=cfg.scan_chunk)
        y = y.to(x.dtype)
        if ctx.mode == "prefill":
            ctx.new_cache = {"conv": new_conv, "state": h.to(x.dtype)}

    y = y + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)
