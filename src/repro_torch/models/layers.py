"""Shared neural layers: norms, RoPE / M-RoPE, GQA attention.

The port of the functions of `repro.models.layers` that the model paths
call. Shape conventions are the reference's:

  x            : (B, S, E)           activations, compute dtype (bf16)
  q            : (B, S, K, G, D)     K = stored kv groups, G = q heads/group
  k, v         : (B, S, K, D)
  decode cache : k/v (B, L, K, D) ring/linear buffers

Attention implementations: `attn_dense` (full S x S logits, the
reference), `attn_chunked` (online softmax streaming over KV chunks; a
Python loop where the reference runs `lax.scan`) and `attn_local` (the
hybrid family's sliding window, block-banded, linear in S). All softmax
statistics are f32, and the rounding points are the reference's:
`rms_norm` rounds to x's dtype before the weight multiply, `apply_rope`
builds cos and sin in f32 and rounds them to x's dtype, `attn_dense` and
`attn_local` round p to v's dtype before PV while `attn_chunked` keeps p
in f32.

`attn_flash` is the training path's attention: an autograd Function whose
forward streams the KV chunks as `attn_chunked` does and saves only (q, k,
v, out, logsumexp), and whose backward recomputes each chunk's
probabilities (the reference's custom VJP, plain PyTorch: the reference
runs it outside any Pallas kernel).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -2.0 ** 30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * w.to(dt) + b.to(dt)


def softcap(logits, cap: float):
    if not cap:
        return logits
    return torch.tanh(logits / cap) * cap


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Split the head_dim//2 frequency slots into (t, h, w) sections.

    Uses qwen2-vl's 1/4:3/8:3/8 proportions (16:24:24 at head_dim 128).
    """
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return t, h, half - t - h


def apply_rope(x, positions, theta: float, mrope: bool = False):
    """x: (B, S, K, G?, D) with positions (B, S) int or (B, S, 3) for
    M-RoPE; rope over the trailing D dim, broadcast over the head dims.
    Under M-RoPE each frequency slot reads the t, h or w position of its
    section (`mrope_sections`)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                  # (half,)
    if mrope:
        # the section of each slot, built on the host (a traced
        # repeat_interleave's length would depend on its values)
        sec = torch.as_tensor(np.repeat(np.arange(3), mrope_sections(d)),
                              device=x.device)                 # (half,)
        pos = positions.float()[..., sec]                     # (B, S, half)
    else:
        pos = positions.float()[..., None]                    # (B, S, 1)
    angles = pos * freqs                                      # (B, S, half)
    for _ in range(x.ndim - 3):
        angles = angles[..., None, :]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sincos_positions(seq_len: int, d_model: int) -> np.ndarray:
    """Classic transformer sinusoidal table (whisper encoder)."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = 1.0 / (10000 ** (dim / (d_model // 2)))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def _causal_mask(q_pos, kv_pos):
    """(Sq, Skv) mask, True where kv may be attended."""
    return kv_pos[None, :] <= q_pos[:, None]


def _masked(logits, mask):
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def attn_dense(q, k, v, *, q_pos, kv_pos, causal: bool, scale: float):
    """Reference attention. q (B,Sq,K,G,D), k/v (B,Skv,K,D). Logits in f32
    (exact products of the inputs, f32 sums), p rounded to v's dtype."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if causal:
        logits = _masked(logits, _causal_mask(q_pos, kv_pos))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def attn_chunked(q, k, v, *, q_pos, kv_pos, causal: bool, scale: float,
                 chunk: int):
    """Online-softmax streaming attention over KV chunks (flash-style), p
    kept in f32; the reference's `lax.scan` as a Python loop."""
    B, Skv, K, D = k.shape
    Sq, G = q.shape[1], q.shape[3]
    n = max(Skv // chunk, 1)
    chunk = Skv // n
    if Skv % n:
        raise ValueError(f"attn_chunked: {Skv} keys do not split into {n} "
                         f"chunks of {chunk} (the reference asserts this)")
    qf = q.float()
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, K, G, D), dtype=torch.float32, device=q.device)
    for j in range(n):
        sl = slice(j * chunk, (j + 1) * chunk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, k[:, sl].float()) * scale
        if causal:
            s = _masked(s, _causal_mask(q_pos, kv_pos[sl]))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, sl].float())
        acc = acc * torch.movedim(corr, -1, 1)[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(torch.movedim(l, -1, 1)[..., None], 1e-20)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Flash attention with a hand-written backward (the reference's custom VJP)
# ---------------------------------------------------------------------------
#
# `attn_chunked` under autograd saves every chunk's logits and
# probabilities for the backward pass. Flash backward saves only (q, k, v,
# out, logsumexp) and recomputes each chunk's probabilities: compute traded
# for data movement.


def _flash_chunks(Skv: int, chunk: int) -> int:
    n = max(Skv // chunk, 1)
    if Skv % n:
        raise ValueError(f"attn_flash: {Skv} keys do not split into {n} "
                         f"equal chunks of about {chunk}")
    return Skv // n


def _flash_fwd_impl(q, k, v, q_pos, kv_pos, causal, scale, chunk):
    """Returns (out in q's dtype, lse (B,K,G,Sq) f32)."""
    B, Skv, K, D = k.shape
    Sq, G = q.shape[1], q.shape[3]
    c = _flash_chunks(Skv, chunk)
    qf = q.float()
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, K, G, D), dtype=torch.float32, device=q.device)
    for j in range(Skv // c):
        sl = slice(j * c, (j + 1) * c)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, k[:, sl].float()) * scale
        if causal:
            s = _masked(s, _causal_mask(q_pos, kv_pos[sl]))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, sl].float())
        acc = acc * torch.movedim(corr, -1, 1)[..., None] + pv
        m = m_new
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = acc / torch.clamp_min(torch.movedim(l, -1, 1)[..., None], 1e-30)
    return out.to(q.dtype), lse


class _AttnFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, scale, chunk):
        out, lse = _flash_fwd_impl(q, k, v, q_pos, kv_pos, causal, scale,
                                   chunk)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.causal, ctx.scale, ctx.chunk = causal, scale, chunk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        Skv = k.shape[1]
        c = _flash_chunks(Skv, ctx.chunk)
        qf = q.float()
        dof = do.float()
        # rowwise D_i = sum_d dO * O
        drow = torch.einsum("bqkgd,bqkgd->bkgq", dof, out.float())
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for j in range(Skv // c):
            sl = slice(j * c, (j + 1) * c)
            kj, vj = k[:, sl].float(), v[:, sl].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", qf, kj) * scale
            if causal:
                s = _masked(s, _causal_mask(q_pos, kv_pos[sl]))
            p = torch.exp(s - lse[..., None])                 # (B,K,G,Sq,C)
            dvs.append(torch.einsum("bkgqs,bqkgd->bskd", p, dof))
            dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vj)
            ds = p * (dp - drow[..., None]) * scale
            dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds, kj)
            dks.append(torch.einsum("bkgqs,bqkgd->bskd", ds, qf))
        dk = torch.cat(dks, dim=1)
        dv = torch.cat(dvs, dim=1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def attn_flash(q, k, v, q_pos, kv_pos, causal: bool, scale: float,
               chunk: int):
    """Flash attention for training: q (B,Sq,K,G,D), k/v (B,Skv,K,D) ->
    (B,Sq,K,G,D) in q's dtype. The forward is `attn_chunked`'s online
    softmax (p in f32); the backward recomputes each chunk's p from the
    saved logsumexp and accumulates dq, dk, dv in f32, as the reference's
    `_attn_flash_bwd` does."""
    return _AttnFlash.apply(q, k, v, q_pos, kv_pos, causal, scale, chunk)


def attn_local(q, k, v, *, q_pos, kv_pos, scale: float, window: int):
    """Sliding-window causal attention, block-banded (linear in S).

    Each block of `window` queries attends to its own block and the previous
    one under the (causal & distance < window) mask — exact sliding window.
    S is padded to a block multiple (the pads sit after every real token,
    so the causal mask hides them) and block 0's "previous block", which is
    padding, is masked by global-position validity. Logits in f32, p
    rounded to v's dtype, as `attn_dense`."""
    B, S, K, D = k.shape
    G = q.shape[3]
    W = min(window, S)
    S0 = S
    if S % W:
        pad = W - S % W
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        S = S + pad
    n = S // W
    qb = q.reshape(B, n, W, K, G, D)
    kb = k.reshape(B, n, W, K, D)
    vb = v.reshape(B, n, W, K, D)
    k_prev = F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    v_prev = F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    k2 = torch.cat([k_prev, kb], dim=2)  # (B, n, 2W, K, D)
    v2 = torch.cat([v_prev, vb], dim=2)
    logits = torch.einsum("bnqkgd,bnskd->bnkgqs", qb.float(),
                          k2.float()) * scale
    qp = torch.arange(W, device=q.device)
    kp = torch.arange(2 * W, device=q.device) - W
    rel = qp[:, None] - kp[None, :]
    band = (rel >= 0) & (rel < W)                              # (W, 2W)
    valid = (torch.arange(n, device=q.device)[:, None, None] * W
             + kp[None, None, :]) >= 0
    mask_all = band[None] & valid                              # (n, W, 2W)
    logits = _masked(logits, mask_all[None, :, None, None])
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnkgqs,bnskd->bnqkgd", p.to(v.dtype), v2)
    return out.reshape(B, S, K, G, D)[:, :S0]


def attn_decode(q, k_cache, v_cache, *, pos, scale: float, window: int = 0):
    """Single-token decode vs a (B, L, K, D) cache. pos: (B,) current index."""
    B, L, K, D = k_cache.shape
    idx = torch.arange(L, device=q.device)
    mask = idx[None, :] <= pos[:, None]                      # (B, L)
    if window:
        mask = mask & (pos[:, None] - idx[None, :] < window)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(),
                          k_cache.float()) * scale
    logits = _masked(logits, mask[:, None, None, None, :])
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.to(q.dtype)


def gqa_reshape_q(q_flat, layout):
    """(B, S, Hs*D) -> (B, S, K, G, D)."""
    B, S, _ = q_flat.shape
    return q_flat.reshape(B, S, layout.n_kv_stored, layout.q_per_group, -1)
