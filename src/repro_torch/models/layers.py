"""Shared neural layers of the dense family: norms, RoPE, GQA attention.

The port of the functions of `repro.models.layers` that the dense model
path calls. Shape conventions are the reference's:

  x            : (B, S, E)           activations, compute dtype (bf16)
  q            : (B, S, K, G, D)     K = stored kv groups, G = q heads/group
  k, v         : (B, S, K, D)
  decode cache : k/v (B, L, K, D) linear buffers

Attention implementations: `attn_dense` (full S x S logits, the reference)
and `attn_chunked` (online softmax streaming over KV chunks; a Python loop
where the reference runs `lax.scan`). All softmax statistics are f32, and
the rounding points are the reference's: `rms_norm` rounds to x's dtype
before the weight multiply, `apply_rope` builds cos and sin in f32 and
rounds them to x's dtype, `attn_dense` rounds p to v's dtype before PV
while `attn_chunked` keeps p in f32.

M-RoPE, `attn_flash` (the custom-VJP training path) and `attn_local` (the
hybrid family's sliding window) wait for their slices (ROADMAP Queue 1,
G1c and G2).
"""
from __future__ import annotations

import numpy as np
import torch

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


def apply_rope(x, positions, theta: float, mrope: bool = False):
    """x: (B, S, K, G?, D) with positions (B, S) int; rope over the trailing
    D dim, broadcast over the head dims."""
    if mrope:
        raise NotImplementedError("M-RoPE (the vlm family) waits for slice "
                                  "G1c (ROADMAP Queue 1)")
    d = x.shape[-1]
    half = d // 2
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                  # (half,)
    angles = positions.float()[..., None] * freqs             # (B, S, half)
    for _ in range(x.ndim - 3):
        angles = angles[..., None, :]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


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


def attn_decode(q, k_cache, v_cache, *, pos, scale: float):
    """Single-token decode vs a (B, L, K, D) cache. pos: (B,) current index."""
    B, L, K, D = k_cache.shape
    idx = torch.arange(L, device=q.device)
    mask = idx[None, :] <= pos[:, None]                      # (B, L)
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
