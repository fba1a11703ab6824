"""Plain-torch oracle for flash attention (GQA-aware): the port's copy of
`repro.kernels.attention.ref.mha_ref`.

Its causal mask is `tril(ones(Sq, Skv), Skv - Sq)`, aligned to the
bottom-right corner. The flash kernel (`attention.flash_attention`, like the
reference's Pallas `_flash_kernel`) masks `k_pos <= q_pos` from the top-left,
so the two agree only where Sq == Skv (ROADMAP Queue 3, reference caveats).
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def mha_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q (B,H,Sq,D); k,v (B,Hkv,Skv,D) with H % Hkv == 0. f32 softmax."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale or D ** -0.5
    qg = q.reshape(B, Hkv, g, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((Sq, Skv), dtype=torch.bool,
                                     device=q.device), Skv - Sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
