"""Public wrappers of the flash-attention kernel (the port of
`repro.kernels.attention.ops`).

`mha(q, k, v, ...)` takes (B, H, S, D)/(B, Hkv, S, D) tensors;
`gqa_layout_attention` adapts the model's (B, S, K, G, D) layout so the
kernel drops into `attention_apply` when `attention_impl="pallas"`. PyTorch
runs eagerly, so there is nothing to jit and no `interpret` switch: the
device of the tensors picks the CUDA kernel or its plain version.
"""
from __future__ import annotations

from repro_torch.kernels.attention.attention import flash_attention
from repro_torch.kernels.attention.ref import mha_ref


def mha(q, k, v, *, causal: bool = True, block_q: int = 128,
        block_k: int = 128):
    return flash_attention(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)


def gqa_layout_attention(q5, k4, v4, *, causal: bool = True):
    """(B,S,K,G,D) q / (B,S,K,D) kv -> (B,S,K,G,D), via the flash kernel."""
    B, S, K, G, D = q5.shape
    q = q5.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, D)
    k = k4.permute(0, 2, 1, 3)
    v = v4.permute(0, 2, 1, 3)
    o = mha(q, k, v, causal=causal)
    return o.reshape(B, K, G, S, D).permute(0, 3, 1, 2, 4)


__all__ = ["mha", "gqa_layout_attention", "mha_ref"]
