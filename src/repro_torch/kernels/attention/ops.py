"""Public wrappers of the flash-attention kernel (the port of
`repro.kernels.attention.ops`).

`mha(q, k, v, ...)` takes (B, H, S, D)/(B, Hkv, S, D) tensors;
`gqa_layout_attention` hands the model's (B, S, K, G, D) layout to the
kernel as strided views, so it drops into `attention_apply` when
`attention_impl="pallas"` without a copy. PyTorch
runs eagerly, so there is nothing to jit and no `interpret` switch: the
device of the tensors picks the CUDA kernel or its plain version.

On DTensors (the model under a `DeviceMesh`) `gqa_layout_attention` runs
the kernel through `local_map` (`sharding.per_group`): each rank launches
it on its own block, the kv groups (dim 2) split over the mesh, and the
output is placed as q is. `repro_torch::flash_attention` writes into a
mutated `out` and returns nothing, a schema no DTensor sharding rule fits.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import per_group
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.attention.attention import flash_attention
from repro_torch.kernels.attention.ref import mha_ref


def mha(q, k, v, *, causal: bool = True, block_q: int = 128,
        block_k: int = 128):
    return flash_attention(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)


def gqa_layout_attention(q5, k4, v4, *, causal: bool = True):
    """(B,S,K,G,D) q / (B,S,K,D) kv -> (B,S,K,G,D), via the flash kernel.

    q, k and v reach the kernel as (B, H, S, D) / (B, K, S, D) views of the
    model's tensors, and the kernel writes a (B, H, S, D) view of a
    contiguous (B, S, K, G, D) output: no copy of q, k, v or o on the card
    (the kernel takes its operands by their strides). Forward-only, as
    the reference's route: raises RuntimeError under grad.

    DTensor operands must share their placements on the batch and group
    dims (0 and 2) and leave the sequence, group size and head dims whole:
    each rank then attends its own groups, and the output is a DTensor
    placed as q."""
    refuse_grad("gqa_layout_attention (K8)", q5, k4, v4)
    return per_group(lambda q, k, v: _gqa_plain(q, k, v, causal), q5, k4,
                     v4)


def _gqa_plain(q5, k4, v4, causal: bool):
    B, S, K, G, D = q5.shape
    q = q5.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, D)
    k = k4.permute(0, 2, 1, 3)
    v = v4.permute(0, 2, 1, 3)
    o5 = torch.empty((B, S, K, G, D), dtype=q5.dtype, device=q5.device)
    flash_attention(q, k, v, causal=causal,
                    out=o5.permute(0, 2, 3, 1, 4).view(B, K * G, S, D))
    return o5


__all__ = ["mha", "gqa_layout_attention", "mha_ref"]
