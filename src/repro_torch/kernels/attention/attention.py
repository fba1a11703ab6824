"""Flash attention on Hopper (K8): the port of the reference's Pallas
`repro.kernels.attention.attention.flash_attention` / `_flash_kernel`.

`flash_attention` dispatches on where its tensors lie. On CUDA tensors it
launches the hand-written kernel `csrc/flash_attention.cu`: one thread
block per (b, h, q-tile) streams the kv tiles of kv head h // (H / Hkv)
through shared memory and keeps the online-softmax statistics m, l and the
accumulator in f32, as the Pallas kernel keeps them in VMEM scratch. On CPU
tensors it runs `_flash_attention_plain`, the same function in plain
PyTorch. There is no fallback from one to the other, and `LAUNCHES` counts
the kernel's launches.

The causal mask is the Pallas kernel's: `k_pos <= q_pos` with both counted
from 0, aligned to the top-left corner. `ref.mha_ref` aligns it to the
bottom-right, so the two differ where Sq != Skv (ROADMAP Queue 3). Masked
logits are `NEG_INF = -2**30`, not -inf.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK

NEG_INF = -2.0 ** 30
THREADS = 256      # threads per block of the CUDA kernel
KV_CHUNK = 32      # keys per shared-memory K/V chunk inside a kv tile
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(block_q: int, block_k: int, D: int) -> int:
    """Shared memory of one block of the CUDA kernel (f32 words x 4): the
    Q tile transposed (D x (block_q + 4), padded against bank conflicts),
    the accumulator (block_q x D), one K chunk transposed (D x (KV_CHUNK +
    4), also the V chunk), the logits then probabilities of one kv tile
    (block_k x block_q), the per-row m, l and correction, and the row-split
    reduction scratch. Rows and head dims are padded to multiples of 4 for
    16-byte access."""
    bq, dp = _round4(block_q), _round4(D)
    words = (dp * (bq + 4) + bq * dp + dp * (KV_CHUNK + 4) + block_k * bq
             + 3 * bq + 2 * max(THREADS, bq))
    return 4 * words


def vmem_bytes(block_q: int, block_k: int, D: int, itemsize: int = 2) -> int:
    """The reference's VMEM working set of one Pallas program (its formula,
    pinned by the tests). The CUDA kernel's budget is `smem_bytes`."""
    io = (block_q * D + 2 * block_k * D) * itemsize + block_q * D * itemsize
    scratch = (2 * block_q + block_q * D) * 4
    logits = block_q * block_k * 4
    return 2 * io + scratch + logits  # x2: double-buffered pipeline


def _flash_attention_plain(q, k, v, causal: bool, scale: float):
    """Plain version: f32 logits, the kernel's top-left causal mask with
    NEG_INF, a softmax over the whole row, the 1e-30 floor on l."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Skv, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = o / torch.clamp_min(l, 1e-30)
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _flash_attention_cuda(q, k, v, causal: bool, scale: float,
                          block_q: int, block_k: int):
    """Launch K8 on contiguous (B, H, Sq, D) / (B, Hkv, Skv, D) tensors."""
    lib = _build.load()
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention on the card takes q, k, v of one "
                         f"dtype, float32 or bfloat16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA "
                         "device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, Hkv, Sq, Skv, D, block_q, block_k,
            int(causal), scale, smem_bytes(block_q, block_k, D), stream)
    _build.check(err, "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128):
    """q (B,H,Sq,D); k,v (B,Hkv,Skv,D), H % Hkv == 0. Returns (B,H,Sq,D) in
    q's dtype.

    Raises ValueError, on either device, where H % Hkv != 0, where Sq or
    Skv is not a multiple of its block (after `min(block, S)`, as the
    reference asserts) and where the kernel's tiles would need more shared
    memory than one block may use (`smem_bytes` > `SMEM_PER_BLOCK`)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,H,Sq,D) and k, v "
                         f"(B,Hkv,Skv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v (B,Hkv,Skv,D) {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({Hkv})")
    block_q = min(block_q, Sq)
    block_k = min(block_k, Skv)
    if Sq % block_q or Skv % block_k:
        raise ValueError(f"Sq={Sq} and Skv={Skv} must be multiples of "
                         f"block_q={block_q} and block_k={block_k}")
    need = smem_bytes(block_q, block_k, D)
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"flash_attention tiles (block_q={block_q}, "
                         f"block_k={block_k}, D={D}) need {need} B of shared "
                         f"memory, over the {SMEM_PER_BLOCK} B one block may "
                         f"use; use smaller blocks")
    scale = scale or D ** -0.5
    if not q.is_cuda:
        return _flash_attention_plain(q, k, v, causal, scale)
    return _flash_attention_cuda(q, k, v, causal, scale, block_q, block_k)
