"""Flash attention on Hopper (K8): the port of the reference's Pallas
`repro.kernels.attention.attention.flash_attention` / `_flash_kernel`.

`flash_attention` dispatches on where its tensors lie and on their dtype.
On CUDA tensors it launches a hand-written kernel: bf16 goes to the
tensor-core kernel `csrc/flash_attention_tc.cu` (both products on the
tensor cores, the f32 accumulators and online-softmax statistics in
registers, tiles of the kernel's own choosing), f32 to the SIMT kernel
`csrc/flash_attention.cu` (exact f32 products, as the reference's f32 dot;
its tiles are the caller's blocks capped to fit one block's shared memory,
`simt_tiles`). Both keep m, l and the accumulator in f32, as the Pallas
kernel keeps them in VMEM scratch, and both take q, k, v and the output by
their strides, so a permuted view is read and written in place. On CPU
tensors it runs `_flash_attention_plain`, the same function in plain
PyTorch. There is no fallback from one to another. `LAUNCHES` counts the
launches: "flash_attention" every launch of K8, "flash_attention_tc" those
of the tensor-core kernel.

The causal mask is the Pallas kernel's: `k_pos <= q_pos` with both counted
from 0, aligned to the top-left corner. `ref.mha_ref` aligns it to the
bottom-right, so the two differ where Sq != Skv (ROADMAP Queue 3). Masked
logits are `NEG_INF = -2**30`, not -inf.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK
from repro_torch.kernels import library as L
from repro_torch.kernels import refuse_grad

NEG_INF = -2.0 ** 30
THREADS = 256      # threads per block of the SIMT kernel
KV_CHUNK = 32      # keys per shared-memory K/V chunk inside a kv tile
TC_BQ = 128        # query rows per block of the tensor-core kernel
TC_HEAD_DIMS = (64, 128, 192, 256)   # its builds (template head dims)
TC_ALIGN = 8       # bf16 elements in the 16-byte rows it loads and stores
TC_STAGES = 2      # its ring of K and V tiles

LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}
# the shared bytes the SIMT kernel's last launch asked for
LAUNCHED_SHARED = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(block_q: int, block_k: int, D: int) -> int:
    """Shared memory of one block of the SIMT kernel (f32 words x 4): the
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


def simt_tiles(block_q: int, block_k: int, D: int) -> tuple:
    """(BQ, BK) of the SIMT kernel: the caller's blocks, halved (rounding
    up; BK first while it is at least BQ and above KV_CHUNK) until
    `smem_bytes` fits one block. The kernel masks a ragged last tile, so
    the halves need not divide Sq or Skv."""
    bq, bk = block_q, block_k
    while smem_bytes(bq, bk, D) > SMEM_PER_BLOCK:
        if bq == bk == 1:
            raise ValueError(f"the SIMT kernel's tiles do not fit one "
                             f"block's {SMEM_PER_BLOCK} B of shared memory "
                             f"at head dim {D}, even at one row and key")
        if bk >= bq and bk > KV_CHUNK or bq == 1:
            bk = -(-bk // 2)
        else:
            bq = -(-bq // 2)
    return bq, bk


def tc_tiles(D: int) -> tuple:
    """(DP, BQ, BK) of the tensor-core kernel for head dim D <= 256: the
    build's head dim (the least of `TC_HEAD_DIMS` at least D; the columns
    past D read as zeros), the query rows of a block (two warpgroups of
    64) and the keys of a kv tile (128 up to DP 128, 64 at 192, 32 at 256:
    the O accumulator's DP / 2 floats and S's BK / 2 a thread within the
    168 registers that ptxas gives a thread of the 384-thread block)."""
    DP = next(d for d in TC_HEAD_DIMS if d >= D)
    return DP, TC_BQ, {64: 128, 128: 128, 192: 64, 256: 32}[DP]


def tc_smem_bytes(D: int) -> int:
    """Shared memory of one block of the tensor-core kernel: 1024 bytes of
    slack to align the swizzled tiles, the Q tile and a ring of
    `TC_STAGES` K and V tiles in bf16, and the Q, full and empty
    mbarriers."""
    DP, BQ, BK = tc_tiles(D)
    return 1024 + DP * 2 * (BQ + 2 * TC_STAGES * BK) + 8 * (1 + 2 * TC_STAGES)


def tc_kernel_attrs(device, D: int) -> dict:
    """What the card says of the tensor-core build that runs head dim D:
    registers and local (spill) bytes per thread, shared bytes and
    resident blocks per SM."""
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.flash_attention_tc_attrs(D, out)
    _build.check(err, "flash_attention_tc_attrs")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), out))


def hbm_bytes_model(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int,
                    itemsize: int) -> int:
    """Device-memory bytes of one K8 call: q and k, v read once, the output
    written once (the streams of its operands; the kernels re-read K and V
    per query tile from L2)."""
    return itemsize * (2 * B * H * Sq * D + 2 * B * Hkv * Skv * D)


def vmem_bytes(block_q: int, block_k: int, D: int, itemsize: int = 2) -> int:
    """The reference's VMEM working set of one Pallas program (its formula,
    pinned by the tests). The CUDA kernels' budgets are `smem_bytes` and
    `tc_smem_bytes`."""
    io = (block_q * D + 2 * block_k * D) * itemsize + block_q * D * itemsize
    scratch = (2 * block_q + block_q * D) * 4
    logits = block_q * block_k * 4
    return 2 * io + scratch + logits  # x2: double-buffered pipeline


BF16_REL = 2.0 ** -7    # one bf16 rounding of the output, relative
BF16_P = 2.0 ** -8      # the relative rounding of each p before P V
BF16_ABS = 1e-5         # f32 noise of values near zero


def bf16_bound(got, want, q, k, v, causal: bool = True,
               scale: Optional[float] = None):
    """Elementwise tolerance of the tensor-core kernel against the plain
    version, for (B, H, Sq, D) outputs of q, k, v (B, Hkv, Skv, D).

    The kernel rounds P to bf16 before P V, one rounding more than the
    plain version, which keeps P in f32 (both sum l from the f32 p). Each p
    carries a relative error of at most 2**-8, so for row r and column d
        |d o_rd| <= 2**-8 * sum_j p_j |v_jd| / l
    over the keys j of that head's kv head: the plain version itself with
    |v| for v, in f32. On top of that both outputs are rounded to bf16 (at
    most one ulp of the larger, 2**-7), and f32 sums in another order
    differ near zero by about 1e-5. So
        |g - w| <= 2**-7 max(|g|, |w|) + 2**-8 sum_j p_j |v_jd| / l + 1e-5."""
    g, w = got.float(), want.float()
    scale = scale or q.shape[3] ** -0.5
    pv = _flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                causal, scale)
    return BF16_REL * torch.maximum(g.abs(), w.abs()) + BF16_P * pv \
        + BF16_ABS


def within_bf16_bound(got, want, q, k, v, causal: bool = True,
                      scale: Optional[float] = None) -> bool:
    """Every element of `got` within `bf16_bound` of `want`."""
    return bool(((got.float() - want.float()).abs()
                 <= bf16_bound(got, want, q, k, v, causal, scale)).all())


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


def _bhs_strides(t) -> tuple:
    """The (b, h, s) element strides of a 4-d tensor; a dim of size 1 gets
    the stride a contiguous tensor would have there (any stride addresses
    its one index, and the tensor maps take only strides that are
    multiples of 16 bytes)."""
    (b, h, s, d), (sb, sh, ss, _) = t.shape, t.stride()
    return (sb if b > 1 else h * s * d, sh if h > 1 else s * d,
            ss if s > 1 else d)


def _strides(*ts) -> list:
    """`_bhs_strides` of each tensor, flattened."""
    return [st for t in ts for st in _bhs_strides(t)]


def _tc_layout(t, D8: int) -> bool:
    """Whether the tensor-core kernel reads or writes `t` in place: unit d
    stride, 16-byte rows and strides, and D a multiple of 8."""
    sb, sh, ss = _bhs_strides(t)
    return (t.shape[3] == D8 and t.stride(3) == 1
            and sb % TC_ALIGN == sh % TC_ALIGN == ss % TC_ALIGN == 0
            and t.data_ptr() % 16 == 0)


def _tc_operand(t, D8: int):
    """`t` itself where the kernel takes it in place, else a fresh
    contiguous copy with D zero-padded to D8."""
    if _tc_layout(t, D8):
        return t
    return torch.nn.functional.pad(t, (0, D8 - t.shape[3])).clone(
        memory_format=torch.contiguous_format)


def _launch(fn, device, *args) -> int:
    """Call a C entry point with `device`'s card current and its current
    stream last (the library's runtime launches on the calling thread's
    device)."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _flash_attention_bf16(lib, q, k, v, causal: bool, scale: float, out):
    """Launch the tensor-core kernel on bf16 q, k, v into `out`: in place
    where the layout allows, else through padded copies."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D > TC_HEAD_DIMS[-1]:
        raise ValueError(f"the tensor-core kernel is built for head dims up "
                         f"to {TC_HEAD_DIMS[-1]}, got {D}")
    D8 = -(-D // TC_ALIGN) * TC_ALIGN
    qt, kt, vt = (_tc_operand(t, D8) for t in (q, k, v))
    ot = out if _tc_layout(out, D8) else torch.empty(
        (B, H, Sq, D8), dtype=q.dtype, device=q.device)
    err = _launch(lib.flash_attention_tc_fwd, q.device,
                  *(t.data_ptr() for t in (qt, kt, vt, ot)),
                  *_strides(qt, kt, vt, ot), B, H, Hkv, Sq, Skv, D8,
                  int(causal), scale)
    _build.check(err, "flash_attention_tc_fwd")
    if ot is not out:
        out.copy_(ot[..., :D])
    return out


def _flash_attention_cuda(q, k, v, causal: bool, scale: float,
                          block_q: int, block_k: int, out=None):
    """Launch K8 on (B, H, Sq, D) / (B, Hkv, Skv, D) CUDA tensors of any
    strides, writing into `out` (B, H, Sq, D) where given: bf16 on the
    tensor-core kernel, f32 on the SIMT kernel."""
    lib = _build.load()
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention on the card takes q, k, v of one "
                         f"dtype, float32 or bfloat16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (k.device == q.device == v.device and (
            out is None or out.device == q.device)):
        raise ValueError("flash_attention: q, k, v and out must lie on one "
                         "device")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        _flash_attention_bf16(lib, q, k, v, causal, scale, out)
        LAUNCHES["flash_attention_tc"] += 1
    else:
        bq, bk = simt_tiles(block_q, block_k, D)
        qs, ks, vs = (t if t.stride(3) == 1 else t.contiguous()
                      for t in (q, k, v))
        os_ = out if out.stride(3) == 1 else torch.empty_like(qs)
        err = _launch(lib.flash_attention_fwd, q.device,
                      *(t.data_ptr() for t in (qs, ks, vs, os_)),
                      *_strides(qs, ks, vs, os_), B, H, Hkv, Sq, Skv, D, bq,
                      bk, int(causal), scale, smem_bytes(bq, bk, D))
        _build.check(err, "flash_attention_fwd")
        LAUNCHED_SHARED["flash_attention"] = smem_bytes(bq, bk, D)
        if os_ is not out:
            out.copy_(os_)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128, out=None):
    """q (B,H,Sq,D); k,v (B,Hkv,Skv,D), H % Hkv == 0, any strides. Returns
    (B,H,Sq,D) in q's dtype, written into `out` (B,H,Sq,D) where given.

    Raises ValueError, on either device, where H % Hkv != 0 and where Sq or
    Skv is not a multiple of its block (after `min(block, S)`), as the
    reference asserts. The blocks do not size the card's tiles: the
    tensor-core kernel picks its own (`tc_tiles`), the SIMT kernel caps
    them to fit (`simt_tiles`). Forward-only: raises RuntimeError, on
    either device, where autograd would need a backward
    (`kernels.refuse_grad`)."""
    refuse_grad("flash_attention (K8)", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,H,Sq,D) and k, v "
                         f"(B,Hkv,Skv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v (B,Hkv,Skv,D) {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype):
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({Hkv})")
    block_q = min(block_q, Sq)
    block_k = min(block_k, Skv)
    if Sq % block_q or Skv % block_k:
        raise ValueError(f"Sq={Sq} and Skv={Skv} must be multiples of "
                         f"block_q={block_q} and block_k={block_k}")
    scale = scale or D ** -0.5
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _OP_K8(q, k, v, out, bool(causal), float(scale), block_q, block_k)
    return out


def _k8_cpu(q, k, v, out, causal, scale, block_q, block_k):
    out.copy_(_flash_attention_plain(q, k, v, causal, scale))


def _k8_cuda(q, k, v, out, causal, scale, block_q, block_k):
    _build.load()
    _flash_attention_cuda(q, k, v, causal, scale, block_q, block_k, out)


def _k8_fake(q, k, v, out, causal, scale, block_q, block_k):
    return None


_OP_K8 = L.define(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor(a!) out, bool causal, "
    "float scale, int block_q, int block_k) -> ()",
    kind="field", cpu=_k8_cpu, cuda=_k8_cuda, fake=_k8_fake,
    static=("causal", "block_q", "block_k"))
