"""The port's flash attention (K8's plain version on the CPU) against the
reference: the JAX Pallas `flash_attention` (interpret mode) and `mha_ref`,
on the same numpy inputs, at the reference's tolerances (1e-5 f32, 2e-2
bf16).

Where Sq != Skv the causal masks differ: the Pallas kernel (and the port)
mask `k_pos <= q_pos` from the top-left, `mha_ref` aligns the mask to the
bottom-right. Those cases are held against the Pallas kernel only (ROADMAP
Queue 3, reference caveats)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention as JA
from repro.kernels.attention import ops as JOPS
from repro.kernels.attention.ref import mha_ref as j_mha_ref
from repro.models import layers as JL
from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK
from repro_torch.kernels.attention import attention as TA
from repro_torch.kernels.attention import ops as TOPS
from repro_torch.kernels.attention.ref import mha_ref as t_mha_ref
from repro_torch.models import layers as TL
from repro_torch.models.convert import tensor_from_numpy

# the reference's cases (tests/test_flash_attention.py:11-18)
CASES = [
    # B, H, Hkv, S, D, causal, dtype
    (2, 4, 2, 256, 64, True, "float32"),
    (1, 8, 1, 128, 32, True, "bfloat16"),
    (2, 4, 4, 512, 64, False, "float32"),
    (1, 2, 2, 384, 128, True, "float32"),
    (1, 6, 2, 256, 64, True, "bfloat16"),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def inputs(B, H, Hkv, Sq, Skv, D, dtype, seed):
    """The same values as JAX arrays and as CPU tensors (bf16 bit for
    bit)."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.normal(size=s), getattr(jnp, dtype))
          for s in ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    return jx, [tensor_from_numpy(np.asarray(a), device="cpu") for a in jx]


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def err(a, b) -> float:
    return float(np.max(np.abs(f32(a) - f32(b))))


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,dt", CASES)
def test_plain_kernel_vs_pallas_and_ref(B, H, Hkv, S, D, causal, dt):
    (jq, jk, jv), (q, k, v) = inputs(B, H, Hkv, S, S, D, dt, seed=0)
    out = TA.flash_attention(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert err(out, JA.flash_attention(jq, jk, jv, causal=causal)) < TOL[dt]
    assert err(out, j_mha_ref(jq, jk, jv, causal=causal)) < TOL[dt]
    assert err(t_mha_ref(q, k, v, causal=causal),
               j_mha_ref(jq, jk, jv, causal=causal)) < TOL[dt]


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
def test_block_shapes(bq, bk):
    (jq, jk, jv), (q, k, v) = inputs(1, 2, 2, 256, 256, 64, "float32", 1)
    out = TA.flash_attention(q, k, v, block_q=bq, block_k=bk)
    assert err(out, JA.flash_attention(jq, jk, jv, block_q=bq,
                                       block_k=bk)) < 1e-5
    assert err(out, j_mha_ref(jq, jk, jv)) < 1e-5


@pytest.mark.parametrize("Sq,Skv,dt,bq,bk", [
    (128, 256, "float32", 64, 64), (256, 128, "float32", 64, 64),
    (128, 256, "bfloat16", 64, 128), (256, 128, "bfloat16", 128, 64)])
def test_causal_sq_ne_skv_follows_the_kernel(Sq, Skv, dt, bq, bk):
    """Sq != Skv, causal: the port follows the Pallas kernel's top-left
    mask, which is not `mha_ref`'s bottom-right one."""
    (jq, jk, jv), (q, k, v) = inputs(1, 4, 2, Sq, Skv, 64, dt, seed=2)
    out = TA.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
    pallas = JA.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                block_k=bk)
    assert err(out, pallas) < TOL[dt]
    assert err(out, j_mha_ref(jq, jk, jv, causal=True)) > 0.1
    assert err(t_mha_ref(q, k, v, causal=True),
               j_mha_ref(jq, jk, jv, causal=True)) < TOL[dt]


def test_non_causal_sq_ne_skv_equals_both():
    (jq, jk, jv), (q, k, v) = inputs(1, 4, 2, 128, 384, 64, "float32", 3)
    out = TA.flash_attention(q, k, v, causal=False, block_q=64, block_k=128)
    assert err(out, JA.flash_attention(jq, jk, jv, causal=False, block_q=64,
                                       block_k=128)) < 1e-5
    assert err(out, j_mha_ref(jq, jk, jv, causal=False)) < 1e-5


@pytest.mark.parametrize("B,S,K,G,D", [(1, 128, 2, 2, 32), (2, 13, 1, 5, 16)])
def test_gqa_layout_attention(B, S, K, G, D):
    rng = np.random.default_rng(9)
    arrs = [rng.normal(size=s) for s in ((B, S, K, G, D), (B, S, K, D),
                                         (B, S, K, D))]
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in arrs)
    q, k, v = (torch.as_tensor(a, dtype=torch.float32) for a in arrs)
    out = TOPS.gqa_layout_attention(q, k, v)
    assert out.shape == (B, S, K, G, D)
    assert err(out, JOPS.gqa_layout_attention(jq, jk, jv)) < 1e-5
    pos = jnp.arange(S)
    assert err(out, JL.attn_dense(jq, jk, jv, q_pos=pos, kv_pos=pos,
                                  causal=True, scale=D ** -0.5)) < 1e-5
    tpos = torch.arange(S)
    assert err(out, TL.attn_dense(q, k, v, q_pos=tpos, kv_pos=tpos,
                                  causal=True, scale=D ** -0.5)) < 1e-5


def _refuse(*args, **kwargs):
    raise AssertionError("a refused call must not reach the kernel loader")


@pytest.mark.parametrize("what,shapes,kw", [
    ("multiple of kv heads", ((1, 3, 64, 16), (1, 2, 64, 16)), {}),
    ("multiples of block_q", ((1, 2, 96, 16), (1, 2, 96, 16)),
     dict(block_q=64)),
    ("multiples of block_q", ((1, 2, 64, 16), (1, 2, 96, 16)),
     dict(block_k=64)),
])
def test_refusals_raise_value_error(monkeypatch, what, shapes, kw):
    monkeypatch.setattr(_build, "load", _refuse)
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    before = dict(TA.LAUNCHES)
    with pytest.raises(ValueError, match=what):
        TA.flash_attention(q, k, k.clone(), **kw)
    assert TA.LAUNCHES == before


@pytest.mark.parametrize("bq,bk,D,itemsize", [(128, 128, 128, 2),
                                              (64, 128, 64, 4),
                                              (128, 64, 32, 2),
                                              (256, 256, 192, 2)])
def test_vmem_bytes_equals_reference(bq, bk, D, itemsize):
    assert TA.vmem_bytes(bq, bk, D, itemsize) == JA.vmem_bytes(bq, bk, D,
                                                               itemsize)


@pytest.mark.parametrize("B,H,Hkv,S,D,bq,bk,dt", [
    (1, 2, 2, 512, 128, 256, 256, "float32"),
    (1, 2, 2, 512, 128, 256, 256, "bfloat16"),
    (1, 4, 2, 256, 192, 128, 128, "float32")])
def test_blocks_over_the_old_budget_run_and_equal_pallas(B, H, Hkv, S, D, bq,
                                                         bk, dt):
    """256 x 256 blocks at head dim 128, and head dim 192 (nemotron-4-340b)
    at the default blocks, which the kernel once refused for shared memory:
    they run, and equal the reference's Pallas kernel at those blocks."""
    (jq, jk, jv), (q, k, v) = inputs(B, H, Hkv, S, S, D, dt, seed=4)
    out = TA.flash_attention(q, k, v, block_q=bq, block_k=bk)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert err(out, JA.flash_attention(jq, jk, jv, block_q=bq,
                                       block_k=bk)) < TOL[dt]


def test_smem_budget_of_the_main_path():
    """The kernels' shared memory. The tensor-core kernel (bf16) picks its
    own tiles per head dim: 128 query rows, a ring of 2 kv tiles of 128
    keys up to D 128, 64 at D 192, 32 at D 256, at most 161 KB. The SIMT
    kernel (f32)
    runs the caller's blocks, capped to fit one block: 128 x 128 at D 128
    (220,672 B) as before, 256 x 256 cut to 128 x 128, D 192 and 256 at
    128 x 128 cut to 64 x 64."""
    assert TA.smem_bytes(128, 128, 128) == 220_672 <= SMEM_PER_BLOCK
    assert [TA.tc_tiles(D) for D in (64, 128, 192, 256)] == [
        (64, 128, 128), (128, 128, 128), (192, 128, 64), (256, 128, 32)]
    assert [TA.tc_smem_bytes(D) for D in (64, 128, 192, 256)] == [
        82_984, 164_904, 148_520, 132_136]
    assert max(TA.tc_smem_bytes(D) for D in (64, 128, 192, 256)) \
        <= SMEM_PER_BLOCK
    assert TA.tc_tiles(16) == (64, 128, 128) and TA.tc_tiles(96)[0] == 128
    assert TA.simt_tiles(128, 128, 128) == (128, 128)
    assert TA.simt_tiles(256, 256, 128) == (128, 128)
    assert TA.simt_tiles(128, 128, 192) == (64, 64)
    assert TA.simt_tiles(128, 128, 256) == (64, 64)
    assert TA.simt_tiles(40, 40, 64) == (40, 40)
    for bq, bk, D in ((256, 256, 128), (128, 128, 192), (128, 128, 256),
                      (512, 64, 64), (64, 1024, 128)):
        assert TA.smem_bytes(*TA.simt_tiles(bq, bk, D), D) <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="head dim 8192"):
        TA.simt_tiles(128, 128, 8192)


class _FakeLib:
    """The kernel library's two K8 entry points, recording their calls."""

    def __init__(self):
        self.calls = []

    def flash_attention_tc_fwd(self, *args):
        self.calls.append(("tc", args))
        return 0

    def flash_attention_fwd(self, *args):
        self.calls.append(("simt", args))
        return 0


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt")])
def test_cuda_dispatch_by_dtype(monkeypatch, dtype, entry):
    """bf16 goes to the tensor-core entry, f32 to the SIMT one, with no
    other path: q, k, v and out by their (b, h, s) strides (a permuted view
    passes its own), the SIMT kernel's capped tiles and its shared bytes.
    The launch counts follow: "flash_attention" for both,
    "flash_attention_tc" for the tensor-core kernel alone."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(TA, "_launch", lambda fn, device, *a: fn(*a, None))
    q5 = torch.zeros((2, 64, 2, 5, 128), dtype=dtype)
    kv = torch.zeros((2, 64, 2, 128), dtype=dtype)
    q = q5.permute(0, 2, 3, 1, 4).reshape(2, 10, 64, 128)
    k = kv.permute(0, 2, 1, 3)
    o5 = torch.empty_like(q5)
    o = o5.permute(0, 2, 3, 1, 4).view(2, 10, 64, 128)
    before = dict(TA.LAUNCHES)
    got = TA._flash_attention_cuda(q, k, k, True, 0.25, 256, 256, out=o)
    assert got is o
    [(name, args)] = lib.calls
    assert name == entry
    assert args[:4] == tuple(t.data_ptr() for t in (q, k, k, o))
    strides = (64 * 1280, 128, 1280, 64 * 256, 128, 256)
    assert args[4:16] == strides[:3] + strides[3:] * 2 + strides[:3]
    assert args[16:22] == (2, 10, 2, 64, 64, 128)
    if entry == "tc":
        assert args[22:] == (1, 0.25, None)
    else:
        assert args[22:] == (128, 128, 1, 0.25, 220_672, None)
    assert TA.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert TA.LAUNCHES["flash_attention_tc"] == \
        before["flash_attention_tc"] + (entry == "tc")


def test_tc_operands_pad_head_dims_off_the_builds():
    """A bf16 head dim that is not a multiple of 8 reaches the kernel as a
    zero-padded contiguous copy (D rounded up to 8), and the output is cut
    back to D; a layout the kernel takes is passed as it is."""
    q = torch.ones((1, 2, 8, 20), dtype=torch.bfloat16)
    padded = TA._tc_operand(q, 24)
    assert padded.shape == (1, 2, 8, 24) and padded.is_contiguous()
    assert torch.equal(padded[..., :20], q) and not padded[..., 20:].any()
    whole = torch.ones((1, 2, 8, 24), dtype=torch.bfloat16)
    assert TA._tc_operand(whole, 24) is whole
    assert not TA._tc_layout(whole[..., 1:], 24)


def test_strides_of_size_one_dims_are_the_contiguous_ones():
    """The (b, h, s) strides the kernels get: a tensor's own, but for a
    dim of size 1 the stride a contiguous tensor has there (the tensor
    maps take only strides that are multiples of 16 bytes; any stride
    addresses a dim's one index)."""
    q5 = torch.zeros((1, 23, 8, 5, 128))
    q = q5.permute(0, 2, 3, 1, 4).reshape(1, 40, 23, 128)
    assert TA._strides(q) == [40 * 23 * 128, 128, 40 * 128]
    one = torch.zeros((3, 1, 1, 64)).expand(3, 1, 1, 64)
    assert TA._strides(one) == [64, 64, 64]
    x = torch.zeros((2, 4, 6, 8))
    assert TA._strides(x, x[:, :1]) == [192, 48, 8, 192, 48, 8]


def test_bf16_bound_is_the_derived_one():
    """`bf16_bound` = 2**-7 max(|g|, |w|) + 2**-8 sum_j p_j |v[j, d]| / l
    over the kv head's keys + 1e-5, each q head reading its own kv head.
    With q = k = 0 every unmasked key has the same p: the mean of |v| over
    the keys, or under the top-left causal mask row 0's key 0 alone."""
    g = torch.tensor([1.0, -2.0, 0.0, 0.5]).reshape(1, 2, 1, 2)
    w = torch.tensor([1.5, -1.0, 0.25, 0.0]).reshape(1, 2, 1, 2)
    v = torch.tensor([[3.0, -1.0], [-4.0, 2.0], [1.0, 8.0], [0.0, -0.5]])
    v = v.reshape(1, 2, 2, 2)            # kv heads 0 and 1, 2 keys each
    q, k = torch.zeros_like(g), torch.zeros_like(v)
    big = torch.tensor([1.5, 2.0, 0.25, 0.5]) / 128 + 1e-5
    for causal, pv in ((False, [3.5, 1.5, 0.5, 4.25]), (True, [3, 1, 1, 8])):
        got = TA.bf16_bound(g, w, q, k, v, causal)
        want = big + torch.tensor(pv) / 256
        assert torch.allclose(got.reshape(-1), want, rtol=0, atol=1e-7)
        own = TA.bf16_bound(g, g, q, k, v, causal)
        assert TA.within_bf16_bound(g, g + 0.9 * own, q, k, v, causal)
        assert not TA.within_bf16_bound(g, g + 1.1 * own, q, k, v, causal)


def test_gqa_layout_writes_a_contiguous_output():
    """The (B, S, K, G, D) output is contiguous, so the model's reshape to
    (B, S, H, D) is a view; mha and the strided path agree."""
    rng = np.random.default_rng(5)
    q5, k4, v4 = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                  for s in ((1, 16, 2, 3, 8), (1, 16, 2, 8), (1, 16, 2, 8)))
    out = TOPS.gqa_layout_attention(q5, k4, v4)
    assert out.is_contiguous()
    assert out.reshape(1, 16, 6, 8).data_ptr() == out.data_ptr()
    q = q5.permute(0, 2, 3, 1, 4).reshape(1, 6, 16, 8)
    ref = TOPS.mha(q, k4.permute(0, 2, 1, 3), v4.permute(0, 2, 1, 3))
    assert torch.equal(out.permute(0, 2, 3, 1, 4).reshape(1, 6, 16, 8), ref)


def test_cpu_tensors_take_the_plain_version_without_launching(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    before = dict(TA.LAUNCHES)
    q = torch.ones((1, 2, 8, 16))
    TA.flash_attention(q, q, q)
    TOPS.mha(q, q, q, causal=False)
    assert TA.LAUNCHES == before


def test_cuda_dispatch_propagates_loader_errors(monkeypatch):
    def unavailable(*args, **kwargs):
        raise RuntimeError("kernel loader unavailable")

    monkeypatch.setattr(_build, "load", unavailable)
    before = dict(TA.LAUNCHES)
    q = torch.ones((1, 2, 8, 16))
    with pytest.raises(RuntimeError, match="kernel loader unavailable"):
        TA._flash_attention_cuda(q, q, q, True, 0.25, 8, 8)
    assert TA.LAUNCHES == before
