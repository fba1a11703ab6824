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
    ("shared memory", ((1, 2, 512, 128), (1, 2, 512, 128)),
     dict(block_q=256, block_k=256)),
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


def test_smem_budget_of_the_main_path():
    """The default 128 x 128 tiles at head_dim 128 fit one block's shared
    memory; 256 x 256 do not, and neither does head_dim 192 at 128 x 128."""
    assert TA.smem_bytes(128, 128, 128) == 220_672 <= SMEM_PER_BLOCK
    assert TA.smem_bytes(256, 256, 128) > SMEM_PER_BLOCK
    assert TA.smem_bytes(128, 128, 192) > SMEM_PER_BLOCK


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
