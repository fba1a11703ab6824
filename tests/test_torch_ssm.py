"""The port's selective scan (K9's plain version on the CPU) against the
reference: the JAX Pallas `selective_scan` (interpret mode) and
`selective_scan_ref`, on the same numpy inputs.

Tolerances are the reference's (`tests/test_ssm_kernel.py`): 1e-4 in f32,
where the two sides run the same recurrence in different orders (the
Pallas kernel as an associative scan, the port sequentially); 5e-2 for
bf16 inputs against the Pallas kernel. The refusals must not reach the
kernel loader or count a launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm import ops as JOPS
from repro.kernels.ssm import ssm as JS
from repro.kernels.ssm.ref import selective_scan_ref as j_ref
from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK
from repro_torch.kernels.ssm import ops as TOPS
from repro_torch.kernels.ssm import ssm as TS
from repro_torch.kernels.ssm.ref import selective_scan_ref as t_ref
from repro_torch.models.convert import tensor_from_numpy

# the reference's cases (tests/test_ssm_kernel.py:12-18)
CASES = [
    # B, S, D, N, chunk
    (2, 64, 16, 8, 16),
    (1, 128, 32, 4, 32),
    (2, 96, 8, 16, 48),
    (1, 64, 16, 16, 64),   # single chunk
]
F32_TOL = 1e-4
BF16_TOL = 5e-2


def make(B, S, D, N, seed=0, dtype="float32"):
    """The reference's inputs (`make` in its test) as JAX arrays and as CPU
    tensors with the same bits."""
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, S, D)), np.abs(rng.normal(size=(B, S, D)))
            * 0.1, rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N)))
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    jx += [jnp.asarray(-np.abs(rng.normal(size=(D, N))), jnp.float32),
           jnp.asarray(rng.normal(size=(B, D, N)) * 0.1, jnp.float32)]
    return jx, [tensor_from_numpy(np.asarray(a), device="cpu") for a in jx]


def err(a, b) -> float:
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.float().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("B,S,D,N,chunk", CASES)
def test_plain_kernel_vs_pallas_and_ref(B, S, D, N, chunk):
    jx, tx = make(B, S, D, N)
    y, h = TS.selective_scan(*tx, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    yp, hp = JS.selective_scan(*jx, chunk=chunk)
    yr, hr = j_ref(*jx)
    assert err(y, yp) < F32_TOL and err(h, hp) < F32_TOL
    assert err(y, yr) < F32_TOL and err(h, hr) < F32_TOL
    yt, ht = t_ref(*tx)
    assert err(yt, yr) < F32_TOL and err(ht, hr) < F32_TOL


def test_bf16_inputs():
    jx, tx = make(1, 64, 16, 8, seed=3, dtype="bfloat16")
    y, h = TS.selective_scan(*tx, chunk=16)
    yp, hp = JS.selective_scan(*jx, chunk=16)
    yr, _ = j_ref(*jx)
    assert err(y, yp) < BF16_TOL and err(h, hp) < BF16_TOL
    assert err(y, yr) < BF16_TOL
    # the bf16 values widen to f32 exactly: the same as f32 inputs
    y32, h32 = TS.selective_scan(*(t.float() for t in tx), chunk=16)
    assert torch.equal(y, y32) and torch.equal(h, h32)


def test_state_carries_across_chunks():
    """Running two half-length scans chained == one full scan."""
    _, (xc, dt, Bm, Cm, A, h0) = make(1, 64, 8, 4, seed=5)
    y_full, h_full = TS.selective_scan(xc, dt, Bm, Cm, A, h0, chunk=16)
    y1, h1 = TS.selective_scan(xc[:, :32], dt[:, :32], Bm[:, :32],
                               Cm[:, :32], A, h0, chunk=16)
    y2, h2 = TS.selective_scan(xc[:, 32:], dt[:, 32:], Bm[:, 32:],
                               Cm[:, 32:], A, h1, chunk=16)
    assert err(torch.cat([y1, y2], 1), y_full) < F32_TOL
    assert err(h2, h_full) < F32_TOL


def test_ops_wrapper_equals_the_references():
    jx, tx = make(1, 64, 16, 8)
    y, h = TOPS.mamba_scan(*tx, chunk=32)
    yp, hp = JOPS.mamba_scan(*jx, chunk=32)
    assert err(y, yp) < F32_TOL and err(h, hp) < F32_TOL
    assert err(y, j_ref(*jx)[0]) < F32_TOL


@pytest.mark.parametrize("chunk,D,N,itemsize", [
    (128, 512, 16, 2), (64, 8192, 16, 2), (256, 16, 8, 4), (1024, 64, 4, 2),
    (16, 8192, 16, 4)])
def test_vmem_bytes_equals_reference(chunk, D, N, itemsize):
    assert TS.vmem_bytes(chunk, D, N, itemsize) == JS.vmem_bytes(
        chunk, D, N, itemsize)


@pytest.mark.parametrize("D,N,budget", [
    (512, 16, 12 * 2**20), (8192, 16, 12 * 2**20), (16, 8, 12 * 2**20),
    (4096, 4, 2**20), (128, 16, 12 * 2**20), (8192, 16, 2**10)])
def test_pick_chunk_equals_reference(D, N, budget):
    assert TOPS.pick_chunk(D, N, budget) == JOPS.pick_chunk(D, N, budget)
    assert TOPS.pick_chunk(D, N) == JOPS.pick_chunk(D, N)


def test_pick_chunk_pins():
    """The reference's values: falcon-mamba's per-device D after TP and its
    full D_inner on one device."""
    assert TOPS.pick_chunk(512, 16) == 128
    assert TOPS.pick_chunk(8192, 16) == 8
    assert TOPS.pick_chunk(64, 4) == 1024
    assert TS.vmem_bytes(128, 512, 16) <= 12 * 2**20


def test_smem_budget_of_the_serving_path():
    """falcon-mamba's prefill chunks (S // max(S // 256, 1) < 512, N 16,
    x bf16, dt f32) fit one block's shared memory; 1024 f32 steps at N 16
    do not."""
    assert TS.smem_bytes(256, 16, 2, 4) == 40_960
    assert TS.smem_bytes(511, 16, 2, 4) <= SMEM_PER_BLOCK
    assert TS.smem_bytes(511, 16, 4, 4) <= SMEM_PER_BLOCK
    assert TS.smem_bytes(1024, 16) > SMEM_PER_BLOCK


def _refuse(*args, **kwargs):
    raise AssertionError("a refused call must not reach the kernel loader")


@pytest.mark.parametrize("what,shape,chunk", [
    ("multiple of chunk", (1, 96, 16, 16), 64),
    ("multiple of chunk", (1, 20, 8, 4), 8),
    ("shared memory", (1, 1024, 16, 16), 1024),
    ("at most 128 states", (1, 8, 4, 129), 8),
])
def test_refusals_raise_value_error(monkeypatch, what, shape, chunk):
    monkeypatch.setattr(_build, "load", _refuse)
    _, tx = make(*shape)
    before = dict(TS.LAUNCHES)
    with pytest.raises(ValueError, match=what):
        TS.selective_scan(*tx, chunk=chunk)
    assert TS.LAUNCHES == before


def test_shape_refusals(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    _, (xc, dt, Bm, Cm, A, h0) = make(1, 8, 4, 2)
    with pytest.raises(ValueError, match=r"\(B,S,D\)"):
        TS.selective_scan(xc, dt[:, :4], Bm, Cm, A, h0)
    with pytest.raises(ValueError, match=r"\(D, N\)"):
        TS.selective_scan(xc, dt, Bm, Cm, A.T, h0)


def test_kernel_types():
    """x, B, C f32 or bf16 alike, else all f32; dt f32 or x's type."""
    f, b, h = torch.float32, torch.bfloat16, torch.float16
    z = lambda dt_: torch.zeros(1, dtype=dt_)  # noqa: E731
    assert TS._kernel_dtypes(z(b), z(f), z(b), z(b)) == (b, f)
    assert TS._kernel_dtypes(z(b), z(b), z(b), z(b)) == (b, b)
    assert TS._kernel_dtypes(z(f), z(b), z(f), z(f)) == (f, f)
    assert TS._kernel_dtypes(z(b), z(f), z(f), z(b)) == (f, f)
    assert TS._kernel_dtypes(z(h), z(h), z(h), z(h)) == (f, f)


def test_cpu_tensors_take_the_plain_version_without_launching(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    before = dict(TS.LAUNCHES)
    _, tx = make(1, 16, 4, 4)
    TS.selective_scan(*tx)
    TOPS.mamba_scan(*tx, chunk=8)
    assert TS.LAUNCHES == before


def test_cuda_dispatch_propagates_loader_errors(monkeypatch):
    def unavailable(*args, **kwargs):
        raise RuntimeError("kernel loader unavailable")

    monkeypatch.setattr(_build, "load", unavailable)
    before = dict(TS.LAUNCHES)
    _, tx = make(1, 16, 4, 4)
    with pytest.raises(RuntimeError, match="kernel loader unavailable"):
        TS._selective_scan_cuda(*tx, 16)
    assert TS.LAUNCHES == before
