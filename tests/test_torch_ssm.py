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
H100_SMS = 132


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
    """falcon-mamba's prefill (S 2048, N 16, x bf16, dt f32), its serving
    prompts (S 4-23) and 1024 f32 steps at N 16 all plan within one block's
    shared memory: K9 stages a tile of its own plan, whatever the chunk."""
    for S in (2048, 1024, *range(4, 24)):
        for xi, di in ((2, 4), (4, 4), (2, 2)):
            plan = TS.scan_launch_plan(1, S, 8192, 16, xi, di, H100_SMS, 8)
            assert plan.shared_bytes == TS.scan_shared_bytes(
                plan.lanes, plan.steps, 16, xi, di) <= SMEM_PER_BLOCK


def test_chunk_once_over_the_shared_memory_budget_runs():
    """(1, 1024, 16, 16) at chunk 1024, which the first CUDA kernel refused
    for its shared memory, runs == the JAX Pallas kernel and reference."""
    jx, tx = make(1, 1024, 16, 16, seed=11)
    y, h = TS.selective_scan(*tx, chunk=1024)
    yp, hp = JS.selective_scan(*jx, chunk=1024)
    yr, hr = j_ref(*jx)
    assert err(y, yp) < F32_TOL and err(h, hp) < F32_TOL
    assert err(y, yr) < F32_TOL and err(h, hr) < F32_TOL


def _refuse(*args, **kwargs):
    raise AssertionError("a refused call must not reach the kernel loader")


@pytest.mark.parametrize("what,shape,chunk", [
    ("multiple of chunk", (1, 96, 16, 16), 64),
    ("multiple of chunk", (1, 20, 8, 4), 8),
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
    plan = TS.scan_launch_plan(1, 16, 4, 4, 4, 4, H100_SMS, 8)
    with pytest.raises(RuntimeError, match="kernel loader unavailable"):
        TS._selective_scan_cuda(*tx, plan)
    assert TS.LAUNCHES == before


# ---------------------------------------------------------------------------
# K9's launch plan (`scan_launch_plan`) and the decomposition it launches
# ---------------------------------------------------------------------------


def check_plan(plan, B, S, D, N, xi=2, di=4):
    assert plan.tile == plan.lanes * plan.steps
    assert plan.threads == TS.D_TILE * plan.lanes
    assert plan.grid == (-(-D // TS.D_TILE), B, 1)
    assert plan.lanes in TS.LANE_CHOICES and plan.steps in TS.STEP_BUILDS
    assert plan.lanes <= TS.max_lanes(plan.steps)
    assert plan.shared_bytes == TS.scan_shared_bytes(
        plan.lanes, plan.steps, N, xi, di) <= SMEM_PER_BLOCK


def test_plan_at_the_timed_shape():
    """falcon-mamba's 2048-token prefill, x bf16, dt f32, on an H100 that
    holds 8 four-lane blocks per SM: the 512 blocks fit at once with 8
    lanes, not with 16, so 8 lanes of 8 steps (tiles of 64 steps, 128
    threads); four batch rows fill the card with 4 lanes."""
    plan = TS.scan_launch_plan(1, 2048, 8192, 16, 2, 4, H100_SMS, 8)
    check_plan(plan, 1, 2048, 8192, 16)
    assert plan == TS.ScanPlan(8, 8, 64, 128, 37120, (512, 1, 1), 8)
    # two raw stages (x and dt rows with 16 B of pad a lane, B, C), B and
    # C widened to f32 at a pitch of 68, y, A and two carries
    assert plan.shared_bytes == 2 * (
        (64 * 32 + 8 * 16) + (64 * 64 + 8 * 16) + 2 * 64 * 32) + 4 * (
        2 * 16 * 68 + 16 * 68 + 3 * 16 * 16)
    four = TS.scan_launch_plan(4, 2048, 8192, 16, 2, 4, H100_SMS, 8)
    check_plan(four, 4, 2048, 8192, 16)
    assert (four.lanes, four.steps, four.grid) == (4, 8, (512, 4, 1))
    # a card that holds fewer blocks keeps 4 lanes at one row too
    assert TS.scan_launch_plan(1, 2048, 8192, 16, 2, 4, H100_SMS,
                               7).lanes == 4


@pytest.mark.parametrize("S", range(4, 24))
def test_plan_at_the_serving_prompts(S):
    """serve.py's prompts (S 4-23, chunk S): the fewest steps whose tile
    covers S, doubled lanes halving the steps, so a short prompt walks one
    short tile."""
    plan = TS.scan_launch_plan(1, S, 8192, 16, 2, 4, H100_SMS, 12)
    check_plan(plan, 1, S, 8192, 16)
    assert plan.lanes == 8 and plan.tile >= S
    assert plan.tile == (8 if S <= 8 else 16 if S <= 16 else 32)


@pytest.mark.parametrize("N", [1, 5, 16, 40, 64, 128])
@pytest.mark.parametrize("xi,di", [(4, 4), (2, 4), (2, 2)])
@pytest.mark.parametrize("S", [1, 100, 4096])
def test_plan_shared_bytes_within_the_block_limit(N, xi, di, S):
    plan = TS.scan_launch_plan(2, S, 300, N, xi, di, H100_SMS, 8)
    check_plan(plan, 2, S, 300, N, xi, di)


def test_plan_narrow_d_takes_more_lanes():
    """A D of 512 (32 blocks) doubles the lanes up to the 16 the 8-step
    build takes; a D of 16384 (1024 blocks) fills the card with 4."""
    plan = TS.scan_launch_plan(1, 2048, 512, 16, 2, 4, H100_SMS, 8)
    check_plan(plan, 1, 2048, 512, 16)
    assert (plan.lanes, plan.steps, plan.tile) == (16, 8, 128)
    wide = TS.scan_launch_plan(1, 2048, 16384, 16, 2, 4, H100_SMS, 8)
    assert (wide.lanes, wide.steps) == (4, 8)


def test_plan_honours_given_lanes_and_steps():
    plan = TS.scan_launch_plan(1, 2048, 8192, 16, 2, 4, H100_SMS, 8,
                               lanes=32, steps=2)
    check_plan(plan, 1, 2048, 8192, 16)
    assert (plan.lanes, plan.steps, plan.threads) == (32, 2, 512)


@pytest.mark.parametrize("kwargs,match", [
    (dict(lanes=2), "lanes a d"), (dict(lanes=64), "lanes a d"),
    (dict(steps=16), "steps a lane"), (dict(steps=3), "steps a lane"),
    (dict(lanes=32, steps=8), "at most 16 lanes"),
    (dict(lanes=32, steps=4), "at most 16 lanes"),
])
def test_plan_refusals_name_their_limits(kwargs, match):
    with pytest.raises(ValueError, match=match):
        TS.scan_launch_plan(1, 64, 64, 16, 4, 4, H100_SMS, 8, **kwargs)


def test_plan_grid_limits():
    TS.scan_launch_plan(65535, 8, 16, 4, 4, 4, H100_SMS, 8)
    with pytest.raises(ValueError, match="K9: .* y exceeds CUDA's limit of "
                                         "65535"):
        TS.scan_launch_plan(65536, 8, 16, 4, 4, 4, H100_SMS, 8)
    with pytest.raises(ValueError, match="shared memory"):
        TS.scan_launch_plan(1, 64, 64, 128, 4, 4, H100_SMS, 8, lanes=16,
                            steps=8)


@pytest.mark.parametrize("shape,kwargs", [
    ((65536, 8, 16, 4), {}), ((1, 8, 16, 129), {}),
    ((1, 64, 16, 16), dict(lanes=3)), ((1, 64, 16, 16), dict(steps=16)),
    ((1, 64, 64, 128), dict(lanes=16, steps=8)),
])
def test_refused_plan_never_reaches_the_loader(monkeypatch, shape, kwargs):
    """`scan_device_plan` refuses what no build takes before it loads the
    kernels or asks the card anything."""
    monkeypatch.setattr(_build, "load", _refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", _refuse)
    B, S, D, N = shape
    with pytest.raises(ValueError):
        TS.scan_device_plan("cuda:0", B, S, D, N, torch.float32,
                            torch.float32, **kwargs)


def tiled_scan(xc, dt, Bmat, Cmat, A, h0, lanes, steps):
    """K9's decomposition in plain PyTorch: tiles of lanes * steps steps,
    each lane's `steps` pairs composed into one map, the maps of a tile's
    lanes scanned in log2(lanes) rounds (shfl_up), the carried h folded in,
    each lane's steps walked again for y; steps past S staged as zeros."""
    xc, dt, Bmat, Cmat, A, h = (t.float() for t in (xc, dt, Bmat, Cmat, A,
                                                    h0))
    B, S, D = xc.shape
    N = Bmat.shape[-1]
    TL = lanes * steps
    pad = -S % TL
    zpad = lambda t: torch.cat(  # noqa: E731
        [t, t.new_zeros(B, pad, t.shape[-1])], 1)
    xc, dt, Bmat, Cmat = (zpad(t) for t in (xc, dt, Bmat, Cmat))
    ys = []
    for t0 in range(0, S + pad, TL):
        cut = slice(t0, t0 + TL)
        a = torch.exp2(dt[:, cut, :, None] * (A * 1.4426950408889634))
        bu = (dt[:, cut] * xc[:, cut])[..., None] * Bmat[:, cut, None, :]
        a = a.reshape(B, lanes, steps, D, N)
        bu = bu.reshape(B, lanes, steps, D, N)
        P, Q = torch.ones_like(a[:, :, 0]), torch.zeros_like(a[:, :, 0])
        for i in range(steps):
            Q = a[:, :, i] * Q + bu[:, :, i]
            P = P * a[:, :, i]
        off = 1
        while off < lanes:
            Pp, Qp = P.clone(), Q.clone()
            Q[:, off:] = P[:, off:] * Qp[:, :-off] + Q[:, off:]
            P[:, off:] = P[:, off:] * Pp[:, :-off]
            off *= 2
        after = P * h[:, None] + Q
        start = torch.cat([h[:, None], after[:, :-1]], 1)
        c = Cmat[:, cut].reshape(B, lanes, steps, 1, N)
        y = torch.zeros(B, lanes, steps, D)
        for i in range(steps):
            start = a[:, :, i] * start + bu[:, :, i]
            y[:, :, i] = (start * c[:, :, i]).sum(-1)
        h = start[:, -1]
        ys.append(y.reshape(B, TL, D))
    return torch.cat(ys, 1)[:, :S], h


@pytest.mark.parametrize("B,S,D,N,lanes,steps", [
    (1, 2048, 16, 16, 4, 8), (1, 16, 24, 16, 4, 4), (1, 23, 8, 16, 4, 8),
    (2, 200, 37, 5, 4, 8), (1, 100, 8, 40, 32, 1), (2, 77, 16, 8, 8, 2)])
def test_tiled_decomposition_equals_the_reference(B, S, D, N, lanes, steps):
    """The plan's tiles, lanes and carries compute the reference's scan
    (the JAX `selective_scan_ref`), ragged last tiles included."""
    jx, tx = make(B, S, D, N, seed=S)
    y, h = tiled_scan(*tx, lanes, steps)
    yr, hr = j_ref(*jx)
    scale = max(1.0, float(np.max(np.abs(np.asarray(yr)))))
    assert err(y, yr) < F32_TOL * scale and err(h, hr) < F32_TOL
