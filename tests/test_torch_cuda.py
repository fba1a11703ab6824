"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
fixture). On a GPU host:
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`."""
import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF
from repro_torch.kernels.attention import attention as TA
from repro_torch.kernels.attention import ops as TOPS
from repro_torch.kernels.ssm import ops as TSOPS
from repro_torch.kernels.ssm import ssm as TS
from repro_torch.stencil import spec as TSP

pytestmark = pytest.mark.cuda
DT = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    return "cuda"


def fields(shape, seed, device):
    rng = np.random.default_rng(seed)
    return TREF.fields_from_numpy(*(rng.normal(size=shape) for _ in range(3)),
                                  device=device)


@pytest.mark.parametrize("shape", [(6, 10, 12), (5, 17, 12), (8, 12, 10)])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_fused_kernel_bitwise_equals_plain(cuda, shape, T):
    u, v, w = fields(shape, 0, cuda)
    p = TREF.default_params(shape[2], device=cuda)
    before = TK.LAUNCHES["advect_fused"]
    full = TK.advect_fused(u, v, w, p, T=T, dt=DT)
    assert TK.LAUNCHES["advect_fused"] == before + 1
    plain = TK._advect_fused_plain(u[None], v[None], w[None], p, T, DT,
                                   torch.ones(shape[0], device=cuda),
                                   torch.ones(shape[1], device=cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b[0]) for a, b in zip(full, plain))
    for y_tile in (4, 5, 7):
        tiled = TK.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=y_tile)
        assert all(torch.equal(a, b) for a, b in zip(tiled, full))


def test_guard_kernel_equals_plain(cuda):
    u, v, w = fields((8, 16, 64), 1, cuda)
    u[2, 3, 5] = float("nan")
    w[5, 0, 0] = float("inf")
    got = TK.finite_guard(u, v, w)
    assert torch.equal(got, TK._finite_guard_plain(u, v, w))
    assert got.tolist() == [1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0]


def test_ring_over_budget_raises(cuda):
    """A given tile whose shared planes exceed one block's budget (y_tile
    1024, the whole Y) is no longer refused: it runs as the fewest equal
    sub-tiles that a build takes, bitwise equal to K1's own plan and to
    plain."""
    u, v, w = fields((3, 1024, 64), 5, cuda)
    p = TREF.default_params(64, device=cuda)
    tiled = TK.advect_fused(u, v, w, p, T=4, dt=DT, y_tile=1024)
    got = TK.advect_fused(u, v, w, p, T=4, dt=DT)
    plain = TK._advect_fused_plain(u[None], v[None], w[None], p, 4, DT,
                                   torch.ones(3, device=cuda),
                                   torch.ones(1024, device=cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b[0]) for a, b in zip(got, plain))
    assert all(torch.equal(a, b) for a, b in zip(tiled, got))


def k1_slot_inputs(B, shape, device, seed):
    """B slots of `shape` with per-slot params (every leaf) and masks
    holding zeros, as a batched caller gives them."""
    X, Y, Z = shape
    slots = [fields(shape, seed + b, device) for b in range(B)]
    u, v, w = (torch.stack([sl[i] for sl in slots]) for i in range(3))
    base = TREF.default_params(Z, device=device)
    scale = torch.linspace(0.5, 1.5, B, device=device)
    p = TREF.AdvectParams(base.tcx * scale, base.tcy * scale,
                          base.tzc1[None] * scale[:, None],
                          base.tzc2[None] / scale[:, None])
    rng = np.random.default_rng(seed)
    xm = torch.tensor(rng.random((B, X)) > 0.2, dtype=torch.float32,
                      device=device)
    ym = torch.tensor(rng.random((B, Y)) > 0.2, dtype=torch.float32,
                      device=device)
    return (u, v, w), TK._slot_params(p, B, Z, device), xm, ym


@pytest.mark.parametrize("shape,T,y_tile", [((6, 1024, 64), 4, 128),
                                           ((6, 1000, 8), 1, 400),
                                           ((6, 1024, 64), 5, 255)])
def test_fused_kernel_sub_tiles_equal_its_own_plan(cuda, shape, T, y_tile):
    """Explicit y_tiles that no build takes as they are (128 at T = 4,
    Z = 64; 400 at T = 1, Z = 8; 255 at T = 5) run as equal sub-tiles,
    bitwise equal to K1's own plan."""
    u, v, w = fields(shape, 8, cuda)
    p = TREF.default_params(shape[2], device=cuda)
    plan = TK.fused_device_plan(cuda, *shape, T, y_tile=y_tile)
    assert plan.TY < y_tile and y_tile % plan.TY == 0
    got = TK.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=y_tile)
    own = TK.advect_fused(u, v, w, p, T=T, dt=DT)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, own))


@pytest.mark.parametrize("shape,T", [((37, 29, 61), 4), ((23, 41, 61), 3),
                                     ((11, 9, 33), 2), ((64, 50, 64), 4)])
@pytest.mark.parametrize("B", [1, 3])
def test_fused_kernel_chunk_and_tile_remainders_equal_plain(cuda, shape, T,
                                                            B):
    """K1 == plain bitwise over plans whose x chunks, y-tiles and z chunks
    leave remainders (odd Z = 61, 33 too), per-slot leaves and masks, its
    own plan and explicit y_tiles of 4 and 5."""
    X, Y, Z = shape
    (u, v, w), p, xm, ym = k1_slot_inputs(B, shape, cuda, seed=X + T)
    plain = TK._advect_fused_plain(u, v, w, p, T, DT, xm, ym)
    own = TK._advect_fused_cuda(u, v, w, p, T, DT, xm, ym)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(own, plain))
    for y_tile in (4, 5):
        base = TK.fused_device_plan(cuda, X, Y, Z, T, B, y_tile)
        for CX, CZ in ((1, None), (5, None), (16, None), (X, None), (5, 3),
                       (16, 10), (X, 1)):
            plan = TK.fused_plan_with_chunks(base, X, Z, T, CX=CX, CZ=CZ)
            got = TK._advect_fused_cuda(u, v, w, p, T, DT, xm, ym,
                                        plan=plan)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, plain)), \
                (y_tile, CX, CZ)
        got = TK.advect_fused_batched(u, v, w, p, T=T, dt=DT, y_tile=y_tile,
                                      x_interior_mask=xm, y_interior_mask=ym)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_fused_kernel_reports_its_build(cuda):
    """The card's view of the planned build: it launches the plan's
    threads, and the plan's x split used the card's resident blocks."""
    plan = TK.fused_device_plan(cuda, 1024, 1024, 64, 4)
    attrs = TK.fused_kernel_attrs(cuda, 4, plan)
    assert attrs["max_threads"] >= plan.threads
    assert attrs["blocks_per_sm"] == plan.blocks_per_sm >= 1
    assert 0 < attrs["registers"] <= 255


@pytest.mark.parametrize("T", [8, 9, 10, 14, 16])
def test_fused_kernel_deep_t_runs_as_passes_equal_plain(cuda, T):
    """T up to the build's 8 in one launch, beyond it as `fused_passes(T)`
    launches: == plain bitwise, per-slot leaves and masks, own plan and a
    y_tile of 5 (the reference's multi-hop distributed cases run T = 10
    and 14)."""
    shape = (21, 40, 20)
    (u, v, w), p, xm, ym = k1_slot_inputs(2, shape, cuda, seed=T)
    plain = TK._advect_fused_plain(u, v, w, p, T, DT, xm, ym)
    for y_tile in (None, 5):
        before = TK.LAUNCHES["advect_fused"]
        got = TK.advect_fused_batched(u, v, w, p, T=T, dt=DT, y_tile=y_tile,
                                      x_interior_mask=xm, y_interior_mask=ym)
        assert TK.LAUNCHES["advect_fused"] - before == len(TK.fused_passes(T))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, plain)), y_tile


@pytest.mark.parametrize("shape,T,y_tile", [((6, 3, 700), 1, None),
                                            ((5, 20, 2049), 4, None),
                                            ((9, 60, 64), 4, 26),
                                            ((7, 30, 130), 8, 3)])
def test_fused_kernel_z_chunks_equal_plain(cuda, shape, T, y_tile):
    """Rows too wide for one block, and tall given tiles, run in z chunks
    with a T-deep halo a side: == plain bitwise."""
    X, Y, Z = shape
    plan = TK.fused_device_plan(cuda, X, Y, Z, T, 1, y_tile)
    assert plan.n_cz > 1
    u, v, w = fields(shape, 7, cuda)
    p = TREF.default_params(Z, device=cuda)
    got = TK.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=y_tile)
    plain = TK._advect_fused_plain(u[None], v[None], w[None], p, T, DT,
                                   torch.ones(X, device=cuda),
                                   torch.ones(Y, device=cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b[0]) for a, b in zip(got, plain))


@pytest.mark.parametrize("leaf", ["tcx", "tcy", "tzc1", "tzc2"])
def test_batched_one_per_slot_leaf_equals_sequential(cuda, leaf):
    """One leaf per-slot, the others shared: each slot uses its own value."""
    B, (X, Y, Z) = 3, (5, 17, 12)
    slots = [fields((X, Y, Z), 10 + b, cuda) for b in range(B)]
    u, v, w = (torch.stack([sl[i] for sl in slots]) for i in range(3))
    base = TREF.default_params(Z, device=cuda)
    per = torch.stack([getattr(base, leaf) * s for s in (1.0, 1.5, 0.5)])
    p = base._replace(**{leaf: per})
    out = TK.advect_fused_batched(u, v, w, p, T=2, dt=DT, y_tile=5)
    for b in range(B):
        pb = base._replace(**{leaf: per[b]})
        seq = TK.advect_fused(u[b], v[b], w[b], pb, T=2, dt=DT, y_tile=5)
        assert all(torch.equal(o[b], s) for o, s in zip(out, seq)), b


@pytest.mark.parametrize("shape", [(6, 10, 12), (5, 17, 12), (8, 12, 10)])
@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow",
                                  "advect_wide"])
def test_rung_kernels_bitwise_equal_plain(cuda, shape, name):
    u, v, w = fields(shape, 2, cuda)
    p = TREF.default_params(shape[2], device=cuda)
    fn = getattr(TK, name)
    if name == "advect_wide" and shape[2] % 4:
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(u, v, w, p)
        return
    for fuse in (False, True):
        plain = TK._advect_rung_plain(u, v, w, p, fuse, DT)
        before = TK.LAUNCHES[name]
        full = fn(u, v, w, p, fuse_update=fuse, dt=DT)
        assert TK.LAUNCHES[name] == before + 1
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(full, plain))
        for y_tile in (3, 4, 5):
            tiled = fn(u, v, w, p, y_tile=y_tile, fuse_update=fuse, dt=DT)
            assert all(torch.equal(a, b) for a, b in zip(tiled, full))
        if name != "advect_wide":
            host = fn(u, v, w, p, y_tile=4, tiling="host", fuse_update=fuse,
                      dt=DT)
            assert all(torch.equal(a, b) for a, b in zip(host, full))


@pytest.mark.parametrize("x_chunk", [1, 2, 3])
def test_dataflow_x_chunks_bitwise_equal_plain(cuda, x_chunk):
    u, v, w = fields((7, 9, 64), 3, cuda)
    p = TREF.default_params(64, device=cuda)
    for name in ("advect_dataflow", "advect_wide"):
        for fuse in (False, True):
            got = TK._advect_rung_cuda(name, u, v, w, p, 4, fuse, DT,
                                       x_chunk=x_chunk)
            plain = TK._advect_rung_plain(u, v, w, p, fuse, DT)
            assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_rung_slab_over_budget_runs_on_the_plan(cuda):
    """(3, 1024, 64) untiled, once refused for a 2.4 MB slab, runs on each
    rung's own plan (and at y_tile 99, once 232,704 B) == plain bitwise."""
    u, v, w = fields((3, 1024, 64), 4, cuda)
    p = TREF.default_params(64, device=cuda)
    for fn in (TK.advect_blocked, TK.advect_dataflow, TK.advect_wide):
        for fuse in (False, True):
            plain = TK._advect_rung_plain(u, v, w, p, fuse, DT)
            for y_tile in (None, 99):
                got = fn(u, v, w, p, y_tile=y_tile, fuse_update=fuse, dt=DT)
                assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow",
                                  "advect_wide"])
@pytest.mark.parametrize("shape,y_tile,x_chunk", [
    ((7, 150, 64), 64, 3), ((9, 97, 64), 40, 4), ((5, 41, 12), 13, 2),
    ((6, 23, 8), 30, 5)])
def test_rung_plans_sub_tiles_and_x_remainders_equal_plain(cuda, name, shape,
                                                           y_tile, x_chunk):
    """A given tile taller than the plan's runs as its equal sub-tiles, x
    chunks that leave a remainder: == plain bitwise, as planned."""
    X, Y, Z = shape
    u, v, w = fields(shape, 5, cuda)
    p = TREF.default_params(Z, device=cuda)
    plan = TK.rung_device_plan(cuda, name, X, Y, Z, y_tile, x_chunk)
    assert X % plan.CX and plan.n_cx > 1
    for fuse in (False, True):
        got = TK._advect_rung_cuda(name, u, v, w, p, y_tile, fuse, DT,
                                   x_chunk=x_chunk)
        plain = TK._advect_rung_plain(u, v, w, p, fuse, DT)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


SPEC_KEYS = ["pw", "pw_rk2", "tracer", "tracer_rk2", "diffusion",
             "diffusion_rk2"]


def spec_case(key, shape, device):
    """(spec, params, fields, dt) of one shipped operator on `device`."""
    X, Y, Z = shape
    integ = "rk2" if key.endswith("rk2") else "euler"
    rng = np.random.default_rng(sum(shape))
    if key.startswith("diffusion"):
        phi = 300.0 + rng.normal(size=shape)
        return (TSP.diffusion_spec(integ),
                TSP.default_diffusion_params(Z, device=device),
                TREF.fields_from_numpy(phi, device=device), 1e-3)
    n = 4 if key.startswith("tracer") else 3
    spec = (TSP.tracer_advection_spec(integ) if n == 4
            else TSP.pw_advection_spec(integ))
    return (spec, TREF.default_params(Z, device=device),
            TREF.fields_from_numpy(*(rng.normal(size=shape)
                                     for _ in range(n)), device=device), DT)


@pytest.mark.parametrize("shape", [(6, 10, 12), (5, 17, 12), (8, 12, 10)])
@pytest.mark.parametrize("key", SPEC_KEYS)
def test_spec_kernel_bitwise_equals_plain(cuda, shape, key):
    spec, p, flds, dt = spec_case(key, shape, cuda)
    X, Y, _ = shape
    xm = torch.ones(X, device=cuda)
    ym = torch.ones(Y, device=cuda)
    xm[2] = 0.0
    ym[3:5] = 0.0
    for T in (1, 2, 3):
        for masks in ((None, None), (xm, ym)):
            kw = dict(T=T, dt=dt, x_interior_mask=masks[0],
                      y_interior_mask=masks[1])
            before = TK.LAUNCHES["stencil_fused"]
            full = TK.stencil_fused(flds, p, spec, **kw)
            assert TK.LAUNCHES["stencil_fused"] == before + len(
                TK.spec_passes(spec, T))
            pv = TK._spec_param_vectors(spec, p, cuda)
            plain = TK._stencil_fused_plain(
                [f[None] for f in flds], pv, spec, T, dt,
                torch.ones(X, device=cuda) if masks[0] is None else xm,
                torch.ones(Y, device=cuda) if masks[1] is None else ym)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b[0]) for a, b in zip(full, plain))
            for y_tile in (3, 5):
                tiled = TK.stencil_fused(flds, p, spec, y_tile=y_tile, **kw)
                assert all(torch.equal(a, b) for a, b in zip(tiled, full))
            if key == "pw":
                k1 = TK.advect_fused(*flds, p, **kw)
                assert all(torch.equal(a, b) for a, b in zip(full, k1))


@pytest.mark.parametrize("key", SPEC_KEYS)
def test_spec_kernel_batched_equals_sequential(cuda, key):
    spec, p, _, dt = spec_case(key, (5, 17, 12), cuda)
    rng = np.random.default_rng(7)
    flds = [torch.tensor(rng.normal(size=(3, 5, 17, 12)), dtype=torch.float32,
                         device=cuda) for _ in range(spec.n_fields)]
    out = TK.stencil_fused_batched(flds, p, spec, T=2, dt=dt, y_tile=5)
    for b in range(3):
        seq = TK.stencil_fused([f[b] for f in flds], p, spec, T=2, dt=dt,
                               y_tile=5)
        assert all(torch.equal(o[b], s) for o, s in zip(out, seq)), b


def test_spec_kernel_tracer_velocities_equal_pw(cuda):
    _, p, flds, dt = spec_case("tracer", (8, 12, 10), cuda)
    for integ in ("euler", "rk2"):
        out4 = TK.stencil_fused(flds, p, TSP.tracer_advection_spec(integ),
                                T=2, dt=dt, y_tile=3)
        out3 = TK.stencil_fused(flds[:3], p, TSP.pw_advection_spec(integ),
                                T=2, dt=dt, y_tile=3)
        assert all(torch.equal(a, b) for a, b in zip(out4[:3], out3))


def spec_plain(spec, p, flds, T, dt, cuda):
    X, Y, _ = flds[0].shape
    pv = TK._spec_param_vectors(spec, p, cuda, flds[0].dtype)
    out = TK._stencil_fused_plain([f[None] for f in flds], pv, spec, T, dt,
                                  torch.ones(X, device=cuda),
                                  torch.ones(Y, device=cuda))
    return [o[0] for o in out]


def test_spec_kernel_refusals(cuda):
    """PW rk2 at T = 4 over 1024 rows, refused before K6 kept its ring in
    registers, runs as passes == plain; a radius-2 spec whose z
    coefficients are cut for radius 1 (diffusion's callback) is refused at
    launch, and a radius-1 user spec runs its generated functor == plain."""
    spec, p, flds, dt = spec_case("pw_rk2", (4, 1024, 64), cuda)
    before = TK.LAUNCHES["stencil_fused"]
    out = TK.stencil_fused(flds, p, spec, T=4, dt=dt)
    assert TK.LAUNCHES["stencil_fused"] == before + len(
        TK.spec_passes(spec, 4))
    assert all(torch.equal(a, b)
               for a, b in zip(out, spec_plain(spec, p, flds, 4, dt, cuda)))
    star2 = tuple((d, 0, 0) for d in (-2, -1, 0, 1, 2))
    wide = TSP.StencilSpec(name="diffusion_r2", fields=("phi",),
                           offsets={"phi": star2}, source=TSP._diff_source,
                           pack_params=TSP._diff_pack)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        TK.stencil_fused([torch.zeros((4, 6, 6), device=cuda)],
                         TSP.default_diffusion_params(6, device=cuda), wide,
                         T=1)
    # a radius-1 user spec runs its generated functor, == its callback
    custom = TSP.StencilSpec(name="custom", fields=("a",),
                             offsets={"a": ((1, 0, 0),)},
                             source=lambda sh, pv: (sh(0, 1, 0, 0),),
                             pack_params=lambda q: ())
    a = torch.tensor(np.random.default_rng(5).normal(size=(5, 6, 6)),
                     dtype=torch.float32, device=cuda)
    before = TK.LAUNCHES["stencil_generated"]
    got = TK.stencil_fused([a], None, custom, T=2, dt=0.1)
    assert TK.LAUNCHES["stencil_generated"] == before + 1
    assert torch.equal(got[0], spec_plain(custom, None, [a], 2, 0.1, cuda)[0])


@pytest.mark.parametrize("key", SPEC_KEYS)
def test_spec_kernel_chunks_and_passes_equal_plain(cuda, key):
    """K6 on given plans with x and z chunk remainders, and T beyond one
    build's levels as passes of whole steps, == plain bitwise."""
    spec, p, flds, dt = spec_case(key, (13, 40, 70), cuda)
    X, Y, Z = 13, 40, 70
    pv = TK._spec_param_vectors(spec, p, cuda)
    ones = (torch.ones(X, device=cuda), torch.ones(Y, device=cuda))
    plain = spec_plain(spec, p, flds, 2, dt, cuda)
    for TY, CX, CZ in ((5, 4, 9), (3, 6, 20)):
        plan = TK.fused_plan_with_chunks(
            TK.spec_device_plan(cuda, X, Y, Z, spec, 2, 1, TY), X, Z,
            spec.stages * 2, CX=CX, CZ=CZ,
            knobs=TK.spec_plan_knobs(spec, 2))
        assert plan.n_cx > 1 and plan.n_cz > 1
        got = TK._stencil_fused_cuda([f[None] for f in flds], pv, spec, 2,
                                     dt, *ones, plan=plan)
        assert all(torch.equal(a[0], b) for a, b in zip(got, plain))
    for T in (3, 5):
        out = TK.stencil_fused(flds, p, spec, T=T, dt=dt)
        assert all(torch.equal(a, b) for a, b in
                   zip(out, spec_plain(spec, p, flds, T, dt, cuda)))


@pytest.mark.parametrize("key", SPEC_KEYS)
def test_spec_kernel_builds_do_not_spill(cuda, key):
    """Each K6 build a plan at the paper's grid launches: no local memory,
    its launch bound the build table's, and the plan's resident blocks the
    card's."""
    spec = spec_case(key, (4, 8, 8), cuda)[0]
    op, stages = TK._cuda_instantiation(spec)
    for T in sorted({Tk for t in range(1, 5)
                     for Tk in TK.spec_passes(spec, t)}):
        for y_tile in (None, 8, 16):
            plan = TK.spec_device_plan(cuda, 1024, 1024, 64, spec, T, 1,
                                       y_tile)
            a = TK.spec_kernel_attrs(cuda, spec, T, plan)
            assert a["local_bytes"] == 0, (T, y_tile, a)
            assert a["max_threads"] == \
                _build.K6_BUILDS[op, stages][plan.cells_per_thread]
            assert a["blocks_per_sm"] == plan.blocks_per_sm >= 1


@pytest.mark.parametrize("name", ["hyperdiff4", "smag_cross", "moist6",
                                  "tvd_vl", "sqrt_div"])
@pytest.mark.parametrize("integ", ["euler", "rk2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_shapes_kernel_equals_plain(cuda, name, integ, dtype):
    """K6 generated for radius 2, x-diagonal reads, six fields and the
    limiter operations (`tests/_spec_shapes.py`) == its plain version on
    the card, bitwise, untiled and at y_tile 3, with masks, bf16 with bf16
    coefficients; one launch a pass."""
    from _spec_shapes import DT as SDT, np_fields, params, port_spec
    spec = port_spec(name, integ)
    X, Y, Z = 9, 10, 12
    flds = [torch.tensor(f).to(dtype).to(cuda)
            for f in np_fields("smag_cross" if name == "sqrt_div" else name,
                               (X, Y, Z), 11)]
    p = () if name == "sqrt_div" else params(name, Z, dtype, cuda)
    xm = torch.ones(X, device=cuda)
    ym = torch.ones(Y, device=cuda)
    xm[3] = 0.0
    pv = TK._spec_param_vectors(spec, p, cuda, dtype)
    dt = SDT.get(name, 0.1)
    want = TK._stencil_fused_plain([f[None] for f in flds], pv, spec, 3, dt,
                                   xm, ym)
    for y_tile in (None, 3):
        before = TK.LAUNCHES["stencil_generated"]
        got = TK.stencil_fused(flds, p, spec, T=3, dt=dt, y_tile=y_tile,
                               x_interior_mask=xm, y_interior_mask=ym)
        assert TK.LAUNCHES["stencil_generated"] == before + len(
            TK.spec_passes(spec, 3))
        assert all(torch.equal(a, b[0]) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in zip(got, flds))


# ---------------------------------------------------------------------------
# flash attention (K8)
# ---------------------------------------------------------------------------


def attn(shape_q, shape_kv, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=device).to(dtype)
            for s in (shape_q, shape_kv, shape_kv)]



@pytest.mark.parametrize("Sq,Skv,D,causal,bq,bk", [
    (256, 256, 64, True, 128, 128), (128, 128, 32, False, 64, 64),
    (128, 256, 64, True, 64, 128), (256, 128, 128, True, 128, 64),
    (13, 13, 128, True, 128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_equals_plain(cuda, Sq, Skv, D, causal, bq, bk, dtype):
    """Within 1e-5 (f32, the SIMT kernel) or `bf16_bound` (bf16, the
    tensor-core kernel)."""
    q, k, v = attn((2, 8, Sq, D), (2, 2, Skv, D), dtype, cuda)
    before = dict(TA.LAUNCHES)
    got = TA.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert TA.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert TA.LAUNCHES["flash_attention_tc"] == \
        before["flash_attention_tc"] + (dtype == torch.bfloat16)
    plain = TA._flash_attention_plain(q, k, v, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        assert float((got - plain).abs().max()) <= 1e-5
    else:
        assert TA.within_bf16_bound(got, plain, q, k, v, causal)


GQA_F32_SHAPES = ((2, 40, 2, 5, 64), (2, 40, 2, 64), (2, 40, 2, 64))


def gqa_f64(q5, k4, v4):
    """The gqa-layout case in f64 on the CPU: the value both f32 sides
    round."""
    B, S, K, G, D = q5.shape
    s = torch.einsum("bqkgd,bskd->bkgqs", q5.double(), k4.double()) \
        * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(mask, s, torch.full_like(s, -2.0 ** 30))
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), v4.double())
    return o


def gqa_plain(q5, k4, v4):
    """K8's plain version of the gqa-layout case where the tensors lie,
    through `_flash_attention_plain` on (B, H, S, D) views, back in the
    (B, S, K, G, D) layout."""
    B, S, K, G, D = q5.shape
    q = q5.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, D)
    o = TA._flash_attention_plain(q, k4.permute(0, 2, 1, 3),
                                  v4.permute(0, 2, 1, 3), True, D ** -0.5)
    return o.reshape(B, K, G, S, D).permute(0, 3, 1, 2, 4)


def gqa_miss(got, want, exact, cpu) -> str:
    """What a miss of the gqa-layout case keeps: the largest |card -
    plain|, its index, and there the card's value, the plain version's on
    the card and on the CPU, and the f64 value, so that the report says
    which side moved."""
    d = (got - want).abs()
    i = np.unravel_index(int(d.argmax()), tuple(d.shape))
    return (f"max |card - plain| {float(d.max()):.3e} at {tuple(map(int, i))}"
            f": card {float(got[i]):.9e}, plain {float(want[i]):.9e} (on the "
            f"CPU {float(cpu[i]):.9e}), f64 {float(exact[i]):.9e}; max |card "
            f"- f64| {float((got.double() - exact).abs().max()):.3e}, max "
            f"|plain - f64| {float((want.double() - exact).abs().max()):.3e}")


def gqa_case(seed, cuda):
    """The gqa-layout f32 case of `seed`: (card, plain on the card, f64,
    the CPU inputs), all on the CPU."""
    rng = np.random.default_rng(seed)
    q5, k4, v4 = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                  for s in GQA_F32_SHAPES)
    on_card = [t.to(cuda) for t in (q5, k4, v4)]
    got = TOPS.gqa_layout_attention(*on_card).cpu()
    want = gqa_plain(*on_card).cpu()
    return got, want, gqa_f64(q5, k4, v4), (q5, k4, v4)


def test_flash_kernel_gqa_layout_equals_plain(cuda):
    """Within 1e-5 of the plain version on the card and of the f64 value;
    a miss reports its size, index and the values there (`gqa_miss`). The
    plain version runs on the card, as in the other K8 tests: in a run of
    these tests after a full `chip_smoke.py`, the plain version on the CPU
    came out 6.47e-5 from f64 at one element, once, where the card was
    8.5e-7 from it (ROADMAP Queue 3)."""
    got, want, exact, cpu_in = gqa_case(1, cuda)
    assert float((got - want).abs().max()) <= 1e-5, \
        gqa_miss(got, want, exact, gqa_plain(*cpu_in))
    assert float((got.double() - exact).abs().max()) <= 1e-5, \
        gqa_miss(got, want, exact, gqa_plain(*cpu_in))


# (B, H, Hkv, Sq, Skv, D, causal): every head dim the configs name, the
# serving path's ragged prompts (13, 23) and 2048 tokens, Sq != Skv both
# ways, GQA groups 1, 5 and 8
TC_CASES = [
    (1, 8, 1, 128, 128, 64, True), (2, 4, 4, 256, 256, 64, False),
    (1, 40, 8, 13, 13, 128, True), (1, 40, 8, 23, 23, 128, True),
    (1, 40, 8, 2048, 2048, 128, True), (1, 10, 2, 100, 300, 128, True),
    (1, 10, 2, 300, 100, 128, True), (1, 10, 2, 100, 300, 128, False),
    (2, 8, 8, 77, 77, 192, True), (1, 4, 2, 512, 512, 192, False),
    (1, 16, 2, 2048, 2048, 192, True), (1, 8, 1, 23, 23, 256, True),
    (1, 4, 1, 640, 640, 256, True), (1, 4, 4, 130, 70, 256, False),
    (1, 8, 1, 2048, 2048, 256, True), (2, 10, 2, 40, 40, 16, True)]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", TC_CASES)
def test_tc_kernel_equals_plain(cuda, B, H, Hkv, Sq, Skv, D, causal):
    """The tensor-core kernel (bf16) within `bf16_bound` of the plain
    version, one launch of it."""
    q, k, v = attn((B, H, Sq, D), (B, Hkv, Skv, D), torch.bfloat16, cuda,
                   seed=Sq + D)
    before = TA.LAUNCHES["flash_attention_tc"]
    got = TA.flash_attention(q, k, v, causal=causal, block_q=Sq, block_k=Skv)
    assert TA.LAUNCHES["flash_attention_tc"] == before + 1
    plain = TA._flash_attention_plain(q, k, v, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert TA.within_bf16_bound(got, plain, q, k, v, causal)


class _Recorder:
    """The kernel library with K8's entry points recording their pointer
    arguments."""

    def __init__(self, lib):
        self.lib, self.pointers = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("flash_attention"):
            return fn

        def call(*args):
            self.pointers.append(args[:4])
            return fn(*args)
        return call


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,K,G,D", [(1, 23, 8, 5, 128),
                                       (2, 256, 2, 4, 192)])
def test_flash_kernel_strided_path_makes_no_copy(cuda, monkeypatch, dtype, B,
                                                 S, K, G, D):
    """`gqa_layout_attention` on the card: the kernel reads the model's
    (B, S, K, G, D) q and (B, S, K, D) k, v in place and writes the
    contiguous (B, S, K, G, D) output, the one allocation of the call;
    equal (bitwise) to the (B, H, S, D) path through `mha`."""
    from repro_torch import _build
    rec = _Recorder(_build.load())
    monkeypatch.setattr(_build, "load", lambda: rec)
    q5, k4, v4 = attn((B, S, K, G, D), (B, S, K, D), dtype, cuda, seed=S)
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = TOPS.gqa_layout_attention(q5, k4, v4)
    n1 = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert n1 - n0 == 1
    assert out.is_contiguous() and out.shape == (B, S, K, G, D)
    assert rec.pointers == [(q5.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                             out.data_ptr())]
    q = q5.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, D).contiguous()
    k, v = (t.permute(0, 2, 1, 3).contiguous() for t in (k4, v4))
    ref = TOPS.mha(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, D),
                       ref)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_flash_kernel_gqa_layout_equals_plain_over_seeds(cuda, seed):
    """The gqa-layout f32 case repeated over seeds: within 1e-5 of the
    plain version on the card, and the card no farther from the f64 value
    than that plain version is plus 1e-5."""
    got, want, exact, cpu_in = gqa_case(seed, cuda)
    assert float((got - want).abs().max()) <= 1e-5, \
        gqa_miss(got, want, exact, gqa_plain(*cpu_in))
    assert float((got.double() - exact).abs().max()) <= \
        float((want.double() - exact).abs().max()) + 1e-5, \
        gqa_miss(got, want, exact, gqa_plain(*cpu_in))


def test_flash_kernel_f32_repeats_within_tolerance(cuda):
    """K8's f32 cases run 200 times (even runs the tests' fixed seeds, odd
    runs a new seed each): the gqa-layout case and the f32 cases of
    `test_flash_kernel_equals_plain`. Prints the worst element of each
    case (index, card, plain, f64) and holds every run within 1e-5."""
    cases = [(Sq, Skv, D, causal, bq, bk) for Sq, Skv, D, causal, bq, bk in (
        (256, 256, 64, True, 128, 128), (128, 128, 32, False, 64, 64),
        (128, 256, 64, True, 64, 128), (256, 128, 128, True, 128, 64),
        (13, 13, 128, True, 128, 128))]
    worst = {}
    for run in range(200):
        seed = 1 if run % 2 == 0 else 1000 + run
        rng = np.random.default_rng(seed)
        q5, k4, v4 = (torch.as_tensor(rng.normal(size=s),
                                      dtype=torch.float32)
                      for s in GQA_F32_SHAPES)
        got = TOPS.gqa_layout_attention(q5.to(cuda), k4.to(cuda),
                                        v4.to(cuda)).cpu()
        want = TOPS.gqa_layout_attention(q5, k4, v4)
        results = [("gqa", got, want, lambda: gqa_f64(q5, k4, v4))]
        for Sq, Skv, D, causal, bq, bk in cases:
            q, k, v = attn((2, 8, Sq, D), (2, 2, Skv, D), torch.float32,
                           "cpu", seed=0 if run % 2 == 0 else seed)
            g = TA.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                   causal=causal, block_q=bq,
                                   block_k=bk).cpu()
            w = TA._flash_attention_plain(q, k, v, causal, D ** -0.5)
            f64 = (lambda q=q, k=k, v=v, causal=causal, D=D:
                   TA._flash_attention_plain(q.double(), k.double(),
                                             v.double(), causal, D ** -0.5))
            results.append(((Sq, Skv, D, causal, bq, bk), g, w, f64))
        for name, g, w, f64 in results:
            e = float((g - w).abs().max())
            if e > worst.get(name, (-1.0,))[0]:
                i = int((g - w).abs().argmax())
                idx = np.unravel_index(i, tuple(g.shape))
                exact = float(f64().reshape(-1)[i])
                worst[name] = (e, run, seed, idx, float(g.reshape(-1)[i]),
                               float(w.reshape(-1)[i]), exact)
    for name, (e, run, seed, idx, g, w, exact) in worst.items():
        print(f"K8 f32 {name}: worst |card - plain| {e:.3e} in 200 runs "
              f"(run {run}, seed {seed}) at {tuple(map(int, idx))}: card "
              f"{g!r}, plain {w!r}, f64 {exact!r}")
    assert all(e <= 1e-5 for e, *_ in worst.values())


def test_flash_kernel_refuses_tiles_over_budget(cuda):
    """256 x 256 blocks at head dim 128, once refused for shared memory,
    run: bf16 on the tensor-core kernel (its own tiles) within
    `bf16_bound`, f32 on the SIMT kernel at tiles capped to 128 x 128
    within 1e-5; and head dim 192 in f32 (tiles capped to 64 x 64)."""
    for D, bq, dtype in ((128, 256, torch.bfloat16), (128, 256, torch.float32),
                         (192, 128, torch.float32)):
        q, k, v = attn((1, 2, 512, D), (1, 2, 512, D), dtype, cuda)
        before = TA.LAUNCHES["flash_attention"]
        got = TA.flash_attention(q, k, v, block_q=bq, block_k=bq)
        plain = TA._flash_attention_plain(q, k, v, True, D ** -0.5)
        torch.cuda.synchronize()
        assert TA.LAUNCHES["flash_attention"] == before + 1
        if dtype == torch.float32:
            assert float((got - plain).abs().max()) <= 1e-5
        else:
            assert TA.within_bf16_bound(got, plain, q, k, v)


# ---------------------------------------------------------------------------
# selective scan (K9)
# ---------------------------------------------------------------------------

# the kernel and its plain version sum y over n in different orders and
# their exp may differ by an ulp: within 1e-4 of the larger of 1 and the
# largest |value| (the reference's kernel-vs-oracle tolerance)
SCAN_TOL = 1e-4


def scan_inputs(B, S, D, N, device, dtype=torch.float32, dt_dtype=None,
                seed=0, dt_scale=0.1):
    rng = np.random.default_rng(seed)
    t = lambda a, dt_: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                       device=device).to(dt_)
    return (t(rng.normal(size=(B, S, D)), dtype),
            t(np.abs(rng.normal(size=(B, S, D))) * dt_scale,
              dt_dtype or dtype),
            t(rng.normal(size=(B, S, N)), dtype),
            t(rng.normal(size=(B, S, N)), dtype),
            t(-np.abs(rng.normal(size=(D, N))), torch.float32),
            t(rng.normal(size=(B, D, N)) * 0.1, torch.float32))


def scan_close(got, want) -> bool:
    return all(float((g - w).abs().max())
               <= SCAN_TOL * max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("B,S,D,N,chunk", [
    (2, 64, 16, 8, 16), (1, 128, 32, 4, 32), (2, 96, 8, 16, 48),
    (1, 64, 16, 16, 64),                   # the reference's CASES
    (1, 13, 64, 16, 13), (2, 23, 40, 16, 23), (1, 4, 37, 4, 4),
    (1, 48, 20, 1, 16), (1, 32, 16, 40, 32)])
@pytest.mark.parametrize("dtype,dt_dtype", [
    (torch.float32, None), (torch.bfloat16, torch.float32),
    (torch.bfloat16, None)])
def test_scan_kernel_equals_plain(cuda, B, S, D, N, chunk, dtype, dt_dtype):
    args = scan_inputs(B, S, D, N, cuda, dtype, dt_dtype)
    before = TS.LAUNCHES["selective_scan"]
    got = TS.selective_scan(*args, chunk=chunk)
    assert TS.LAUNCHES["selective_scan"] == before + 1
    want = TS._selective_scan_plain(*args)
    torch.cuda.synchronize()
    assert all(g.dtype == torch.float32 for g in got)
    assert got[0].shape == (B, S, D) and got[1].shape == (B, D, N)
    assert scan_close(got, want)


def test_scan_kernel_chains_through_h0(cuda):
    """Two half-length scans chained == one full scan."""
    xc, dt, Bm, Cm, A, h0 = scan_inputs(1, 64, 24, 16, cuda, seed=5)
    y, h = TS.selective_scan(xc, dt, Bm, Cm, A, h0, chunk=16)
    y1, h1 = TS.selective_scan(xc[:, :32], dt[:, :32], Bm[:, :32],
                               Cm[:, :32], A, h0, chunk=16)
    y2, h2 = TS.selective_scan(xc[:, 32:], dt[:, 32:], Bm[:, 32:],
                               Cm[:, 32:], A, h1, chunk=16)
    assert scan_close((torch.cat([y1, y2], 1), h2), (y, h))


def test_scan_kernel_refusals(cuda):
    before = dict(TS.LAUNCHES)
    args = scan_inputs(1, 96, 16, 16, cuda)
    with pytest.raises(ValueError, match="multiple of chunk"):
        TS.selective_scan(*args, chunk=64)
    args = scan_inputs(1, 8, 4, 129, cuda)
    with pytest.raises(ValueError, match="at most 128 states"):
        TS.selective_scan(*args, chunk=8)
    with pytest.raises(ValueError, match="lanes a d"):
        TS.scan_device_plan(cuda, 1, 64, 16, 16, torch.float32,
                            torch.float32, lanes=3)
    assert TS.LAUNCHES == before


def test_scan_kernel_runs_a_chunk_once_over_shared_memory(cuda):
    """(1, 1024, 16, 16) at chunk 1024, which the first kernel refused for
    its shared memory, runs == plain: the staging follows the plan's tile,
    not the chunk."""
    args = scan_inputs(1, 1024, 16, 16, cuda)
    before = TS.LAUNCHES["selective_scan"]
    got = TS.selective_scan(*args, chunk=1024)
    assert TS.LAUNCHES["selective_scan"] == before + 1
    assert scan_close(got, TS._selective_scan_plain(*args))


def scan_f64(xc, dt, Bmat, Cmat, A, h0):
    xc, dt, Bmat, Cmat, A, h = (t.double()
                                for t in (xc, dt, Bmat, Cmat, A, h0))
    ys = []
    for t in range(xc.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * xc[:, t])[..., None] * Bmat[:, t, None, :]
        ys.append((h * Cmat[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("B,S,D,N,chunk,dt_scale", [
    (1, 256, 64, 16, 16, 0.1),     # chunk below the plan's tile (64)
    (1, 256, 64, 16, 64, 0.1),     # chunk at the tile
    (1, 256, 64, 16, 256, 0.1),    # chunk above the tile
    (1, 200, 48, 16, 40, 0.1),     # S not a multiple of the tile
    (2, 512, 40, 16, 512, 50.0),   # dt large: a -> 0
    (2, 512, 40, 16, 512, 1e-6),   # dt tiny: a -> 1
    (2, 96, 37, 5, 32, 0.1), (2, 64, 8200, 40, 64, 0.1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_edge_cases_against_plain_and_f64(cuda, B, S, D, N,
                                                      chunk, dt_scale,
                                                      dtype):
    args = scan_inputs(B, S, D, N, cuda, dtype, torch.float32, seed=S + D,
                       dt_scale=dt_scale)
    got = TS.selective_scan(*args, chunk=chunk)
    assert scan_close(got, TS._selective_scan_plain(*args))
    assert scan_close(got, scan_f64(*args))


@pytest.mark.parametrize("lanes,steps", [
    (4, 1), (4, 8), (8, 2), (16, 8), (16, 4), (32, 2), (32, 1)])
def test_scan_kernel_plans_equal_plain(cuda, lanes, steps):
    """Lanes and steps other than the plan's own, N odd (the last state
    walked alone), a ragged last tile: == plain."""
    args = scan_inputs(2, 150, 40, 7, cuda, torch.bfloat16, torch.float32)
    plan = TS.scan_device_plan(cuda, 2, 150, 40, 7, torch.bfloat16,
                               torch.float32, lanes=lanes, steps=steps)
    got = TS._selective_scan_cuda(*args, plan)
    assert (plan.lanes, plan.steps) == (lanes, steps)
    assert scan_close(got, TS._selective_scan_plain(*args))


def test_ssm_model_pallas_equals_chunked_on_the_card(cuda):
    """The falcon-mamba smoke model in f32: K9 on the card == the chunked
    scan within the reference's model gate (1e-3)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import random_params
    from repro_torch.models import model as TM
    cfg = get_smoke_config("falcon-mamba-7b").replace(
        compute_dtype="float32")
    params = random_params(cfg, cuda)
    layout = TM.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)), device=cuda)
    before = TS.LAUNCHES["selective_scan"]
    fp = TM.forward(params, {"inputs": toks},
                    cfg.replace(attention_impl="pallas"), layout)[0]
    assert TS.LAUNCHES["selective_scan"] == before + cfg.n_layers
    fc = TM.forward(params, {"inputs": toks}, cfg, layout)[0]
    assert float((fp - fc).abs().max()) < 1e-3


# --- the band exchange (K7) on a loopback mesh -------------------------------

K7_CASES = [  # nx, ny, axis, dim, shape, depth
    (1, 2, "y", 1, (5, 6, 8), 2), (2, 1, "x", 0, (4, 6, 8), 3),
    (2, 2, "x", 0, (4, 6, 8), 1), (2, 2, "y", 1, (6, 4, 12), 4),
    (1, 4, "y", 1, (5, 3, 4), 7), (3, 1, "x", 0, (3, 5, 6), 7),
    (2, 2, "y", 0, (6, 5, 5), 2), (2, 2, "y", 1, (6, 3, 8), 5),
    (4, 1, "x", 0, (2, 5, 8), 5)]


def loopback_cuda(nx, ny):
    from repro_torch.launch.mesh import make_stencil_mesh
    return make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))


@pytest.mark.parametrize("nx,ny,axis,dim,shape,depth", K7_CASES)
def test_band_exchange_kernel_equals_plain_bitwise(cuda, nx, ny, axis, dim,
                                                   shape, depth):
    """Four blocks on the same buffers, tables and counters, both slots:
    every extended buffer, interior included, == the plain version's bit
    for bit; the slot block 0 did not write keeps its fill; one put per
    card and exchange (all shards share cuda:0, so one, and no enter or
    wait); no error word is set. Blocks 2 and 3 pass the slot's interior
    views, so only the bands move."""
    mesh = loopback_cuda(nx, ny)
    got = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5)
    want = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5)
    for block in range(4):
        slot = block % 2
        shards = [fields(shape, 10 * block + s, cuda)
                  for s in range(nx * ny)]
        src = (shards, shards)
        if block >= 2:
            for sl in (got, want):
                for own, new in zip(sl.interior(slot), shards):
                    for a, b in zip(own, new):
                        a.copy_(b)
            src = (got.interior(slot), want.interior(slot))
        before = dict(TK.LAUNCHES)
        TK.halo_band_exchange_dma(src[0], mesh=mesh, axis=axis, depth=depth,
                                  dim=dim, block_index=block, slabs=got)
        assert TK.LAUNCHES["band_exchange"] == before["band_exchange"] + 1
        assert TK.LAUNCHES["band_handshake"] == before["band_handshake"]
        TK._band_exchange_plain(src[1], want,
                                want.table(axis, slot, src[1]))
        torch.cuda.synchronize()
        got.check()
        assert got.epoch == block + 1
        assert all(int(w[2]) == 0 for w in got.words)
        for a, b in zip(got.buffers.bufs, want.buffers.bufs):
            assert torch.equal(a, b)
            if block == 0:
                assert bool((a[:, 1] == -3.5).all())


@pytest.mark.parametrize("nx,ny,axis,dim,shape,depth", [
    (2, 1, "x", 0, (4, 6, 8), 3), (1, 2, "y", 1, (5, 3, 4), 5),
    (2, 2, "y", 1, (6, 4, 12), 4)])
def test_band_exchange_across_cards_equals_plain_bitwise(cuda, nx, ny, axis,
                                                         dim, shape, depth):
    """Shards on distinct cards (peer stores, an enter and a wait per card
    and exchange): four blocks, both slots, == the plain version on the
    same layout bitwise, no error word set."""
    n = nx * ny
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")
    from repro_torch.launch.mesh import make_stencil_mesh
    mesh = make_stencil_mesh(nx, ny)
    got = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5)
    want = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5)
    for block in range(4):
        shards = [fields(shape, 20 * block + s, f"cuda:{s}")
                  for s in range(n)]
        before = dict(TK.LAUNCHES)
        TK.halo_band_exchange_dma(shards, mesh=mesh, axis=axis, depth=depth,
                                  dim=dim, block_index=block, slabs=got)
        assert TK.LAUNCHES["band_exchange"] == before["band_exchange"] + n
        assert TK.LAUNCHES["band_handshake"] == \
            before["band_handshake"] + 2 * n
        TK._band_exchange_plain(shards, want,
                                want.table(axis, block % 2, shards))
        for s in range(n):
            torch.cuda.synchronize(s)
        got.check()
        for a, b in zip(got.buffers.bufs, want.buffers.bufs):
            assert torch.equal(a, b)


def test_band_kernel_reports_its_build(cuda):
    """The put kernel's limits as the source was built == the wrapper's,
    and it fits several blocks an SM without spilling."""
    attrs = TK.band_kernel_attrs(cuda)
    assert (attrs["threads"], attrs["tile_units"], attrs["max_sources"],
            attrs["max_partners"]) == (TK.BAND_THREADS, TK.BAND_TILE_UNITS,
                                       TK.BAND_MAX_SOURCES,
                                       TK.BAND_MAX_PARTNERS)
    assert attrs["blocks_per_sm"] >= 4 and attrs["local_bytes"] == 0


def test_distributed_run_puts_once_per_card_and_phase(cuda):
    """A (2, 2) loopback run of 3 blocks: K7 launches one put per phase
    and block (6), no enter or wait, and K1 reads the buffers K7 filled."""
    from repro_torch.stencil import distributed as TD
    mesh = loopback_cuda(2, 2)
    u, v, w = fields((8, 12, 16), 5, cuda)
    p = TREF.default_params(16, device=cuda)
    run = TD.make_distributed_run(mesh, p, n_blocks=3, T=2, dt=DT,
                                  exchange="remote_dma", overlap=True,
                                  local_kernel="fused")
    TK.reset_launch_counts()
    out = run(TD.shard(mesh, u, v, w))
    torch.cuda.synchronize()
    assert TK.LAUNCHES["band_exchange"] == 6
    assert TK.LAUNCHES["band_handshake"] == 0
    assert TK.LAUNCHES["advect_fused"] == 24
    want = TD.make_distributed_run(mesh, p, n_blocks=3, T=2, dt=DT,
                                   exchange="collective", overlap=True,
                                   local_kernel="fused")(
        TD.shard(mesh, u, v, w))
    assert all(torch.equal(a, b) for sa, sb in zip(out, want)
               for a, b in zip(sa, sb))


def test_distributed_step_on_the_card_equals_cpu(cuda):
    """A (2, 2) loopback mesh on the card: remote_dma (K7 + K1) ==
    collective == the CPU plain versions, bitwise; both integrity knobs
    are refused with remote_dma, as K7 carries neither."""
    from repro_torch.stencil import distributed as TD
    mesh = loopback_cuda(2, 2)
    cpu_mesh = type(mesh)((2, 2), (torch.device("cpu"),) * 4)
    u, v, w = fields((8, 12, 16), 4, "cpu")
    p = TREF.default_params(16, device="cpu")
    outs = []
    for m, ex in ((mesh, "remote_dma"), (mesh, "collective"),
                  (cpu_mesh, "remote_dma")):
        run = TD.make_distributed_run(m, p, n_blocks=3, T=2, dt=DT,
                                      exchange=ex, overlap=True,
                                      local_kernel="fused")
        outs.append([f.cpu() for f in TD.gather(m, run(TD.shard(m, u, v,
                                                                  w)))])
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))
    with pytest.raises(RuntimeError, match="checksum channel"):
        TD.make_distributed_step(mesh, p, exchange="remote_dma",
                                 verify_integrity=True)
    with pytest.raises(RuntimeError, match="injection hook"):
        TD.make_distributed_step(mesh, p, exchange="remote_dma",
                                 corrupt_halo=(0, 1, 0.0))


@pytest.mark.parametrize("T", [10, 14])
def test_distributed_multi_hop_fused_on_the_card_equals_cpu(cuda, T):
    """The reference's multi-hop cases with the fused local kernel: T deeper
    than a shard's rows and K1's build, on a (1, 4) loopback mesh; both
    engines == the CPU plain versions, bitwise."""
    from repro_torch.stencil import distributed as TD
    mesh = loopback_cuda(1, 4)
    cpu_mesh = type(mesh)((1, 4), (torch.device("cpu"),) * 4)
    u, v, w = fields((6, 16, 12), 6, "cpu")
    p = TREF.default_params(12, device="cpu")
    outs = []
    for m, ex in ((mesh, "remote_dma"), (mesh, "collective"),
                  (cpu_mesh, "collective")):
        step = TD.make_distributed_step(m, p, T=T, dt=DT, exchange=ex,
                                        local_kernel="fused")
        outs.append([f.cpu() for f in TD.gather(m, step(TD.shard(m, u, v,
                                                                   w)))])
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))
    assert all(torch.equal(a, b) for a, b in zip(outs[1], outs[2]))


def test_kernels_launch_on_the_cards_of_their_tensors(cuda):
    """On a card other than the current one, K1 and K4 launch there (the
    wrapper makes that card current around its launch) and equal their
    plain versions bitwise."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    dev = "cuda:1"
    u, v, w = fields((6, 10, 12), 3, dev)
    p = TREF.default_params(12, device=dev)
    got = TK.advect_fused(u, v, w, p, T=2, dt=DT, y_tile=4)
    plain = TK._advect_fused_plain(u[None], v[None], w[None], p, 2, DT,
                                   torch.ones(6, device=dev),
                                   torch.ones(10, device=dev))
    torch.cuda.synchronize(dev)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, plain))
    assert torch.equal(TK.finite_guard(*got), TK._finite_guard_plain(*got))


# -- the stencil serving engine (K5 at B > 1, K4 per slot) -------------------

def stencil_serve(device, plan=None, batch_size=4):
    from repro_torch.launch.serve import (STENCIL_DT, STENCIL_SHAPES,
                                          stencil_requests)
    from repro_torch.serving.stencil_engine import StencilServingEngine
    from repro_torch.stencil.advection import AdvectionDomain

    X, Y, Z, T = STENCIL_SHAPES[True]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=T, dt=STENCIL_DT,
                          device=device)
    eng = StencilServingEngine(dom, batch_size=batch_size, fault_plan=plan)
    TK.reset_launch_counts()
    done = eng.run(stencil_requests(X, Y, Z, 8, 16))
    torch.cuda.synchronize()
    return eng, done, dict(TK.LAUNCHES)


@pytest.mark.parametrize("batch_size", [4, 8])
def test_stencil_engine_padded_equals_sequential_on_the_card(cuda,
                                                            batch_size):
    from repro_torch.launch.serve import STENCIL_DT, STENCIL_SHAPES

    eng, done, launches = stencil_serve(cuda, batch_size=batch_size)
    n = eng.megasteps_executed
    assert launches == {**{k: 0 for k in launches}, "advect_fused": n,
                        "finite_guard": n}
    Z, T = STENCIL_SHAPES[True][2:]
    p = TREF.default_params(Z, device=cuda)
    for req in done.values():
        assert req.status == "done" and len(req.states) == req.n_steps
        u, v, w = TREF.fields_from_numpy(req.u, req.v, req.w, device=cuda)
        for state in req.states:
            u, v, w = TK.advect_fused(u, v, w, p, T=T, dt=STENCIL_DT)
            assert all(np.array_equal(s, f.cpu().numpy())
                       for s, f in zip(state, (u, v, w)))


@pytest.mark.parametrize("batch_size", [4, 8])
def test_stencil_engine_guard_flags_equal_plain_on_the_card(cuda,
                                                           batch_size):
    from repro_torch.launch.serve import (STENCIL_DT, STENCIL_SHAPES,
                                          stencil_requests)
    from repro_torch.serving.stencil_engine import StencilServingEngine
    from repro_torch.stencil.advection import AdvectionDomain

    X, Y, Z, T = STENCIL_SHAPES[False]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=T, dt=STENCIL_DT,
                          device=cuda)
    eng = StencilServingEngine(dom, batch_size=batch_size)
    for slot, req in enumerate(stencil_requests(X, Y, Z, batch_size, 16)):
        eng._prime(slot, req)
    fields = (eng.u, eng.v, eng.w)
    flags = TK.finite_guard(*fields)
    assert torch.equal(flags, TK._finite_guard_plain(*fields))
    assert bool((flags == 1.0).all())
    Xr, Yr = eng._extent[1]
    eng.w[1, Xr // 2, Yr - 1, Z // 2] = float("inf")
    flags = TK.finite_guard(*fields)
    want = torch.ones_like(flags)
    want[1, Xr // 2] = 0.0
    assert torch.equal(flags, TK._finite_guard_plain(*fields))
    assert torch.equal(flags, want)


def test_stencil_engine_faults_on_the_card_equal_the_cpu_run(cuda):
    plan = "nan_poison@1:slot=1;device_loss@2:reshard_to=1"
    _, clean, _ = stencil_serve(cuda)
    eng, done, launches = stencil_serve(cuda, plan)
    cpu_eng, cpu_done, _ = stencil_serve("cpu", plan)
    assert eng.health() == cpu_eng.health()
    assert eng.cache_stats() == cpu_eng.cache_stats()
    assert launches["advect_fused"] == launches["finite_guard"] == \
        eng.megasteps_executed
    [quid] = eng.health()["quarantined_uids"]
    for uid, req in done.items():
        assert req.status == cpu_done[uid].status
        if uid != quid:
            assert all(np.array_equal(a, b)
                       for a, b in zip(req.out, clean[uid].out))


# --- the rest of the distributed path: spec runs, checkpoints, recovery ----

@pytest.mark.parametrize("op,integrator,T", [("tracer", "euler", 2),
                                             ("diffusion", "rk2", 2)])
def test_distributed_spec_run_on_k6_equals_plain(cuda, op, integrator, T):
    """A (2, 2) loopback spec run of 2 blocks on the card: K6 twice per
    shard, pass and block (boundary and interior), no K1 or K7 launch, ==
    the CPU run (K6's plain version), bitwise."""
    from repro_torch.stencil import distributed as TD
    X, Y, Z = 8, 12, 16
    if op == "tracer":
        u, v, w = fields((X, Y, Z), 7, "cpu")
        flds = (u, v, w, TSP.tracer_field(X, Y, Z, device="cpu"))
        spec = TSP.tracer_advection_spec(integrator)
        sp, dt = TREF.default_params(Z, device="cpu"), DT
    else:
        flds = (TSP.diffusion_field(X, Y, Z, device="cpu"),)
        spec = TSP.diffusion_spec(integrator)
        sp, dt = TSP.default_diffusion_params(Z, device="cpu"), 1.0
    p = TREF.default_params(Z, device="cpu")
    mesh = loopback_cuda(2, 2)
    cpu_mesh = type(mesh)((2, 2), (torch.device("cpu"),) * 4)
    outs = []
    for m in (mesh, cpu_mesh):
        run = TD.make_distributed_run(m, p, n_blocks=2, T=T, dt=dt,
                                      local_kernel="fused", overlap=True,
                                      spec=spec, spec_params=sp)
        shards = TD.shard(m, *flds)
        TK.reset_launch_counts()
        out = run(shards)
        if m is mesh:
            torch.cuda.synchronize()
            passes = len(TK.spec_passes(spec, T))
            assert TK.LAUNCHES["stencil_fused"] == 2 * 4 * passes * 2
            assert TK.LAUNCHES["advect_fused"] == 0
            assert TK.LAUNCHES["band_exchange"] == 0
        outs.append([f.cpu() for f in TD.gather(m, out)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_distributed_spec_remote_dma_refused_on_the_card(cuda):
    from repro_torch.stencil import distributed as TD
    mesh = loopback_cuda(2, 2)
    p = TREF.default_params(16, device=cuda)
    spec = TSP.tracer_advection_spec()
    TK.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no band exchange kernel"):
        TD.make_distributed_run(mesh, p, n_blocks=2, exchange="remote_dma",
                                spec=spec, spec_params=p)
    assert sum(TK.LAUNCHES.values()) == 0


def test_checkpointed_run_resumes_bitwise_on_the_card(cuda, tmp_path):
    """PW on K1 and K7 over a (2, 2) loopback mesh: checkpointed == the
    plain run; stopped at block 3 and resumed to 4 == the same, bitwise."""
    from repro_torch.stencil import distributed as TD
    mesh = loopback_cuda(2, 2)
    u, v, w = fields((8, 12, 16), 8, cuda)
    p = TREF.default_params(16, device=cuda)
    kw = dict(T=2, dt=DT, local_kernel="fused", overlap=True,
              exchange="remote_dma")
    full = TD.gather(mesh, TD.make_distributed_run(mesh, p, n_blocks=4, **kw)(
        TD.shard(mesh, u, v, w)))
    ck = TD.make_distributed_run(mesh, p, n_blocks=4, checkpoint_every=2,
                                 checkpoint_dir=str(tmp_path / "ck"), **kw)
    assert all(torch.equal(a, b) for a, b in zip(
        full, TD.gather(mesh, ck(TD.shard(mesh, u, v, w)))))
    TD.make_distributed_run(mesh, p, n_blocks=3, checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "part"), **kw)(
        TD.shard(mesh, u, v, w))
    res = TD.resume_distributed_run(mesh, p, TD.shard(mesh, u, v, w),
                                    n_blocks=4,
                                    checkpoint_dir=str(tmp_path / "part"),
                                    **kw)
    assert all(f.device == torch.device("cuda", 0) for s in res for f in s)
    assert all(torch.equal(a, b) for a, b in zip(full, TD.gather(mesh, res)))


def test_reshard_keeps_every_shard_on_the_loopback_card(cuda, monkeypatch):
    """A device loss and a device return on a (1, 4) loopback mesh of
    cuda:0: every step the run builds lies on cuda:0 alone, and the result
    == the clean run, bitwise."""
    from repro_torch.serving import faults as TF
    from repro_torch.stencil import distributed as TD
    mesh = loopback_cuda(1, 4)
    assert set(TF._resized_mesh(mesh, 1, 2).devices) == {
        torch.device("cuda", 0)}
    u, v, w = fields((6, 16, 12), 9, cuda)
    p = TREF.default_params(12, device=cuda)
    kw = dict(n_blocks=4, T=2, dt=DT, local_kernel="fused")
    clean = TD.gather(mesh, TD.make_distributed_run(
        mesh, p, exchange="remote_dma", **kw)(TD.shard(mesh, u, v, w)))
    built = []
    real = TD.make_distributed_step

    def spy(m, params, **k):
        built.append((m.shape, set(m.devices)))
        return real(m, params, **k)

    monkeypatch.setattr(TD, "make_distributed_step", spy)
    plan = TF.FaultPlan.parse("device_loss@1:reshard_to=2;"
                              "device_loss@3:reshard_to=4")
    out, inj = TF.resilient_distributed_run(
        mesh, p, u, v, w, injector=TF.FaultInjector(plan), **kw)
    assert inj.health()["reshards"] == 2
    assert {s for s, _ in built} == {(1, 4), (1, 2)}
    assert all(d == {torch.device("cuda", 0)} for _, d in built)
    assert all(torch.equal(a, b) for a, b in zip(out, clean))


# the other model families: K8 at their prefill shapes (arctic's 56/8
# heads and qwen2-vl's 64/8 at 2048 tokens, whisper's 20/20 of 64 at 384),
# and one smoke-size forward per family on the card == the CPU's
FAMILY_K8 = [(1, 56, 8, 2048, 128), (1, 64, 8, 2048, 128),
             (1, 20, 20, 384, 64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D", FAMILY_K8)
def test_flash_kernel_at_the_families_shapes_equals_plain(cuda, B, H, Hkv,
                                                          S, D, dtype):
    """Causal, the model's default blocks: bf16 (the tensor-core kernel)
    within `bf16_bound`, f32 (the SIMT kernel) within 1e-5."""
    q, k, v = attn((B, H, S, D), (B, Hkv, S, D), dtype, cuda, seed=H + S)
    before = TA.LAUNCHES["flash_attention"]
    got = TA.flash_attention(q, k, v, causal=True)
    assert TA.LAUNCHES["flash_attention"] == before + 1
    plain = TA._flash_attention_plain(q, k, v, True, D ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert float((got - plain).abs().max()) <= 1e-5
    else:
        assert TA.within_bf16_bound(got, plain, q, k, v, True)


def family_batch(cfg, device):
    """A smoke-size input of `cfg`'s family, made from a seed with numpy."""
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        return {"enc_embeds": torch.as_tensor(rng.normal(
                    size=(2, 32, cfg.d_model)), dtype=torch.float32).to(device),
                "dec_inputs": torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, (2, 8))).to(device)}
    if cfg.embeds_input:
        pos = np.broadcast_to(np.arange(32)[None, :, None], (2, 32, 3)).copy()
        pos[:, :16, 1:] = np.stack([np.arange(16) // 4, np.arange(16) % 4], -1)
        return {"embeds": torch.as_tensor(rng.normal(
                    size=(2, 32, cfg.d_model)), dtype=torch.float32).to(device),
                "positions": torch.as_tensor(pos).to(device)}
    return {"inputs": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, 32))).to(device)}


@pytest.mark.parametrize("arch,k8", [
    ("recurrentgemma-9b", 0), ("arctic-480b", 2),
    ("llama4-maverick-400b-a17b", 2), ("qwen2-vl-72b", 2),
    ("whisper-large-v3", 2)])
def test_family_forward_on_the_card_equals_cpu(cuda, arch, k8):
    """Each family's smoke config, f32 compute, `pallas`, weights drawn on
    the CPU from seed 0 and copied: the card's prefill logits == the CPU's
    within 1e-4 (the f32 logit tolerance of the CPU tests), and K8
    launched once per causal self-attention layer (none on the hybrid's
    window, nor in whisper's encoder or cross-attention)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import random_params
    from repro_torch.models import model as TM
    from repro_torch.pspec import tree_map
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         attention_impl="pallas")
    layout = TM.make_layout(cfg, 1)
    params = random_params(cfg, "cpu")
    on_card = tree_map(lambda a: a.to(cuda), params, is_leaf=torch.is_tensor)
    want = TM.forward(params, family_batch(cfg, "cpu"), cfg, layout,
                      mode="prefill")[0]
    before = TA.LAUNCHES["flash_attention"]
    got = TM.forward(on_card, family_batch(cfg, cuda), cfg, layout,
                     mode="prefill")[0]
    torch.cuda.synchronize()
    assert TA.LAUNCHES["flash_attention"] == before + k8
    assert float((got.cpu() - want).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# training (slice G2a): the kernel routes are forward-only on the card too
# ---------------------------------------------------------------------------


def _grad_inputs(name, device):
    g = torch.Generator(device=device).manual_seed(0)
    if name in ("flash_attention", "gqa_layout_attention"):
        shape = (1, 4, 128, 64) if name == "flash_attention" else \
            (1, 128, 2, 2, 64)
        q = torch.randn(shape, generator=g, device=device)
        kv = (1, 2, 128, 64) if name == "flash_attention" else (1, 128, 2, 64)
        k = torch.randn(kv, generator=g, device=device)
        return q, k, torch.randn(kv, generator=g, device=device)
    B, S, D, N = 1, 32, 32, 4
    return (torch.randn(B, S, D, generator=g, device=device),
            torch.rand(B, S, D, generator=g, device=device) * 0.1,
            torch.randn(B, S, N, generator=g, device=device),
            torch.randn(B, S, N, generator=g, device=device),
            -torch.rand(D, N, generator=g, device=device),
            torch.zeros(B, D, N, device=device))


GRAD_ENTRY = {"flash_attention": TA.flash_attention,
              "gqa_layout_attention": TOPS.gqa_layout_attention,
              "selective_scan": TS.selective_scan,
              "mamba_scan": lambda *a: TSOPS.mamba_scan(*a, chunk=32)}


@pytest.mark.parametrize("name", sorted(GRAD_ENTRY))
def test_kernel_routes_refuse_grad_on_the_card(cuda, name):
    """On CUDA tensors the kernels' outputs carry no autograd history, so
    each entry point raises under grad; under no_grad it launches."""
    args = _grad_inputs(name, cuda)
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        GRAD_ENTRY[name](*args)
    with torch.no_grad():
        out = GRAD_ENTRY[name](*args)
    out = out if isinstance(out, tuple) else (out,)
    assert all(bool(torch.isfinite(o).all()) for o in out)


def test_train_step_repeats_bitwise_on_the_card(cuda):
    """A train step's loss and gradients on the card repeat bitwise (the
    resume gate rests on it: the embedding's backward sums in a fixed
    order), and are within 1e-4 of each leaf's largest of the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as TM
    from repro_torch.pspec import tree_leaves, tree_map
    from repro_torch.training import step as TSTEP
    cfg = get_smoke_config("qwen3-32b").replace(compute_dtype="float32")
    layout = TM.make_layout(cfg, 1)
    state = TSTEP.init_state(cfg, layout, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 65),
                         generator=torch.Generator().manual_seed(1))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    cpu = TSTEP.loss_and_grads(state["params"], batch, cfg, layout)
    on = lambda t: {k: v.to(cuda) for k, v in t.items()}  # noqa: E731
    params = tree_map(lambda t: t.to(cuda), state["params"],
                      is_leaf=torch.is_tensor)
    runs = [TSTEP.loss_and_grads(params, on(batch), cfg, layout)
            for _ in range(2)]
    leaves = lambda t: tree_leaves(t, is_leaf=torch.is_tensor)  # noqa
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[0][2]),
                                                  leaves(runs[1][2])))
    assert abs(float(runs[0][0]) - float(cpu[0])) < 1e-5
    for a, b in zip(leaves(runs[0][2]), leaves(cpu[2])):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max())


# ---------------------------------------------------------------------------
# the op layer (`kernels.library`) and the movement ledger on the card
# ---------------------------------------------------------------------------

def _op_vs_bare(cuda):
    """(name, through the op, through the bare launch function) per
    kernel at a probe shape."""
    from repro_torch.launch.mesh import make_stencil_mesh
    shape = (6, 10, 16)
    u, v, w = fields(shape, 11, cuda)
    p = TK._slot_params(TREF.default_params(16, device=cuda), 1, 16, cuda)
    p1 = TK._slot_params(TREF.default_params(16, device=cuda), None, 16,
                         cuda)
    xm, ym = torch.ones(6, device=cuda), torch.ones(10, device=cuda)
    ub, vb, wb = u[None], v[None], w[None]
    spec = TSP.tracer_advection_spec("rk2")
    q4 = torch.randn(6, 10, 16, device=cuda)
    pv = TK._spec_param_vectors(spec, TREF.default_params(16, device=cuda),
                                cuda)
    out = [
        ("advect_fused",
         lambda: TK._OP_K1(ub, vb, wb, *p, xm, ym, 3, DT, 0),
         lambda: TK._advect_fused_cuda(ub, vb, wb, p, 3, DT, xm, ym)),
        ("advect_blocked",
         lambda: TK._OP_K3(u, v, w, *p1, 0, True, DT),
         lambda: TK._advect_rung_cuda("advect_blocked", u, v, w, p1, None,
                                      True, DT)),
        ("advect_dataflow",
         lambda: TK._OP_K2(u, v, w, *p1, 0, False, False, DT),
         lambda: TK._advect_rung_cuda("advect_dataflow", u, v, w, p1, None,
                                      False, DT)),
        ("advect_wide",
         lambda: TK._OP_K2(u, v, w, *p1, 0, True, True, DT),
         lambda: TK._advect_rung_cuda("advect_wide", u, v, w, p1, None,
                                      True, DT)),
        ("finite_guard", lambda: TK._OP_K4(ub, vb, wb),
         lambda: TK._finite_guard_cuda(ub, vb, wb)),
        ("stencil_fused",
         lambda: TK._OP_K6([ub, vb, wb, q4[None]], list(pv), xm, ym,
                           TK.spec_handle(spec), 2, DT, 0),
         lambda: TK._stencil_fused_cuda([ub, vb, wb, q4[None]], pv, spec, 2,
                                        DT, xm, ym)),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, vv = (torch.randn(s, device=cuda).to(dtype)
                    for s in ((1, 4, 128, 64), (1, 2, 128, 64),
                              (1, 2, 128, 64)))

        def through_op(q=q, k=k, vv=vv):
            o = torch.empty_like(q)
            TA._OP_K8(q, k, vv, o, True, 0.125, 128, 128)
            return o
        out.append((f"flash_attention_{dtype}", through_op,
                    lambda q=q, k=k, vv=vv: TA._flash_attention_cuda(
                        q, k, vv, True, 0.125, 128, 128)))
    xc, dtt = (torch.randn(1, 64, 32, device=cuda) for _ in range(2))
    Bm, Cm = (torch.randn(1, 64, 16, device=cuda) for _ in range(2))
    A = -torch.rand(32, 16, device=cuda) - 0.5
    h0 = torch.zeros(1, 32, 16, device=cuda)
    args = (xc, 0.1 * dtt.abs(), Bm, Cm, A, h0)
    plan = TS.scan_device_plan(cuda, 1, 64, 32, 16, torch.float32,
                               torch.float32)
    out.append(("selective_scan", lambda: TS._OP_K9(*args),
                lambda: TS._selective_scan_cuda(*args, plan)))
    mesh = make_stencil_mesh(2, 2, devices=["cuda:0"] * 4)
    shards = [tuple(torch.randn(4, 6, 16, device=cuda) for _ in range(3))
              for _ in range(4)]

    def k7(bare):
        slabs = TK.BandSlabs(mesh, (4, 6, 16), 2, 1, fill=-1.0)
        if bare:
            table = slabs.table("y", 0, shards)
            TK._band_exchange_cuda(slabs, table, tuple(
                f.data_ptr() for trio in shards for f in trio))
        else:
            TK.halo_band_exchange_dma(shards, mesh=mesh, axis="y", depth=2,
                                      dim=1, slabs=slabs)
        return tuple(slabs.buffers.bufs)
    out.append(("band_exchange", lambda: k7(False), lambda: k7(True)))
    return out


def test_each_op_equals_its_bare_launch_bitwise(cuda):
    for name, op, bare in _op_vs_bare(cuda):
        before = {**TK.LAUNCHES, **TA.LAUNCHES, **TS.LAUNCHES}
        got = op()
        mid = {**TK.LAUNCHES, **TA.LAUNCHES, **TS.LAUNCHES}
        want = bare()
        after = {**TK.LAUNCHES, **TA.LAUNCHES, **TS.LAUNCHES}
        torch.cuda.synchronize()
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        # the op counts exactly what the bare launch counts
        assert {k: mid[k] - before[k] for k in mid} == \
            {k: after[k] - mid[k] for k in mid}, name


def test_fake_outputs_match_the_real_ones(cuda):
    from repro_torch.analysis import trace as TR
    for name, op, _ in _op_vs_bare(cuda):
        if name == "band_exchange":
            continue
        real = TR._results(op())
        fake_records = TR.record_ops(op)
        fake = next(r for r in reversed(fake_records) if r.op).results
        if not fake:   # K8 writes its `out` in place
            continue
        assert [(m.shape, m.dtype, m.device, m.stride) for m in fake] == \
            [(m.shape, m.dtype, m.device, m.stride) for m in real], name


def test_live_ledger_equals_fake_ledger_and_models(cuda):
    from repro_torch.analysis import ledger as LG
    from repro_torch.analysis import programs as PR
    from repro_torch.analysis import trace as TR
    for prog in PR.programs(small=True):
        with TR.fake_mode():
            fn, args = prog.build(cuda)
            fake = LG.MovementLedger.from_ops(TR.record_ops(fn, *args))
        fn, args = prog.build(cuda)
        live = LG.MovementLedger.from_ops(TR.record_ops(fn, *args,
                                                        execute=True))
        if prog.per_block:
            fake = fake.per_shard_block_totals(prog.n_shards)
            live = live.per_shard_block_totals(prog.n_shards)
        else:
            fake, live = fake.totals(), live.totals()
        assert live == fake, prog.name
        assert LG.check_model_coverage(live, prog.claims).ok, prog.name


# -- the bf16 PW path: K1/K5, K4, K3 and K2 on bf16 fields ---------------------

def bf16_inputs(shape, seed, device, coef):
    u, v, w = (f.to(torch.bfloat16) for f in fields(shape, seed, device))
    p = TREF.default_params(shape[2], device=device,
                            dtype=torch.float32 if coef == "f32"
                            else torch.bfloat16)
    return u, v, w, p


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(6, 10, 16), (5, 17, 12)])
@pytest.mark.parametrize("T", [1, 2, 4, 10])
def test_bf16_fused_kernel_bitwise_equals_plain(cuda, shape, T, coef):
    u, v, w, p = bf16_inputs(shape, 60, cuda, coef)
    X, Y, _ = shape
    xm = torch.ones(X, device=cuda)
    xm[1] = 0.0
    ym = torch.ones(Y, device=cuda)
    ym[Y // 2:] = 0.0
    before = TK.LAUNCHES["advect_fused"]
    got = TK.advect_fused(u, v, w, p, T=T, dt=DT, x_interior_mask=xm,
                          y_interior_mask=ym)
    assert TK.LAUNCHES["advect_fused"] == before + len(TK.fused_passes(T))
    plain = TK._advect_fused_plain(u[None], v[None], w[None], p, T, DT, xm,
                                   ym)
    torch.cuda.synchronize()
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b[0])
               for a, b in zip(got, plain))
    for y_tile in (4, 5, 7):
        tiled = TK.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=y_tile,
                                x_interior_mask=xm, y_interior_mask=ym)
        assert all(torch.equal(a, b) for a, b in zip(tiled, got))


@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_bf16_batched_kernel_equals_sequential_and_plain(cuda, coef):
    B, X, Y, Z, T = 3, 5, 17, 16, 2
    slots = [bf16_inputs((X, Y, Z), 70 + b, cuda, coef) for b in range(B)]
    u, v, w = (torch.stack([s[i] for s in slots]) for i in range(3))
    base = slots[0][3]
    scale = torch.tensor([1.0, 1.5, 0.5], device=cuda, dtype=base.tcx.dtype)
    p = TREF.AdvectParams(base.tcx * scale, base.tcy * scale,
                          base.tzc1[None] * scale[:, None], base.tzc2)
    xm = torch.ones(B, X, device=cuda)
    ym = torch.ones(B, Y, device=cuda)
    xm[1, 2] = 0.0
    ym[0, 5:9] = 0.0
    out = TK.advect_fused_batched(u, v, w, p, T=T, dt=DT, y_tile=5,
                                  x_interior_mask=xm, y_interior_mask=ym)
    plain = TK._advect_fused_plain(u, v, w, TK._slot_params(p, B, Z, cuda), T,
                                   DT, xm, ym)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    for b in range(B):
        pb = TREF.AdvectParams(p.tcx[b], p.tcy[b], p.tzc1[b], p.tzc2)
        seq = TK.advect_fused(u[b], v[b], w[b], pb, T=T, dt=DT,
                              x_interior_mask=xm[b], y_interior_mask=ym[b])
        assert all(torch.equal(a[b], s) for a, s in zip(out, seq))


@pytest.mark.parametrize("shape", [(8, 16, 64), (8, 15, 61)])
def test_bf16_guard_kernel_equals_plain(cuda, shape):
    u, v, w, _ = bf16_inputs(shape, 80, cuda, "bf16")
    clean = TK.finite_guard(u, v, w)
    assert clean.dtype == torch.float32 and bool((clean == 1.0).all())
    u[2, 3, 5] = float("nan")
    w[5, 0, 0] = float("inf")
    before = TK.LAUNCHES["finite_guard"]
    got = TK.finite_guard(u, v, w)
    assert TK.LAUNCHES["finite_guard"] == before + 1
    assert torch.equal(got, TK._finite_guard_plain(u, v, w))
    assert got.tolist() == [1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(6, 10, 16), (5, 17, 12), (8, 12, 24),
                                   (6, 10, 15)])
@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow",
                                  "advect_wide"])
def test_bf16_rung_kernels_bitwise_equal_plain(cuda, shape, name, coef):
    """The pair build at even Z, the one-cell build at odd Z."""
    if name == "advect_wide" and shape[2] % 8:
        with pytest.raises(ValueError, match=r"Z % 8"):
            TK.advect_wide(*bf16_inputs(shape, 90, cuda, coef))
        return
    u, v, w, p = bf16_inputs(shape, 90, cuda, coef)
    assert TK.rung_pairs(u, v, w) == (shape[2] % 2 == 0)
    fn = getattr(TK, name)
    for fu in (False, True):
        before = TK.LAUNCHES[name]
        got = fn(u, v, w, p, fuse_update=fu, dt=DT)
        assert TK.LAUNCHES[name] == before + 1
        plain = TK._advect_rung_plain(u, v, w, p, fu, DT)
        torch.cuda.synchronize()
        assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                   for a, b in zip(got, plain))
        for y_tile in (3, 4, 5):
            tiled = fn(u, v, w, p, y_tile=y_tile, fuse_update=fu, dt=DT)
            assert all(torch.equal(a, b) for a, b in zip(tiled, plain))
        for x_chunk in (1, 3):
            chunked = TK._advect_rung_cuda(name, u, v, w, p, 4, fu, DT,
                                           x_chunk=x_chunk)
            assert all(torch.equal(a, b) for a, b in zip(chunked, plain))


def offset_copies(fields):
    """Copies of `fields` starting 2 bytes past an allocation."""
    out = []
    for f in fields:
        buf = torch.empty(f.numel() + 1, device=f.device, dtype=f.dtype)
        out.append(buf[1:].view(f.shape))
        out[-1].copy_(f)
    return out


def test_bf16_rungs_on_fields_two_bytes_past_an_allocation(cuda):
    shape = (5, 9, 12)
    u, v, w, p = bf16_inputs(shape, 95, cuda, "bf16")
    off = offset_copies((u, v, w))
    assert not TK.rung_pairs(*off)
    for name in ("advect_blocked", "advect_dataflow"):
        got = getattr(TK, name)(*off, p, fuse_update=True, dt=DT)
        plain = TK._advect_rung_plain(u, v, w, p, True, DT)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(6, 10, 16), (7, 9, 14), (6, 10, 15),
                                   (5, 9, 13)])
@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow"])
def test_bf16_rung_pair_and_one_cell_builds_equal_plain(cuda, name, shape,
                                                        coef):
    """Both builds of a 4-byte rung on the same values: the pair build
    where the fields sit on 4-byte boundaries at even Z, the one-cell build
    on copies 2 bytes past an allocation and at odd Z, each == plain
    bitwise, sources and `fuse_update`, tiled and in x chunks."""
    u, v, w, p = bf16_inputs(shape, 97, cuda, coef)
    off = offset_copies((u, v, w))
    assert TK.rung_pairs(u, v, w) == (shape[2] % 2 == 0)
    assert not TK.rung_pairs(*off)
    for fu in (False, True):
        plain = TK._advect_rung_plain(u, v, w, p, fu, DT)
        for flds in ((u, v, w), off):
            got = getattr(TK, name)(*flds, p, fuse_update=fu, dt=DT)
            tiled = getattr(TK, name)(*flds, p, y_tile=3, fuse_update=fu,
                                      dt=DT)
            chunked = TK._advect_rung_cuda(name, *flds, p, 4, fu, DT,
                                           x_chunk=2)
            torch.cuda.synchronize()
            for out in (got, tiled, chunked):
                assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                           for a, b in zip(out, plain))


# ---------------------------------------------------------------------------
# K6 and K7 in bf16, and K6 for user-written specs
# ---------------------------------------------------------------------------

BF16_SPEC_KEYS = ["pw", "pw_rk2", "tracer", "tracer_rk2", "diffusion",
                  "diffusion_rk2"]


def unit_spec_case(key, shape, device, coef):
    """(spec, params, bf16 fields) at unit spacings, where bf16 updates
    resolve; coefficients f32 or bf16."""
    Z = shape[2]
    integ = "rk2" if key.endswith("rk2") else "euler"
    cd = torch.float32 if coef == "f32" else torch.bfloat16
    rng = np.random.default_rng(sum(shape) + 7)
    if key.startswith("diffusion"):
        return (TSP.diffusion_spec(integ),
                TSP.default_diffusion_params(Z, dx=1.0, dy=1.0, dz=1.0,
                                             nu=0.1, dtype=cd,
                                             device=device),
                TREF.fields_from_numpy(rng.normal(size=shape),
                                       dtype=torch.bfloat16, device=device))
    n = 4 if key.startswith("tracer") else 3
    spec = (TSP.tracer_advection_spec(integ) if n == 4
            else TSP.pw_advection_spec(integ))
    return (spec, TREF.default_params(Z, dx=1.0, dy=1.0, dz=1.0, dtype=cd,
                                      device=device),
            TREF.fields_from_numpy(*(rng.normal(size=shape)
                                     for _ in range(n)),
                                   dtype=torch.bfloat16, device=device))


@pytest.mark.parametrize("key", BF16_SPEC_KEYS)
@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_bf16_spec_kernel_bitwise_equals_plain(cuda, key, coef):
    """K6 on bf16 fields == its plain version, bitwise, T 1-3 and 5 (as
    passes), tiled == untiled; the PW spec == K1 bf16."""
    spec, p, flds = unit_spec_case(key, (7, 12, 16), cuda, coef)
    for T in (1, 3, 5):
        before = TK.LAUNCHES["stencil_fused"]
        out = TK.stencil_fused(flds, p, spec, T=T, dt=0.1)
        assert TK.LAUNCHES["stencil_fused"] == before + len(
            TK.spec_passes(spec, T))
        plain = spec_plain(spec, p, flds, T, 0.1, cuda)
        torch.cuda.synchronize()
        assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                   for a, b in zip(out, plain))
        assert not all(torch.equal(a, b) for a, b in zip(out, flds))
        tiled = TK.stencil_fused(flds, p, spec, T=T, dt=0.1, y_tile=4)
        assert all(torch.equal(a, b) for a, b in zip(tiled, out))
        if key == "pw":
            k1 = TK.advect_fused(*flds, p, T=T, dt=0.1)
            assert all(torch.equal(a, b) for a, b in zip(out, k1))


@pytest.mark.parametrize("nx,ny,axis,dim,shape,depth", K7_CASES)
def test_bf16_band_exchange_kernel_equals_plain_bitwise(cuda, nx, ny, axis,
                                                        dim, shape, depth):
    """K7 on bf16 shards (the table in bytes, 16-byte moves where a row
    is a multiple of 16 bytes, 2-byte moves elsewhere) == the plain
    version, bitwise, over both slots."""
    mesh = loopback_cuda(nx, ny)
    bf16 = torch.bfloat16
    got = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5, dtype=bf16)
    want = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5, dtype=bf16)
    for block in range(3):
        shards = [tuple(f.to(bf16) for f in fields(shape, 10 * block + s,
                                                    cuda))
                  for s in range(nx * ny)]
        TK.halo_band_exchange_dma(shards, mesh=mesh, axis=axis, depth=depth,
                                  dim=dim, block_index=block, slabs=got)
        TK._band_exchange_plain(shards, want,
                                want.table(axis, block % 2, shards))
        torch.cuda.synchronize()
        got.check()
        for a, b in zip(got.buffers.bufs, want.buffers.bufs):
            assert a.dtype == bf16 and torch.equal(a, b)


def test_user_spec_runs_its_generated_kernel(cuda):
    """A radius-1 user spec with a z-coefficient vector and a y-z diagonal
    read runs its generated K6 in f32 and bf16 == its callback's plain
    version, bitwise, each launch counted under `stencil_generated`."""
    def source(sh, pv):
        (t,) = pv
        return (t[0] * (sh(0, 0, 1, 1) - sh(0, 0, -1, -1))
                + t[2:][1:-1] * (sh(0, 1, 0, 0) - 2.0 * sh(0, 0, 0, 0)
                                 + sh(0, -1, 0, 0)),)

    spec = TSP.StencilSpec(name="user", fields=("a",),
                           offsets={"a": ((1, 0, 0), (0, 1, 1))},
                           source=source, pack_params=lambda q: (q,))
    shape = (7, 12, 16)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.linspace(0.05, 0.3, shape[2] + 2, device=cuda).to(dtype)
        a = fields(shape, 3, cuda)[0].to(dtype)
        for T in (1, 3):
            before = TK.LAUNCHES["stencil_generated"]
            out = TK.stencil_fused([a], q, spec, T=T, dt=0.5)
            assert TK.LAUNCHES["stencil_generated"] == before + 1
            plain = spec_plain(spec, q, [a], T, 0.5, cuda)
            torch.cuda.synchronize()
            assert torch.equal(out[0], plain[0]) and out[0].dtype == dtype
