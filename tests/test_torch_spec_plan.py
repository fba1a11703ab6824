"""K6's launch planner (`spec_launch_plan`, K1's planner at the spec's
halo D = `spec.halo(T)`) and the geometry of its blocks, on the CPU.

The plan is a pure function of the shapes, the spec, the card's SM count
and the resident blocks per SM. These tests check that the PW spec plans
exactly as K1 does, that x and z chunks tile X and Z exactly, that a given
y_tile is honoured or cut into equal sub-tiles, that every plan of the six
shipped operator x integrator pairs at the paper's 67M grid fits one
block's shared memory and its build's threads, and that deep T splits into
passes of whole steps. The geometry test runs the plain version on each
D-halo'd (x-chunk, y-tile, z-window) block exactly as K6 walks it, keeps
the owned slices, rows and cells and restitches: bitwise equal to the
whole-domain plain result, which shows that D-deep halos suffice, rk2's
D = 2T included."""
import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF
from repro_torch.stencil import spec as TSP

H100_SMS = 132
# unit spacings and dt 0.5 carry a cell's error to its neighbours at O(1)
# per level, so a halo one slice, row or cell short shows at every T
STRONG_DT = 0.5
FACTORIES = {"pw": TSP.pw_advection_spec,
             "tracer": TSP.tracer_advection_spec,
             "diffusion": TSP.diffusion_spec}
PAIRS = [(op, integ) for op in FACTORIES for integ in TSP.INTEGRATORS]


def spec_of(op, integ):
    return FACTORIES[op](integ)


def knobs(spec, T):
    return TK.spec_plan_knobs(spec, T)


def check_plan(plan, X, Y, Z, spec, T, B=1):
    D = spec.halo(T)
    levels = spec.stages * T
    op, stages = TK._cuda_instantiation(spec)
    builds = _build.K6_BUILDS[op, stages]
    assert plan.CX * plan.n_cx >= X > plan.CX * (plan.n_cx - 1)
    assert plan.TY * plan.n_ty >= Y > plan.TY * (plan.n_ty - 1)
    assert plan.CZ * plan.n_cz >= Z > plan.CZ * (plan.n_cz - 1)
    assert plan.S == min(plan.TY + 2 * D, Y) or plan.S == Y
    assert plan.W == min(plan.CZ + 2 * D, Z)
    assert plan.grid == (plan.n_ty * plan.n_cz * plan.n_cx, B, 1)
    C = plan.cells_per_thread
    assert plan.shared_bytes == TK.fused_shared_bytes(
        levels, plan.S, plan.W, C, n_fields=spec.n_fields,
        n_coef=_build.K6_COEF_VECTORS[op])
    assert plan.shared_bytes <= SMEM_PER_BLOCK
    assert plan.pitch == TK.fused_plane_pitch(plan.W, C) >= plan.W
    assert plan.threads == -(-plan.S * -(-plan.W // C) // 32) * 32
    assert C in builds and plan.threads <= builds[C]


def test_build_table_covers_every_instantiation():
    """The source builds every (functor, stages) at 2 and, where the table
    names it, 4 cells a thread, at the launch bound the table gives; the
    header `_build.k6_table()` writes into the build carries the table,
    the deepest pass and each functor's z-coefficient vectors, and enters
    the build's key."""
    assert set(_build.K6_BUILDS) == {(op, s) for op in range(3)
                                     for s in (1, 2)}
    header = _build.k6_table()
    builds_line = next(line for line in header.splitlines()
                       if line.startswith("#define K6_BUILDS(X) "))
    entries = []
    for (op, stages), builds in _build.K6_BUILDS.items():
        assert 2 in builds and set(builds) <= {2, 4}
        assert all(n % 32 == 0 and 0 < n <= 1024 for n in builds.values())
        entries += [f"X({op}, {stages}, {c}, {n})" for c, n in builds.items()]
    assert builds_line.split(" ", 2)[2] == " ".join(entries)
    assert f"#define K6_MAX_LEVELS {_build.K6_MAX_LEVELS}\n" in header
    assert "#define K6_COEF_VECTORS(X) X(0, 2) X(1, 2) X(2, 1)\n" in header
    assert not any(f.startswith("-DK6_") for f in _build.NVCC_FLAGS)
    assert '#include "k6_table.cuh"' in (
        _build.CSRC / "stencil_fused.cuh").read_text()
    assert "stencil_fused_attrs" in _build.SIGNATURES


def test_build_key_follows_the_k6_table(monkeypatch):
    key = _build._digest()
    monkeypatch.setattr(_build, "K6_COEF_VECTORS", (2, 2, 2))
    assert _build._digest() != key


@pytest.mark.parametrize("op,integ", PAIRS)
@pytest.mark.parametrize("T", [1, 2, 3, 4])
def test_k6_plans_at_a_halo_of_its_levels(op, integ, T):
    """The planner takes a pass's levels as its halo, as the kernel does
    (D = L): the shipped specs are radius 1, where `spec.halo(T)` is
    ``spec.stages * T``, and their knobs name their fields, vectors and
    builds."""
    spec = spec_of(op, integ)
    assert spec.halo(T) == spec.stages * T
    if spec.stages * T > _build.K6_MAX_LEVELS:
        return
    k = knobs(spec, T)
    op_id, stages = TK._cuda_instantiation(spec)
    assert k == TK.PlanKnobs(spec.n_fields, _build.K6_COEF_VECTORS[op_id],
                             tuple(_build.K6_BUILDS[op_id, stages].items()),
                             max(c * n for c, n in k.builds), "K6")


@pytest.mark.parametrize("X,Y,Z", [(1024, 1024, 64), (3, 10, 12),
                                   (9, 1024, 61), (5, 70, 40), (16, 40, 8),
                                   (1000, 64, 64)])
@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("y_tile", [None, 4, 8])
def test_pw_euler_plans_exactly_as_k1(X, Y, Z, T, y_tile):
    """The PW spec at euler is K1's function, and K6 plans it on K1's
    geometry: D = T, three fields, tzc1 and tzc2, and K1's 2-cell build
    (512 threads). K6 builds PW at 2 cells only (at K1's 384 threads its
    ring spills at 4 levels, and at 256 it holds no slab the 2-cell build
    does not); these shapes plan 2 cells in K1 too."""
    assert _build.K6_BUILDS[0, 1][2] == _build.K1_BUILDS[2]
    k1 = TK.fused_launch_plan(X, Y, Z, T, 1, H100_SMS, 1, y_tile=y_tile)
    assert k1.cells_per_thread == 2
    k6 = TK.spec_launch_plan(X, Y, Z, TSP.pw_advection_spec(), T, 1,
                             H100_SMS, 1, y_tile=y_tile)
    assert k6 == k1


@pytest.mark.parametrize("op,integ", PAIRS)
@pytest.mark.parametrize("T", range(1, 9))
def test_every_pass_at_the_paper_grid_fits(op, integ, T):
    """Each pass of T steps at (1024, 1024, 64), on K6's own tile and on the
    tile the reference's ring model gives, fits one block's shared memory
    and its build's threads; PW and tracer rk2 at T = 4 among them."""
    spec = spec_of(op, integ)
    passes = TK.spec_passes(spec, T)
    for Tk in set(passes):
        for y_tile in (None, 8, 16):
            plan = TK.spec_launch_plan(1024, 1024, 64, spec, Tk, 1,
                                       H100_SMS, 1, y_tile=y_tile)
            check_plan(plan, 1024, 1024, 64, spec, Tk)
            assert plan.grid[0] >= 2 * H100_SMS


def test_own_plan_at_the_paper_grid():
    """K6's own plans on the spec path (1024, 1024, 64): whole rows, slabs
    of the most cells a block of the builds holds. PW and the tracer aim at
    1024 cells (8 owned rows); the tracer's four fields take 4 cells a
    thread in 256 threads (its 2-cell build runs 384, too few for 16 rows
    of 32 threads). Diffusion's one field fits 4 cells in 512 threads, a
    slab of 2048 cells: 24 rows, taken as 16, the largest divisor of Y at
    least half of it."""
    want = {("pw", "euler", 4): (8, 16, 2, 512, 98820, 342),
            ("pw", "rk2", 2): (8, 16, 2, 512, 98820, 342),
            ("tracer", "euler", 4): (8, 16, 4, 256, 164352, 342),
            ("tracer", "rk2", 2): (8, 16, 4, 256, 164352, 342),
            ("diffusion", "euler", 4): (16, 24, 4, 384, 61696, 171),
            ("diffusion", "rk2", 2): (16, 24, 4, 384, 61696, 171)}
    for (op, integ, T), (TY, S, C, threads, shared, CX) in want.items():
        spec = spec_of(op, integ)
        plan = TK.spec_launch_plan(1024, 1024, 64, spec, T, 1, H100_SMS, 1)
        check_plan(plan, 1024, 1024, 64, spec, T)
        assert (plan.TY, plan.S, plan.cells_per_thread, plan.threads,
                plan.shared_bytes, plan.CX) == (TY, S, C, threads, shared,
                                                CX)
        assert (plan.W, plan.n_cz, plan.n_cx) == (64, 1, -(-1024 // CX))
    # diffusion rk2 at T = 4 is two such passes
    assert TK.spec_passes(TSP.diffusion_spec("rk2"), 4) == [2, 2]


@pytest.mark.parametrize("X", [1, 3, 8, 9, 100, 171, 172, 1000, 1024, 4096])
@pytest.mark.parametrize("op,integ", PAIRS)
def test_plan_chunks_tile_x_exactly(X, op, integ):
    spec = spec_of(op, integ)
    T = 2 if integ == "rk2" else 4
    D = spec.halo(T)
    plan = TK.spec_launch_plan(X, 1024, 64, spec, T, 2, H100_SMS, 1)
    check_plan(plan, X, 1024, 64, spec, T, B=2)
    owned = []
    for cx in range(plan.n_cx):
        *_, (xs, xe), (x0, x1) = TK._fused_block_geometry(
            plan, X, 1024, 64, D, 0, 0, cx)
        assert xs == max(x0 - D, 0) and xe == x1 - 1 + D
        owned.extend(range(x0, x1))
    assert owned == list(range(X))


@pytest.mark.parametrize("op,integ", PAIRS)
def test_plan_remainder_chunks_and_x_below_cx(op, integ):
    spec = spec_of(op, integ)
    T = 2 if integ == "rk2" else 4
    L, D = spec.stages * T, spec.halo(T)
    plan = TK.spec_launch_plan(1000, 1024, 64, spec, T, 1, H100_SMS, 1)
    assert 1000 % plan.CX != 0          # a remainder chunk
    k = knobs(spec, T)
    sweep = TK.fused_plan_with_chunks(plan, 5, 64, L, CX=64, knobs=k)
    assert (sweep.CX, sweep.n_cx) == (64, 1)    # X < CX: one chunk
    assert sweep.grid == (plan.n_ty, 1, 1)
    zs = TK.fused_plan_with_chunks(plan, 5, 64, L, CX=64, CZ=10, knobs=k)
    assert (zs.CZ, zs.W, zs.n_cz) == (10, 10 + 2 * D, 7)
    assert zs.grid == (plan.n_ty * 7, 1, 1)
    check_plan(zs, 5, 1024, 64, spec, T)
    cells = []
    for cz in range(zs.n_cz):
        _, _, zlo, (z0, z1), *_ = TK._fused_block_geometry(
            zs, 5, 1024, 64, D, 0, cz, 0)
        assert 0 <= zlo <= z0 and z1 <= zlo + zs.W <= 64
        cells.extend(range(z0, z1))
    assert cells == list(range(64))
    with pytest.raises(ValueError, match="K6's build"):
        TK.fused_plan_with_chunks(plan, 5, 4096, L, CZ=4000, knobs=k)


@pytest.mark.parametrize("op,integ", PAIRS)
@pytest.mark.parametrize("y_tile", [1, 3, 4, 5, 8, 13, 16])
def test_plan_honours_a_given_y_tile(op, integ, y_tile):
    spec = spec_of(op, integ)
    T = 2 if integ == "rk2" else 4
    plan = TK.spec_launch_plan(64, 1024, 64, spec, T, 1, H100_SMS, 1,
                               y_tile=y_tile)
    check_plan(plan, 64, 1024, 64, spec, T)
    assert plan.TY == y_tile and plan.S == y_tile + 2 * spec.halo(T)
    assert plan.n_ty == -(-1024 // y_tile)


@pytest.mark.parametrize("op,integ", PAIRS)
@pytest.mark.parametrize("y_tile", [64, 128, 1024])
def test_plan_runs_a_tile_no_build_takes_as_equal_sub_tiles(op, integ,
                                                            y_tile):
    """An explicit y_tile whose slab no build of K6 takes, even in the
    narrowest z window, runs as the fewest equal sub-tiles that one does,
    so each of the caller's tile edges stays an edge."""
    spec = spec_of(op, integ)
    T = 2 if integ == "rk2" else 4
    L, D = spec.stages * T, spec.halo(T)
    plan = TK.spec_launch_plan(16, 1024, 64, spec, T, 1, H100_SMS, 1,
                               y_tile=y_tile)
    check_plan(plan, 16, 1024, 64, spec, T)
    assert y_tile % plan.TY == 0
    op_id, stages = TK._cuda_instantiation(spec)
    fit = knobs(spec, T)
    assert dict(fit.builds) == _build.K6_BUILDS[op_id, stages]
    for fewer in range(1, y_tile // plan.TY):
        if y_tile % fewer == 0:
            S = min(y_tile // fewer + 2 * D, 1024)
            assert not any(TK._fused_fits(L, S, W, C, fit)
                           for C, _ in fit.builds
                           for W in range(2 * D + 1, 65))


@pytest.mark.parametrize("op,integ", PAIRS)
@pytest.mark.parametrize("T", range(1, 13))
def test_deep_t_splits_into_passes_of_whole_steps(op, integ, T):
    spec = spec_of(op, integ)
    passes = TK.spec_passes(spec, T)
    most = _build.K6_MAX_LEVELS // spec.stages
    assert sum(passes) == T and max(passes) <= most
    assert max(passes) - min(passes) <= 1
    assert len(passes) == -(-T // most)
    with pytest.raises(ValueError, match="spec_passes"):
        TK.spec_launch_plan(64, 64, 64, spec, most + 1, 1, H100_SMS, 1)


def test_plan_refusals_name_their_limits():
    spec = TSP.tracer_advection_spec("rk2")
    with pytest.raises(ValueError, match="65535"):
        TK.spec_launch_plan(16, 16, 8, spec, 1, 65536, H100_SMS, 1)
    star2 = tuple((d, 0, 0) for d in (-2, -1, 0, 1, 2))
    wide = TSP.StencilSpec(name="diffusion_r2", fields=("phi",),
                           offsets={"phi": star2}, source=TSP._diff_source,
                           pack_params=TSP._diff_pack)
    # diffusion's callback declared at radius 2 plans at its halo, 2 a level
    plan = TK.spec_launch_plan(16, 16, 8, wide, 1, 1, H100_SMS, 1)
    assert plan.S == min(plan.TY + 4, 16) and plan.W == 8
    # a radius-1 user spec plans on its generated functor, with the builds
    # of the shipped functor of its field count (diffusion's, one field)
    custom = TSP.StencilSpec(name="custom", fields=("a",),
                             offsets={"a": ((1, 0, 0),)},
                             source=lambda sh, pv: (sh(0, 1, 0, 0),),
                             pack_params=lambda p: ())
    plan = TK.spec_launch_plan(16, 16, 8, custom, 1, 1, H100_SMS, 1)
    assert plan == TK.spec_launch_plan(16, 16, 8, TSP.diffusion_spec(), 1, 1,
                                       H100_SMS, 1)._replace(
        shared_bytes=plan.shared_bytes)
    assert plan.shared_bytes == TK.fused_shared_bytes(
        1, plan.S, plan.W, plan.cells_per_thread, n_fields=1, n_coef=0)
    with pytest.raises(ValueError, match="4 ring levels a pass"):
        TK.spec_plan_knobs(TSP.pw_advection_spec("rk2"), 4)


# --- the geometry: blocks restitched == the whole domain ----------------------


def inputs(op, shape, seed):
    """(fields, packed parameter vectors) at unit spacings, random fields."""
    X, Y, Z = shape
    rng = np.random.default_rng(seed)
    n = {"pw": 3, "tracer": 4, "diffusion": 1}[op]
    fields = [torch.tensor(rng.normal(size=shape), dtype=torch.float32)
              for _ in range(n)]
    if op == "diffusion":
        params = TSP.default_diffusion_params(Z, dx=1.0, dy=1.0, dz=1.0,
                                              nu=0.3, device="cpu")
    else:
        params = TREF.default_params(Z, dx=1.0, dy=1.0, dz=1.0, device="cpu")
    spec = FACTORIES[op]()
    return fields, TK._spec_param_vectors(spec, params, "cpu")


def blocks_restitched(fields, pv, spec, T, dt, xm, ym, plan):
    """The plain version on each (x-chunk, y-tile, z-window) block of one
    K6 pass, over the slices it walks, the slab and the window it holds,
    the block's cut edges walls (the window's z coefficients cut with it);
    its owned slices, rows and cells put back in place."""
    X, Y, Z = fields[0].shape
    D = spec.halo(T)
    outs = [torch.full_like(f, float("nan")) for f in fields]
    for cx in range(plan.n_cx):
        for t in range(plan.n_ty):
            for cz in range(plan.n_cz):
                lo, (r0, r1), zlo, (z0, z1), (xs, xe), (x0, x1) = \
                    TK._fused_block_geometry(plan, X, Y, Z, D, t, cz, cx)
                hi = min(xe, X - 1) + 1
                g = torch.arange(xs, hi)
                xml = torch.where((g >= 1) & (g <= X - 2), xm[xs:hi], 0.0)
                zw = slice(zlo, zlo + plan.W)
                block = [f[xs:hi, lo:lo + plan.S, zw][None] for f in fields]
                pvw = tuple(torch.cat([p[:2], p[2 + zlo:2 + zlo + plan.W]])
                            for p in pv)
                res = TK._stencil_fused_plain(block, pvw, spec, T, dt, xml,
                                              ym[lo:lo + plan.S])
                for o, r in zip(outs, res):
                    o[x0:x1, r0:r1, z0:z1] = r[0, x0 - xs:x1 - xs,
                                               r0 - lo:r1 - lo,
                                               z0 - zlo:z1 - zlo]
    return outs


@pytest.mark.parametrize("op,integ", PAIRS)
@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("TY,CX,CZ", [(3, 4, None), (5, 3, 4), (2, 7, 6)])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_tiled_blocks_equal_whole_domain_plain(op, integ, T, TY, CX,
                                                       CZ, masked):
    """Each pass of `spec_passes(spec, T)` (rk2 at T = 3 is two: 2 then 1
    steps), run block by block with D-deep halos and restitched, is bitwise
    the whole-domain plain result."""
    shape = (11, 23, 17)
    X, Y, Z = shape
    spec = spec_of(op, integ)
    fields, pv = inputs(op, shape, seed=X + T)
    xm, ym = torch.ones(X), torch.ones(Y)
    if masked:
        rng = np.random.default_rng(T)
        xm = torch.tensor((rng.random(X) > 0.3).astype(np.float32))
        ym = torch.tensor((rng.random(Y) > 0.3).astype(np.float32))
    got = fields
    for Tk in TK.spec_passes(spec, T):
        L = spec.stages * Tk
        plan = TK.fused_plan_with_chunks(
            TK.spec_launch_plan(X, Y, Z, spec, Tk, 1, H100_SMS, 1,
                                y_tile=TY),
            X, Z, L, CX=CX, CZ=CZ, knobs=knobs(spec, Tk))
        assert plan.n_cx > 1 and plan.n_ty > 1
        assert CZ is None or plan.n_cz > 1 or CZ + 2 * spec.halo(Tk) >= Z
        got = blocks_restitched(got, pv, spec, Tk, STRONG_DT, xm, ym, plan)
    want = TK._stencil_fused_plain([f[None] for f in fields], pv, spec, T,
                                   STRONG_DT, xm, ym)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, want))
    moved = max(float((a - b).abs().max()) for a, b in zip(got, fields))
    assert moved > 0.0


@pytest.mark.parametrize("op,integ", PAIRS)
def test_own_plan_blocks_equal_whole_domain_plain(op, integ):
    """K6's own plan of a domain taller and wider than one slab (y-tiles,
    and z windows where a row does not fit), restitched, is bitwise the
    whole-domain plain result."""
    shape = (7, 300, 200)
    X, Y, Z = shape
    spec = spec_of(op, integ)
    T = 2 if integ == "rk2" else 4
    fields, pv = inputs(op, shape, seed=5)
    xm, ym = torch.ones(X), torch.ones(Y)
    plan = TK.spec_launch_plan(X, Y, Z, spec, T, 1, H100_SMS, 1)
    check_plan(plan, X, Y, Z, spec, T)
    assert plan.n_ty > 1
    got = blocks_restitched(fields, pv, spec, T, STRONG_DT, xm, ym, plan)
    want = TK._stencil_fused_plain([f[None] for f in fields], pv, spec, T,
                                   STRONG_DT, xm, ym)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, want))
