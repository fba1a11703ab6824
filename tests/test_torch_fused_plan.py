"""K1's launch planner (`fused_launch_plan`) and the geometry of its
blocks, on the CPU.

The plan is a pure function of the shapes, the card's SM count and the
resident blocks per SM; these tests pin it at the paper's 67M grid, check
that its x and z chunks tile X and Z exactly, that a given y_tile is
honoured, that degenerate and wide shapes still plan and that T beyond the
build splits into passes. The geometry test runs the plain version on each
halo'd (x-chunk, y-tile, z-chunk) block exactly as K1 walks it
(`_fused_block_geometry`), keeps the owned slices, rows and cells, and
restitches: bitwise equal to the whole-domain plain result, which shows
that T-deep x, y and z halos suffice."""
import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF

DT = 0.01
H100_SMS = 132
# the geometry test's coupling: unit grid spacings and dt 0.5 carry a cell's
# error to its neighbours at O(1) per level, so a halo one slice or row
# short shows at every T (at dt 0.01 and 100 m it fades below f32 rounding
# within T = 3)
STRONG_DT = 0.5


def fields(shape, seed):
    rng = np.random.default_rng(seed)
    return TREF.fields_from_numpy(*(rng.normal(size=shape) for _ in range(3)),
                                  device="cpu")


def check_plan(plan, X, Y, Z, T, B=1):
    assert plan.CX * plan.n_cx >= X > plan.CX * (plan.n_cx - 1)
    assert plan.TY * plan.n_ty >= Y > plan.TY * (plan.n_ty - 1)
    assert plan.CZ * plan.n_cz >= Z > plan.CZ * (plan.n_cz - 1)
    assert plan.S == min(plan.TY + 2 * T, Y) or plan.S == Y
    assert plan.W == min(plan.CZ + 2 * T, Z)
    assert plan.grid == (plan.n_ty * plan.n_cz * plan.n_cx, B, 1)
    C = plan.cells_per_thread
    assert plan.shared_bytes == TK.fused_shared_bytes(T, plan.S, plan.W, C)
    assert plan.shared_bytes <= SMEM_PER_BLOCK
    assert plan.pitch == TK.fused_plane_pitch(plan.W, C) >= plan.W
    # S rows of ceil(W / C) threads, each holding C cells of one row
    assert plan.threads == -(-plan.S * -(-plan.W // C) // 32) * 32
    assert plan.threads <= _build.K1_BUILDS[C]
    # the whole row wherever some build takes it, in the fewest cells
    whole = [c for c in _build.K1_BUILDS
             if TK._fused_fits(T, plan.S, Z, c)]
    assert (plan.n_cz == 1) == bool(whole)
    assert not whole or C == whole[0]


def test_plan_at_the_paper_grid_fills_the_card():
    X, Y, Z, T = 1024, 1024, 64, 4
    plan = TK.fused_launch_plan(X, Y, Z, T, 1, H100_SMS, 1)
    check_plan(plan, X, Y, Z, T)
    assert plan.grid[0] >= 2 * H100_SMS
    assert plan.shared_bytes <= 232448
    # slabs of 16 rows: 2 cells of a row per thread, 16 warps, each level's
    # centre plane double-buffered (and one float past the last row)
    assert (plan.TY, plan.S, plan.cells_per_thread, plan.threads,
            plan.pitch, plan.W, plan.n_cz) == (8, 16, 2, 512, 64, 64, 1)
    assert plan.shared_bytes == 4 * (2 * 64 + 2 * 4 * 3 * 16 * 64 + 1) \
        == 98820
    assert (plan.CX, plan.n_cx, plan.blocks_per_sm) == (342, 3, 1)
    # two resident blocks per SM halve the waves: still >= 2 per SM
    two = TK.fused_launch_plan(X, Y, Z, T, 1, H100_SMS, 2)
    check_plan(two, X, Y, Z, T)
    assert two.grid[0] >= 2 * H100_SMS and two.blocks_per_sm == 2


@pytest.mark.parametrize("X", [1, 3, 8, 9, 100, 171, 172, 1000, 1024, 4096])
@pytest.mark.parametrize("B", [1, 3])
def test_plan_chunks_tile_x_exactly(X, B):
    plan = TK.fused_launch_plan(X, 1024, 64, 4, B, H100_SMS, 1)
    check_plan(plan, X, 1024, 64, 4, B)
    owned = []
    for cx in range(plan.n_cx):
        *_, (xs, xe), (x0, x1) = TK._fused_block_geometry(
            plan, X, 1024, 64, 4, 0, 0, cx)
        assert xs == max(x0 - 4, 0) and xe == x1 - 1 + 4
        owned.extend(range(x0, x1))
    assert owned == list(range(X))


def test_plan_remainder_chunk_and_x_below_cx():
    plan = TK.fused_launch_plan(1000, 1024, 64, 4, 1, H100_SMS, 1)
    assert 1000 % plan.CX != 0          # a remainder chunk
    sweep = TK.fused_plan_with_chunks(plan, 5, 64, 4, CX=64)
    assert (sweep.CX, sweep.n_cx) == (64, 1)    # X < CX: one chunk
    assert sweep.grid == (plan.n_ty, 1, 1)
    zs = TK.fused_plan_with_chunks(plan, 5, 64, 4, CX=64, CZ=10)
    assert (zs.CZ, zs.W, zs.n_cz, zs.grid) == (10, 18, 7,
                                               (plan.n_ty * 7, 1, 1))
    assert zs.threads == 16 * 9 + 16 and zs.pitch == 18
    assert zs.shared_bytes == TK.fused_shared_bytes(4, 16, 18, 2)
    wide = TK.fused_launch_plan(6, 3, 700, 1, 1, H100_SMS, 1)
    with pytest.raises(ValueError, match="does not fit"):   # 3 x 301 > 512
        TK.fused_plan_with_chunks(wide, 6, 700, 1, CZ=600)


def test_plane_pitch_pads_rows_of_half_warps():
    """Rows of zs = ceil(W / C) threads, several in a warp: the pitch is
    the least odd multiple of zs at least W, so the warp's rows fall on
    different banks; a warp within one row, or a zs that does not divide
    32, keeps the row as it is."""
    assert TK.fused_plane_pitch(64, 4) == 80      # 80 % 32 == 16
    assert TK.fused_plane_pitch(64, 8) == 72      # 8 threads a row
    assert TK.fused_plane_pitch(8, 2) == 12       # rows at banks 12r % 32
    assert TK.fused_plane_pitch(3, 8) == 3        # one thread a row
    assert TK.fused_plane_pitch(64, 2) == 64      # one row a warp
    assert TK.fused_plane_pitch(61, 2) == 61      # 31 does not divide 32
    assert TK.fused_plane_pitch(12, 1) == 12


@pytest.mark.parametrize("y_tile", [1, 4, 5, 13, 16, 24, 26, 40])
def test_plan_honours_a_given_y_tile(y_tile):
    plan = TK.fused_launch_plan(1024, 1024, 64, 4, 1, H100_SMS, 1,
                                y_tile=y_tile)
    check_plan(plan, 1024, 1024, 64, 4)
    assert plan.TY == y_tile and plan.S == y_tile + 8
    assert plan.n_ty == -(-1024 // y_tile)


@pytest.mark.parametrize("X,Y,Z,T,y_tile", [
    (3, 10, 12, 4, None), (8, 10, 12, 4, 4), (2, 1, 1, 1, None),
    (5, 9, 64, 4, 3), (1, 17, 12, 2, 5), (9, 1024, 61, 3, None),
    (6, 3, 680, 1, None), (4, 40, 8, 8, None), (6, 3, 700, 1, None),
    (5, 70, 4096, 4, None), (7, 30, 2049, 8, 3), (3, 9, 5, 1, 200)])
def test_plan_degenerate_shapes(X, Y, Z, T, y_tile):
    """X <= 2T, Y < TY + 2T (the tile degenerates to the whole Y), odd Z,
    one-row and one-column domains, T = 8, rows too wide for one block (z
    chunks): each still plans."""
    plan = TK.fused_launch_plan(X, Y, Z, T, 1, H100_SMS, 1, y_tile=y_tile)
    check_plan(plan, X, Y, Z, T)
    if y_tile is not None and y_tile + 2 * T > Y:
        assert (plan.TY, plan.S, plan.n_ty) == (Y, Y, 1)


def test_plan_z_chunks_where_a_row_does_not_fit():
    """A row wider than any build takes in one block is cut into z chunks
    with a T-deep halo a side: 3 rows of 700 at T = 1 need 264 threads of
    8 cells (over 256), so K1 runs 3 windows of 236 cells at 2 cells a
    thread; a tall given tile too (34 rows of 64 at T = 4)."""
    plan = TK.fused_launch_plan(6, 3, 700, 1, 1, H100_SMS, 1)
    check_plan(plan, 6, 3, 700, 1)
    assert (plan.cells_per_thread, plan.CZ, plan.W, plan.n_cz) == \
        (2, 234, 236, 3)
    tall = TK.fused_launch_plan(16, 1024, 64, 4, 1, H100_SMS, 1, y_tile=26)
    check_plan(tall, 16, 1024, 64, 4)
    assert (tall.S, tall.cells_per_thread, tall.CZ, tall.W, tall.n_cz) == \
        (34, 2, 22, 30, 3)
    cells = []
    for cz in range(plan.n_cz):
        _, _, zlo, (z0, z1), *_ = TK._fused_block_geometry(
            plan, 6, 3, 700, 1, 0, cz, 0)
        assert 0 <= zlo <= z0 - min(z0, 1) and z1 + min(700 - z1, 1) <= \
            zlo + plan.W <= 700
        cells.extend(range(z0, z1))
    assert cells == list(range(700))


@pytest.mark.parametrize("T,passes", [(1, [1]), (8, [8]), (9, [5, 4]),
                                      (10, [5, 5]), (14, [7, 7]),
                                      (16, [8, 8]), (17, [6, 6, 5])])
def test_fused_passes_split_deep_t(T, passes):
    assert TK.fused_passes(T) == passes
    assert sum(passes) == T and max(passes) <= _build.K1_MAX_T
    assert max(passes) - min(passes) <= 1


def test_plan_refusals_name_their_limits():
    with pytest.raises(ValueError, match="T in 1..8 a pass"):
        TK.fused_launch_plan(16, 16, 8, 9, 1, H100_SMS, 1)
    with pytest.raises(ValueError, match="T in 1..8 a pass"):
        TK.fused_launch_plan(16, 16, 8, 0, 1, H100_SMS, 1)
    with pytest.raises(ValueError, match="T must be >= 1"):
        TK.fused_passes(0)
    # a given tile no build takes is no longer refused: y_tile 1024 (the
    # whole Y: 884,816 B of shared planes) and 255 (263 rows x ceil(9 / 8)
    # threads even in the narrowest window, over the 8-cell build's 256)
    # run as the fewest equal sub-tiles that a build takes
    for y_tile, TY in ((1024, 64), (255, 85)):
        plan = TK.fused_launch_plan(16, 1024, 64, 4, 1, H100_SMS, 1,
                                    y_tile=y_tile)
        check_plan(plan, 16, 1024, 64, 4)
        assert plan.TY == TY and y_tile % plan.TY == 0
    with pytest.raises(ValueError, match="65535"):
        TK.fused_launch_plan(16, 16, 8, 2, 65536, H100_SMS, 1)


@pytest.mark.parametrize("axis,limit", [(0, 2 ** 31 - 1), (1, 65535),
                                        (2, 65535)])
def test_check_launch_grid(axis, limit):
    grid = [1, 1, 1]
    grid[axis] = limit
    TK.check_launch_grid(tuple(grid), "k")
    grid[axis] = limit + 1
    with pytest.raises(ValueError, match=f"k: .* {'xyz'[axis]} exceeds "
                                         f"CUDA's limit of {limit}"):
        TK.check_launch_grid(tuple(grid), "k")


@pytest.mark.parametrize("Y,Z,T,y_tile,TY", [
    (1024, 64, 4, 128, 64), (1000, 8, 1, 400, 200), (1024, 64, 4, 120, 120),
    (1024, 64, 4, 121, 11), (1024, 8, 1, 382, 382), (1024, 64, 5, 255, 85)])
def test_plan_runs_a_tile_no_build_takes_as_equal_sub_tiles(Y, Z, T, y_tile,
                                                            TY):
    """An explicit y_tile whose slab no build of K1 takes runs as the fewest
    equal sub-tiles that one does (TY / k for the least k dividing it), so
    each of the caller's tile edges stays an edge: 128 at T = 4, Z = 64
    (120 is the most a build takes there) and 400 at T = 1, Z = 8 (382)."""
    plan = TK.fused_launch_plan(16, Y, Z, T, 1, H100_SMS, 1, y_tile=y_tile)
    check_plan(plan, 16, Y, Z, T)
    assert plan.TY == TY and y_tile % TY == 0
    k = y_tile // TY
    for fewer in range(1, k):
        if y_tile % fewer == 0:
            S = y_tile // fewer + 2 * T
            assert not any(TK._fused_fits(T, S, W, C)
                           for C in _build.K1_BUILDS
                           for W in range(min(2 * T + 1, Z), Z + 1))


def blocks_restitched(u, v, w, p, T, dt, xm, ym, plan):
    """The plain version on each (x-chunk, y-tile, z-chunk) block K1
    launches, over the slices it walks, the slab and the window it holds,
    the block's cut edges walls; its owned slices, rows and cells put back
    in place."""
    X, Y, Z = u.shape
    outs = [torch.full_like(f, float("nan")) for f in (u, v, w)]
    for cx in range(plan.n_cx):
        for t in range(plan.n_ty):
            for cz in range(plan.n_cz):
                lo, (r0, r1), zlo, (z0, z1), (xs, xe), (x0, x1) = \
                    TK._fused_block_geometry(plan, X, Y, Z, T, t, cz, cx)
                hi = min(xe, X - 1) + 1
                g = torch.arange(xs, hi)
                xml = torch.where((g >= 1) & (g <= X - 2), xm[xs:hi], 0.0)
                zw = slice(zlo, zlo + plan.W)
                block = [f[xs:hi, lo:lo + plan.S, zw][None]
                         for f in (u, v, w)]
                pw = TREF.AdvectParams(p.tcx, p.tcy, p.tzc1[zw], p.tzc2[zw])
                res = TK._advect_fused_plain(*block, pw, T, dt, xml,
                                             ym[lo:lo + plan.S])
                for o, r in zip(outs, res):
                    o[x0:x1, r0:r1, z0:z1] = r[0, x0 - xs:x1 - xs,
                                               r0 - lo:r1 - lo,
                                               z0 - zlo:z1 - zlo]
    return outs


@pytest.mark.parametrize("shape", [(13, 19, 6), (9, 23, 5), (7, 11, 29)])
@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("TY,CX,CZ", [(3, 2, None), (5, 4, None),
                                      (4, 5, None), (7, 13, None),
                                      (2, 20, None), (3, 4, 3), (5, 2, 7)])
@pytest.mark.parametrize("masked", [False, True])
def test_x_chunked_y_tiled_blocks_equal_whole_domain_plain(shape, T, TY, CX,
                                                           CZ, masked):
    X, Y, Z = shape
    u, v, w = fields(shape, seed=X + T)
    p = TREF.default_params(Z, dx=1.0, dy=1.0, dz=1.0, device="cpu")
    xm, ym = torch.ones(X), torch.ones(Y)
    if masked:
        rng = np.random.default_rng(T)
        xm = torch.tensor((rng.random(X) > 0.3).astype(np.float32))
        ym = torch.tensor((rng.random(Y) > 0.3).astype(np.float32))
    plan = TK.fused_plan_with_chunks(
        TK.fused_launch_plan(X, Y, Z, T, 1, H100_SMS, 1, y_tile=TY), X, Z, T,
        CX=CX, CZ=CZ)
    assert plan.n_cx > 1 or CX >= X
    assert CZ is None or plan.n_cz > 1 or CZ >= Z
    got = blocks_restitched(u, v, w, p, T, STRONG_DT, xm, ym, plan)
    want = TK._advect_fused_plain(u[None], v[None], w[None], p, T, STRONG_DT,
                                  xm, ym)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, want))
    moved = max(float((a - b).abs().max()) for a, b in zip(got, (u, v, w)))
    assert moved > 0.0


@pytest.mark.parametrize("shape,T,y_tile", [((5, 300, 64), 4, 128),
                                           ((4, 1000, 8), 1, 400)])
def test_sub_tiled_blocks_equal_whole_domain_plain(shape, T, y_tile):
    """The sub-tiled plan of a tile no build takes (128 at T = 4, Z = 64;
    400 at T = 1, Z = 8): the plain version on each block it launches,
    restitched, is bitwise the whole-domain plain result."""
    X, Y, Z = shape
    u, v, w = fields(shape, seed=Y + T)
    p = TREF.default_params(Z, dx=1.0, dy=1.0, dz=1.0, device="cpu")
    xm, ym = torch.ones(X), torch.ones(Y)
    plan = TK.fused_launch_plan(X, Y, Z, T, 1, H100_SMS, 1, y_tile=y_tile)
    assert plan.TY < y_tile and y_tile % plan.TY == 0 and plan.n_ty > 2
    got = blocks_restitched(u, v, w, p, T, STRONG_DT, xm, ym, plan)
    want = TK._advect_fused_plain(u[None], v[None], w[None], p, T, STRONG_DT,
                                  xm, ym)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, want))
