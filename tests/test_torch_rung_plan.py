"""The launch planner of the v1-v3 rungs (`rung_launch_plan`: K3
`advect_blocked`, K2 `advect_dataflow` and `advect_wide`) and the geometry
of their blocks, on the CPU.

The plan is a pure function of the shapes, the card's SM count and the
resident blocks per SM. These tests check its invariants over many shapes
(every owned row and every x owned by exactly one block, slabs inside the
domain, shared memory within one block's budget and at least two blocks an
SM at Z = 64, the grid within CUDA's limits, a given y_tile run as equal
sub-tiles no taller than the plan's own), pin it at the paper's 67M grid,
and run the plain version on each block's own slab over the slices it
loads, exactly as the kernels walk them (`_rung_block_geometry`), keeping
its owned slices and rows: restitched, bitwise equal to the whole-domain
plain result, which shows that one halo slice and one halo row a side
suffice."""
import numpy as np
import pytest
import torch

from repro_torch.core.roofline import (SMEM_PER_BLOCK, SMEM_PER_SM,
                                       SMEM_RESERVED_PER_BLOCK)
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF

DT = 0.01
H100_SMS = 132
RUNGS = ("advect_blocked", "advect_dataflow", "advect_wide")
# the shared planes a field each kernel holds: K3 stages exactly the three
# slices x-1, x, x+1; K2's ring must have a slot to load ahead into (its
# kernel takes 4 or 5)
PLANES = {"advect_blocked": 3, "advect_dataflow": 4, "advect_wide": 4}


def fields(shape, seed):
    rng = np.random.default_rng(seed)
    return TREF.fields_from_numpy(*(rng.normal(size=shape) for _ in range(3)),
                                  device="cpu")


def resident(shared: int) -> int:
    """Blocks of `shared` bytes that share one SM's shared memory."""
    return SMEM_PER_SM // (shared + SMEM_RESERVED_PER_BLOCK)


def check_plan(name, plan, X, Y, Z):
    # every x owned by exactly one chunk, every row by exactly one tile
    assert plan.CX * plan.n_cx >= X > plan.CX * (plan.n_cx - 1)
    assert plan.TY * plan.n_ty >= Y > plan.TY * (plan.n_ty - 1)
    owned = np.zeros((X, Y), dtype=int)
    for t in range(plan.n_ty):
        for cx in range(plan.n_cx):
            lo, (r0, r1), (x0, x1) = TK._rung_block_geometry(plan, X, Y, t, cx)
            owned[x0:x1, r0:r1] += 1
            # the slab lies in the domain and keeps one row of margin to a
            # cut edge
            assert 0 <= lo and lo + plan.S <= Y
            assert lo <= r0 < r1 <= lo + plan.S
            assert r0 - lo >= 1 or lo == 0
            assert lo + plan.S - r1 >= 1 or lo + plan.S == Y
    assert (owned == 1).all()
    assert plan.S == min(plan.TY + 2, Y) or plan.S == Y
    assert plan.planes == PLANES[name]
    assert plan.shared_bytes == 3 * plan.planes * plan.S * Z * 4 \
        <= SMEM_PER_BLOCK
    assert plan.grid == (plan.n_cx, plan.n_ty, 1)
    assert plan.n_cx <= 2 ** 31 - 1 and plan.n_ty <= 65535
    # threads in whole warps, sized to the tile: 4 owned cells each
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.threads == min(max(-(-plan.TY * Z // 128) * 32, 32), 512)


@pytest.mark.parametrize("name", RUNGS)
@pytest.mark.parametrize("shape", [
    (1024, 1024, 64), (1, 3, 4), (5, 9, 8), (6, 10, 12), (8, 12, 10),
    (13, 1021, 64), (300, 1000, 128), (7, 2000, 16), (3, 17, 12),
    (2, 4096, 64), (40, 100, 256), (9, 60, 700)])
@pytest.mark.parametrize("y_tile", [None, 1, 3, 7, 16, 64, 99, 1024])
def test_plan_invariants(name, shape, y_tile):
    X, Y, Z = shape
    if name == "advect_wide" and Z % 4:   # whole 16-byte rows only
        with pytest.raises(ValueError, match="multiple of 16"):
            TK.advect_wide(*fields(shape, 0),
                           TREF.default_params(Z, device="cpu"),
                           y_tile=y_tile)
        return
    plan = TK.rung_launch_plan(name, X, Y, Z, H100_SMS, 2, y_tile=y_tile)
    check_plan(name, plan, X, Y, Z)
    own = TK.rung_launch_plan(name, X, Y, Z, H100_SMS, 2)
    if Z == 64:
        assert resident(own.shared_bytes) >= 2
        assert resident(plan.shared_bytes) >= 2
    if y_tile is not None:
        # a given tile runs as itself, or as equal sub-tiles no taller than
        # the plan's own
        given, _, _ = TK._grid_geometry(Y, y_tile, 1)
        assert plan.TY <= own.TY
        if given <= own.TY:
            assert plan.TY == given
        else:
            assert given % plan.TY == 0
            k = given // plan.TY
            assert all(given % j or given // j > own.TY for j in range(1, k))


def test_plan_at_the_paper_grid():
    """67M: K2 (both builds) 32-row tiles in a 4-slot ring, two blocks an
    SM, x chunks of 64 slices, 512 blocks; K3 16-row tiles of nine slabs,
    five blocks an SM, one x a block; the domain's y_tile 64 runs as the
    plan's own tiles."""
    X, Y, Z = 1024, 1024, 64
    for name in ("advect_dataflow", "advect_wide"):
        plan = TK.rung_launch_plan(name, X, Y, Z, H100_SMS, 2)
        assert (plan.TY, plan.S, plan.n_ty, plan.CX, plan.n_cx) == \
            (32, 34, 32, 64, 16)
        assert (plan.planes, plan.threads) == (4, 512)
        assert plan.shared_bytes == 104_448
        assert resident(plan.shared_bytes) == 2
        assert TK.rung_launch_plan(name, X, Y, Z, H100_SMS, 2,
                                   y_tile=64) == plan
    plan = TK.rung_launch_plan("advect_blocked", X, Y, Z, H100_SMS, 5)
    assert (plan.TY, plan.S, plan.n_ty, plan.CX, plan.n_cx) == \
        (16, 18, 64, 1, 1024)
    assert (plan.planes, plan.threads) == (3, 256)
    assert plan.shared_bytes == 41_472
    assert resident(plan.shared_bytes) == 5
    assert TK.rung_launch_plan("advect_blocked", X, Y, Z, H100_SMS, 5,
                               y_tile=64) == plan


@pytest.mark.parametrize("name", RUNGS)
@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3, 4])
def test_x_chunks_fill_whole_waves(name, blocks_per_sm):
    """The x split at 67M: K3 computes one x a block; for K2 no chunk count
    in reach gives fewer waves times slices a block loads."""
    X, Y, Z = 1024, 1024, 64
    plan = TK.rung_launch_plan(name, X, Y, Z, H100_SMS, blocks_per_sm)
    if name == "advect_blocked":
        assert (plan.CX, plan.n_cx) == (1, X)
        return
    slots = H100_SMS * blocks_per_sm

    def cost(CX):
        return -(-plan.n_ty * -(-X // CX) // slots) * (CX + 2)

    assert plan.n_ty * plan.n_cx >= min(2 * H100_SMS, plan.n_ty * X)
    assert all(cost(plan.CX) <= cost(CX) for CX in range(1, X + 1)
               if plan.n_ty * -(-X // CX) >= 2 * H100_SMS)


@pytest.mark.parametrize("name", RUNGS)
@pytest.mark.parametrize("x_chunk", [1, 3, 5, 1000])
def test_given_x_chunk_overrides_the_plan(name, x_chunk):
    plan = TK.rung_launch_plan(name, 13, 40, 8, H100_SMS, 2, y_tile=7,
                               x_chunk=x_chunk)
    assert plan.CX == x_chunk and plan.n_cx == -(-13 // x_chunk)
    check_plan(name, plan, 13, 40, 8)


def test_plan_refuses_a_row_no_block_holds():
    # one 3-row slab of 2,700 cells a row in 9 planes: 291,600 B
    with pytest.raises(ValueError, match=str(SMEM_PER_BLOCK)):
        TK.rung_launch_plan("advect_blocked", 4, 30, 2700, H100_SMS, 1)
    with pytest.raises(ValueError, match="65535"):
        TK.rung_launch_plan("advect_dataflow", 4, 70_000, 4, H100_SMS, 2,
                            y_tile=1)


def blocks_restitched(name, u, v, w, p, fuse, plan):
    """The plain version on each block's own slab over the slices x0 - 1 ..
    x1 it loads (clipped to the domain), the block's cut edges walls; its
    owned slices and rows put back in place."""
    X, Y, Z = u.shape
    outs = [torch.full_like(f, float("nan")) for f in (u, v, w)]
    for t in range(plan.n_ty):
        for cx in range(plan.n_cx):
            lo, (r0, r1), (x0, x1) = TK._rung_block_geometry(plan, X, Y, t, cx)
            xs, xe = max(x0 - 1, 0), min(x1 + 1, X)
            block = [f[xs:xe, lo:lo + plan.S].contiguous() for f in (u, v, w)]
            res = TK._advect_rung_plain(*block, p, fuse, DT)
            for o, r in zip(outs, res):
                o[x0:x1, r0:r1] = r[x0 - xs:x1 - xs, r0 - lo:r1 - lo]
    return outs


@pytest.mark.parametrize("name", RUNGS)
@pytest.mark.parametrize("shape", [(9, 23, 8), (7, 40, 12), (12, 17, 4)])
@pytest.mark.parametrize("y_tile,x_chunk", [(None, None), (3, 2), (5, 4),
                                            (7, 1), (8, 5), (30, 3)])
@pytest.mark.parametrize("fuse", [False, True])
def test_blocks_restitched_equal_whole_domain_plain(name, shape, y_tile,
                                                    x_chunk, fuse):
    X, Y, Z = shape
    u, v, w = fields(shape, sum(shape))
    p = TREF.default_params(Z, device="cpu")
    plan = TK.rung_launch_plan(name, X, Y, Z, H100_SMS, 2, y_tile=y_tile,
                               x_chunk=x_chunk)
    got = blocks_restitched(name, u, v, w, p, fuse, plan)
    want = TK._advect_rung_plain(u, v, w, p, fuse, DT)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", RUNGS)
def test_sub_tiled_blocks_equal_whole_domain_plain(name):
    """A tile taller than the plan's own (64 rows at Z = 64, the domain's
    tile at 67M) runs as equal sub-tiles; the plain version on each block
    of that plan, restitched, is bitwise the whole-domain result."""
    shape = (5, 150, 64)
    u, v, w = fields(shape, 3)
    p = TREF.default_params(64, device="cpu")
    plan = TK.rung_launch_plan(name, *shape, H100_SMS, 2, y_tile=64,
                               x_chunk=2)
    assert plan.TY < 64 and 64 % plan.TY == 0
    got = blocks_restitched(name, u, v, w, p, True, plan)
    want = TK._advect_rung_plain(u, v, w, p, True, DT)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
