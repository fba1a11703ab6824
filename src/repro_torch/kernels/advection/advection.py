"""PW advection on Hopper: the Fig. 3 ladder (v1 `blocked`, v2 `dataflow`,
v3 `wide`, v4 `fused`) and the finite guard.

Counterpart of `repro.kernels.advection.advection`. `advect_blocked`,
`advect_dataflow` and `advect_wide` return the PW sources of u, v, w, or
with `fuse_update=True` the fields advanced one explicit-Euler step;
`advect_fused` advances them T steps in one pass over device memory;
`advect_fused_batched` does so for B slot-stacked domains in one launch, the
slot being a dimension of the launch grid; `finite_guard` flags the
x-slices whose three fields are all finite; `stencil_fused[_batched]` is the
v4 ring driven by a `stencil.spec.StencilSpec` (any number of fields, the
spec's source, euler or in-ring midpoint RK2); `halo_band_exchange_dma`
(K7) moves the boundary bands of a mesh's shards into the halos of their
ring neighbours' extended slabs, beside each shard's own planes, the
transport of `stencil.distributed`'s `remote_dma` engine.

Each wrapper dispatches on where its tensors lie. On a CUDA tensor it
launches its hand-written kernel (`csrc/advect_blocked.cu`,
`csrc/advect_dataflow.cu`, `csrc/advect_fused.cuh`, `csrc/finite_guard.cu`,
`csrc/stencil_fused.cuh`, `csrc/band_exchange.cu`) or raises; on a CPU
tensor it runs the kernel's plain PyTorch version beside it
(`_advect_rung_plain`, `_advect_fused_plain`, `_finite_guard_plain`,
`_stencil_fused_plain`, `_band_exchange_plain`).
There is no fallback from one to the other. `LAUNCHES` counts the kernel
launches, one per launch and one key per rung, so a run can show which
kernel it went through.

The y-tile geometry is the reference's: tile t owns rows
[t*TY, min((t+1)*TY, Y)) and streams a slab of S = TY + 2H rows clipped
flush into the domain (H = 1 for v1-v3, T for v4), so every owned row keeps
H rows of margin to a cut slab edge and tiled outputs equal untiled ones
bitwise. A v1-v3 block keeps its slabs in shared memory, S x Z floats each
(K3: 3 fields x the 3 slices of one x; K2: a ring of slots a field, over a
chunk of x); `rung_launch_plan` sizes its tile, threads and chunks so that
several blocks share an SM, and runs a given tile too tall for that as
equal sub-tiles. K1 and K6 keep
their rings in registers and only each level's centre plane in shared
memory, and also cut x, and z where a slab row does not fit one block, into
chunks with a halo as deep as the pass's dependence cone (T for K1,
`spec.halo(T)` for K6); `fused_launch_plan` and `spec_launch_plan` size
their tiles and chunks from the builds and the card's SM count.
`tiling="host"` is the reference's retained host-side tile loop
(`_y_tiled_host`): one call per halo'd block and a restitch.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import math
import weakref
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch import _build
from repro_torch.kernels import library as L
from repro_torch.core.roofline import (MAX_GRID_Y, SMEM_PER_BLOCK,
                                       SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK)
from repro_torch.kernels.advection.ref import (AdvectParams, pw_advect_ref,
                                               step_dt)
from repro_torch.launch.mesh import dma_neighbor_coords

TILINGS = ("grid", "host")
MAX_GRID = (2 ** 31 - 1, MAX_GRID_Y, 65535)   # CUDA's limits on (x, y, z)
# the slab cells a planned tile of K1 (`csrc/advect_fused.cuh`) aims at; its
# builds are `_build.K1_MAX_T` and `_build.K1_BUILDS`
K1_PLAN_CELLS = 1024
WIDE_ROW_RULE = ("wide moves each Z row as 16-byte vectors: Z * {item} bytes "
                 "must be a multiple of 16 (Z % {cells} == 0), got Z={Z} "
                 "({row} B); use dataflow for this Z")
FIELD_DTYPES = (torch.float32, torch.bfloat16)
WIDE_HOST_RULE = ("wide runs the in-grid tiled path only: the host tile loop "
                  "is kept as the anti-pattern baseline of the other rungs, "
                  "and the reference refuses it for wide too; use "
                  "tiling='grid' or dataflow with tiling='host'")

LAUNCHES = {"advect_fused": 0, "finite_guard": 0, "advect_blocked": 0,
            "advect_dataflow": 0, "advect_wide": 0, "stencil_fused": 0,
            "stencil_generated": 0, "band_exchange": 0, "band_handshake": 0}


# the shared bytes each kernel's last launch asked for (what its plan says)
LAUNCHED_SHARED = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# in-grid (y_tile, x) tiling geometry
# ---------------------------------------------------------------------------


def _check_tiling(tiling: str) -> None:
    if tiling not in TILINGS:
        raise ValueError(f"tiling must be one of {TILINGS}, got {tiling!r}")


def _check_y_tile(y_tile: Optional[int]) -> None:
    if y_tile is not None and y_tile < 1:
        raise ValueError(f"y_tile must be >= 1, got {y_tile}")


def _grid_geometry(Y: int, y_tile: Optional[int],
                   halo: int) -> Tuple[int, int, int]:
    """(TY, S, n_ty): owned rows per tile, slab rows, tile count. A tile
    whose slab would not fit the domain degenerates to one full tile."""
    if y_tile is None or y_tile >= Y or y_tile + 2 * halo > Y:
        return Y, Y, 1
    return y_tile, y_tile + 2 * halo, -(-Y // y_tile)


def _slab_lo(t: int, Y: int, TY: int, S: int, H: int) -> int:
    """Global row of slab row 0 for tile t, clipped flush into the domain."""
    return min(max(t * TY - H, 0), Y - S)


def _out_lo(t: int, Y: int, TY: int) -> int:
    """Global row of the reference's (TY, Z) output block: the remainder
    tile slides down and rewrites rows of the previous tile. The CUDA kernel
    instead writes only rows [t*TY, min((t+1)*TY, Y)), since its blocks run
    concurrently; the values are the same."""
    return min(t * TY, Y - TY)


def _own_start(t: int, Y: int, TY: int, S: int, H: int) -> int:
    """Slab-local row where the reference's output block begins."""
    return _out_lo(t, Y, TY) - _slab_lo(t, Y, TY, S, H)


# ---------------------------------------------------------------------------
# shared-memory and device-memory models
# ---------------------------------------------------------------------------


def fused_register_bytes(T: int, y_rows: int, Z: int, itemsize: int = 4,
                         y_tile: int | None = None,
                         halo: int | None = None, *, n_fields: int = 3,
                         n_slots: int = 3,
                         n_levels: int | None = None) -> int:
    """Bytes of a ring: by default 3 fields x T levels x 3 slots of
    ``min(y_tile + 2*halo, y_rows)`` rows (halo defaults to T). T = 1 is the
    v1-v3 slab (3 fields x 3 slices, halo 1), the v4 ring otherwise. The
    spec ring (`stencil_fused`) is sized by the same formula with
    `n_fields=spec.n_fields`, `n_slots=2*spec.radius + 1`,
    `n_levels=spec.stages*T` and `halo=spec.halo(T)` (`spec_ring_knobs`).
    It is the reference's model of the ring in VMEM; on Hopper it bounds
    the v1-v3 slab, one block's dynamic shared memory, while K1 and K6 keep
    their rings in registers (`fused_shared_bytes` is theirs)."""
    h = T if halo is None else halo
    levels = T if n_levels is None else n_levels
    rows = y_rows if y_tile is None else min(y_tile + 2 * h, y_rows)
    return n_fields * (n_slots * levels) * rows * Z * itemsize


def spec_ring_knobs(spec, T: int) -> dict:
    """The ring knobs of `fused_register_bytes` and
    `largest_fitting_y_tile` for a StencilSpec advancing T steps."""
    return dict(n_fields=spec.n_fields, n_slots=2 * spec.radius + 1,
                n_levels=spec.stages * T, halo=spec.halo(T))


def largest_fitting_y_tile(T: int, Y: int, Z: int, itemsize: int = 4,
                           budget: int = SMEM_PER_BLOCK, *,
                           n_fields: int = 3, n_slots: int = 3,
                           n_levels: int | None = None,
                           halo: int | None = None) -> Optional[int]:
    """The y_tile a ring kernel runs with when the caller names none (T = 1
    for the v1-v3 slab, the fusion depth for v4, a spec's ring with
    `spec_ring_knobs`): None (untiled) when the whole-Y ring fits `budget`;
    else the largest tile whose ring fits, taking the largest divisor of Y
    instead when it is at least half that size (even tiles leave no
    remainder tile that streams a full slab for a few rows). Raises when no
    tile fits."""
    knobs = dict(halo=halo, n_fields=n_fields, n_slots=n_slots,
                 n_levels=n_levels)
    if fused_register_bytes(T, Y, Z, itemsize, **knobs) <= budget:
        return None
    h = T if halo is None else halo
    best = budget // fused_register_bytes(T, 1, Z, itemsize, **knobs) - 2 * h
    if best < 1:
        raise ValueError(
            f"no y_tile fits the fused ring in {budget} B of shared memory "
            f"per block at T={T}, Z={Z}: even y_tile=1 needs "
            f"{fused_register_bytes(T, Y, Z, itemsize, 1, **knobs)} B")
    divisor = max(d for d in range(1, best + 1) if Y % d == 0)
    return divisor if 2 * divisor >= best else best


class FusedPlan(NamedTuple):
    """One launch of a register ring, K1 (`csrc/advect_fused.cuh`) or K6
    (`csrc/stencil_fused.cuh`): y-tiles of TY owned rows in slabs of S rows,
    z chunks of CZ owned cells in windows of W (one chunk, W = Z, where a
    whole row fits), x chunks of CX owned slices, C cells of a window row
    per thread (z = zt + q * ceil(W / C)), the shared planes' row pitch, the
    launch grid ``(n_ty * n_cz * n_cx, B, 1)``, the block's shared bytes and
    the resident blocks per SM the x split assumed."""
    TY: int
    S: int
    n_ty: int
    CZ: int
    W: int
    n_cz: int
    CX: int
    n_cx: int
    cells_per_thread: int
    threads: int
    pitch: int
    grid: Tuple[int, int, int]
    shared_bytes: int
    blocks_per_sm: int


class PlanKnobs(NamedTuple):
    """What a ring's planner takes of its kernel beyond the pass's levels,
    which are also its halo (K1's T; K6's ``spec.stages * T``, which is
    `spec.halo(T)` at radius 1, the only radius K6 is built for): its
    fields, its z-coefficient vectors, its builds as (cells per thread,
    threads per block) items, the slab cells its own tile aims at, and its
    name in the refusals. K1's are `K1_KNOBS`, K6's `spec_plan_knobs`'."""
    n_fields: int
    n_coef: int
    builds: Tuple[Tuple[int, int], ...]
    plan_cells: int
    what: str


K1_KNOBS = PlanKnobs(3, 2, tuple(_build.K1_BUILDS.items()), K1_PLAN_CELLS,
                     "K1")


class _FusedBlock(NamedTuple):
    """The part of a `FusedPlan` that does not depend on X or the card."""
    TY: int
    S: int
    n_ty: int
    CZ: int
    W: int
    n_cz: int
    C: int
    threads: int
    pitch: int
    shared: int


def check_launch_grid(grid, what: str) -> None:
    """Raise ValueError naming CUDA's limit when a dimension of `grid` is
    beyond it (2**31 - 1 for x, 65535 for y and z)."""
    for axis, n, limit in zip("xyz", grid, MAX_GRID):
        if n > limit:
            raise ValueError(f"{what}: a launch grid of {n} blocks in {axis} "
                             f"exceeds CUDA's limit of {limit} there")


def fused_passes(T: int, max_steps: Optional[int] = None) -> List[int]:
    """The depths of the ring launches that advance T steps: one pass up to
    `max_steps` (K1's `_build.K1_MAX_T` by default), else
    ceil(T / max_steps) passes of near-equal depth. Each pass is T_k whole
    steps, so the passes in turn are the T steps, bitwise."""
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    m = _build.K1_MAX_T if max_steps is None else max_steps
    n = -(-T // m)
    return [T // n + (i < T % n) for i in range(n)]


def fused_plane_pitch(W: int, C: int) -> int:
    """Floats per row of a ring's shared planes for a window of W cells: W,
    or where a warp covers several rows of ``zs = ceil(W / C) < 32``
    threads, the least odd multiple of zs at least W, so that those rows
    fall on different banks."""
    zs = -(-W // C)
    if zs >= 32 or 32 % zs:
        return W
    return (-(-W // zs) | 1) * zs


def fused_shared_bytes(T: int, S: int, W: int, C: int, *, n_fields: int = 3,
                       n_coef: int = 2) -> int:
    """A ring's shared memory for a slab of S rows and a window of W cells:
    the window's z coefficients (`n_coef` vectors of W floats), the
    double-buffered centre plane of each of T levels and `n_fields` fields
    (S rows at `fused_plane_pitch`), and the floats the last row's z +- 1
    reads may reach past it. K1's by default (T its depth, u, v, w, tzc1
    and tzc2); K6's with the knobs of `spec_plan_knobs`."""
    pitch = fused_plane_pitch(W, C)
    tail = max(-(-W // C) * C + 1 - pitch, 0)
    return 4 * (n_coef * W + 2 * T * n_fields * S * pitch + tail)


def _fused_threads(S: int, W: int, C: int) -> int:
    """Threads of a ring's block: S rows of ceil(W / C), in whole warps."""
    return -(-S * -(-W // C) // 32) * 32


def _fused_fits(T: int, S: int, W: int, C: int,
                knobs: PlanKnobs = K1_KNOBS) -> bool:
    """Whether the ring's build of C cells per thread takes a block of S
    rows by W cells at T levels: its threads and its shared memory."""
    builds = dict(knobs.builds)
    return (C in builds and _fused_threads(S, W, C) <= builds[C]
            and fused_shared_bytes(T, S, W, C, n_fields=knobs.n_fields,
                                   n_coef=knobs.n_coef) <= SMEM_PER_BLOCK)


def _plan_y_tile(Y: int, Z: int, T: int,
                 cells: int = K1_PLAN_CELLS) -> Optional[int]:
    """A ring's own y_tile at a halo of T rows: None (untiled) when the
    whole slab holds at most `cells` cells (K1's `K1_PLAN_CELLS` by
    default), else the tallest tile whose slab does (at least 1), taking
    the largest divisor of Y instead when it is at least half that size, as
    `largest_fitting_y_tile` does."""
    if Y * Z <= cells:
        return None
    best = max(cells // Z - 2 * T, 1)
    divisor = max(d for d in range(1, best + 1) if Y % d == 0)
    return divisor if 2 * divisor >= best else best


def _plan_z_window(T: int, S: int, Z: int, knobs: PlanKnobs = K1_KNOBS):
    """(C, CZ, W, n_cz) for a slab of S rows at T levels: the whole row (one
    chunk) for the fewest cells per thread whose build takes it; else z
    chunks with a T-deep halo a side, for the fewest cells per thread whose
    widest fitting window owns at least half its cells (else the widest
    window), balanced where the balanced window still fits. None where no
    window of 2 * T + 1 cells or more fits."""
    builds = dict(knobs.builds)
    for C in builds:
        if _fused_fits(T, S, Z, C, knobs):
            return C, Z, Z, 1
    widest = {}
    for C in builds:
        w = next((w for w in range(Z - 1, 2 * T, -1)
                  if _fused_fits(T, S, w, C, knobs)), None)
        if w is not None:
            widest[C] = w
    if not widest:
        return None
    C = next((c for c, w in widest.items() if w - 2 * T >= w // 2),
             max(widest, key=widest.get))
    CZ = widest[C] - 2 * T
    n_cz = -(-Z // CZ)
    if _fused_fits(T, S, -(-Z // n_cz) + 2 * T, C, knobs):
        CZ = -(-Z // n_cz)
    return C, CZ, CZ + 2 * T, n_cz


@functools.lru_cache(maxsize=256)
def _fused_block(Y: int, Z: int, T: int, y_tile: Optional[int],
                 knobs: PlanKnobs = K1_KNOBS) -> _FusedBlock:
    """A ring's block for one pass of T levels at a halo of T and `y_tile`
    (None: the ring's own tile, a slab of about `knobs.plan_cells` cells),
    K1's by default, K6's with `spec_plan_knobs`. A given tile
    whose slab no build takes (more threads than a build runs, or more
    shared memory than one block has, even in the narrowest z window) runs
    as the fewest equal sub-tiles that a build takes: TY / k rows for the
    least k dividing TY, so that the caller's tile edges stay tile edges.
    y-tiling is bitwise invariant (the port's grid-tiled == untiled
    contract), so the result is the same bits. A sub-tile of one row always
    fits. Raises ValueError for T beyond K1's build (K6's shallower limit,
    `_build.K6_MAX_LEVELS`, is `spec_plan_knobs`' refusal)."""
    if not 1 <= T <= _build.K1_MAX_T:
        raise ValueError(f"K1 is built for T in 1..{_build.K1_MAX_T} a pass "
                         f"(its register ring holds T levels), got T={T}")
    tile = (_plan_y_tile(Y, Z, T, knobs.plan_cells) if y_tile is None
            else y_tile)
    TY, S, n_ty = _grid_geometry(Y, tile, T)
    window = _plan_z_window(T, S, Z, knobs)
    for k in range(2, TY + 1):
        if window is not None:
            break
        if TY % k == 0:
            geometry = _grid_geometry(Y, TY // k, T)
            window = _plan_z_window(T, geometry[1], Z, knobs)
            if window is not None:
                TY, S, n_ty = geometry
    C, CZ, W, n_cz = window
    return _FusedBlock(TY, S, n_ty, CZ, W, n_cz, C, _fused_threads(S, W, C),
                       fused_plane_pitch(W, C),
                       fused_shared_bytes(T, S, W, C,
                                          n_fields=knobs.n_fields,
                                          n_coef=knobs.n_coef))


def _plan_x_chunks(X: int, T: int, tiles: int, slots: int,
                   n_sm: int) -> int:
    """Owned x-slices per chunk at a halo of T slices: the count of chunks n
    minimising the waves of blocks (``tiles * n`` over `slots` resident at
    once) times the slices each block walks (``ceil(X / n) + T``), among
    the n that give at least two blocks per SM where X allows it; ties go
    to fewer chunks."""
    need = min(-(-2 * n_sm // tiles), X)
    best, best_cost = X, None
    for n in range(max(need, 1), X + 1):
        CX = -(-X // n)
        if -(-X // CX) != n:
            continue
        cost = -(-tiles * n // slots) * (CX + T)
        if best_cost is None or cost < best_cost:
            best, best_cost = CX, cost
    return best


@functools.lru_cache(maxsize=256)
def _ring_launch_plan(X: int, Y: int, Z: int, T: int, B: int, n_sm: int,
                      blocks_per_sm: int, y_tile: Optional[int],
                      knobs: PlanKnobs = K1_KNOBS) -> FusedPlan:
    """`_fused_block` (T levels) with its x chunks and grid."""
    blk = _fused_block(Y, Z, T, y_tile, knobs)
    tiles = blk.n_ty * blk.n_cz
    CX = _plan_x_chunks(X, T, tiles * B, n_sm * blocks_per_sm, n_sm)
    n_cx = -(-X // CX)
    grid = (tiles * n_cx, B, 1)
    check_launch_grid(grid, knobs.what)
    return FusedPlan(blk.TY, blk.S, blk.n_ty, blk.CZ, blk.W, blk.n_cz, CX,
                     n_cx, blk.C, blk.threads, blk.pitch, grid, blk.shared,
                     blocks_per_sm)


def fused_launch_plan(X: int, Y: int, Z: int, T: int, B: int, n_sm: int,
                      blocks_per_sm: int, *,
                      y_tile: Optional[int] = None) -> FusedPlan:
    """One K1 pass of depth T over (B, X, Y, Z) fields on a card of `n_sm`
    SMs that holds `blocks_per_sm` of the pass's blocks at once: `y_tile`
    as given (or the fewest equal sub-tiles of it that a build takes), or
    K1's own (a slab of about `K1_PLAN_CELLS` cells); the whole row, or z
    chunks, for the fewest cells per thread whose build takes it
    (`_plan_z_window`); x chunks from `_plan_x_chunks`. Raises ValueError,
    naming the limit, for T beyond the build or a grid beyond CUDA's."""
    return _ring_launch_plan(X, Y, Z, T, B, n_sm, blocks_per_sm, y_tile)


def fused_plan_with_chunks(plan: FusedPlan, X: int, Z: int, T: int, *,
                           CX: Optional[int] = None,
                           CZ: Optional[int] = None,
                           knobs: PlanKnobs = K1_KNOBS) -> FusedPlan:
    """`plan` (a pass of T levels; K1's by default, K6's with
    `knobs=spec_plan_knobs(...)`) with x chunks of CX owned slices and z
    chunks of CZ
    owned cells instead of its own, where given (the launch-shape sweeps and
    the tests of chunk remainders). Raises ValueError where the z window
    does not fit the plan's build."""
    CX = plan.CX if CX is None else CX
    n_cx = -(-X // CX)
    plan = plan._replace(CX=CX, n_cx=n_cx,
                         grid=(plan.n_ty * plan.n_cz * n_cx,) + plan.grid[1:])
    if CZ is None:
        return plan
    W, C = min(CZ + 2 * T, Z), plan.cells_per_thread
    if not _fused_fits(T, plan.S, W, C, knobs):
        raise ValueError(f"a z window of {W} cells does not fit "
                         f"{knobs.what}'s build of {C} cells per thread at "
                         f"a slab of {plan.S} rows")
    n_cz = -(-Z // CZ)
    return plan._replace(CZ=CZ, W=W, n_cz=n_cz,
                         threads=_fused_threads(plan.S, W, C),
                         pitch=fused_plane_pitch(W, C),
                         shared_bytes=fused_shared_bytes(
                             T, plan.S, W, C, n_fields=knobs.n_fields,
                             n_coef=knobs.n_coef),
                         grid=(plan.n_ty * n_cz * n_cx,) + plan.grid[1:])


def _fused_block_geometry(plan: FusedPlan, X: int, Y: int, Z: int, T: int,
                          t: int, cz: int, cx: int):
    """What a ring's block (y-tile t, z-chunk cz, x-chunk cx) walks and owns
    at a halo of T (K1's depth, K6's levels), as the kernel computes
    it: ``(slab_lo, own rows [lo, hi), window_lo, owned cells [z0, z1),
    slices walked [xs, xe], owned slices [x0, x1))``, rows, cells and slices
    global."""
    slab_lo = _slab_lo(t, Y, plan.TY, plan.S, T)
    own = (t * plan.TY, min((t + 1) * plan.TY, Y))
    z0 = cz * plan.CZ
    zlo = min(max(z0 - T, 0), Z - plan.W)
    x0 = cx * plan.CX
    x1 = min(x0 + plan.CX, X)
    return (slab_lo, own, zlo, (z0, min(z0 + plan.CZ, Z)),
            (max(x0 - T, 0), x1 - 1 + T), (x0, x1))


def _padded_row_bytes(Z: int, itemsize: int) -> int:
    """A Z row as the card moves it: rounded up to 16 bytes."""
    return -(-Z * itemsize // 16) * 16


def _host_overlap_rows(Y: int, y_tile: int | None, halo: int) -> int:
    """Rows the host tile loop restages per x-slice: 2*halo per interior
    tile boundary."""
    n = 1 if y_tile is None or y_tile >= Y else -(-Y // y_tile)
    return 2 * halo * (n - 1)


def _check_wide_model(Y: int, Z: int, itemsize: int, y_tile: int | None,
                      grid_tiled: bool) -> None:
    """Where `advect_wide` refuses to run, and the models refuse to price
    it: a Z row that is not whole 16-byte vectors, or host tiling."""
    if Z * itemsize % 16:
        raise ValueError(WIDE_ROW_RULE.format(Z=Z, row=Z * itemsize,
                                              item=itemsize,
                                              cells=16 // itemsize))
    if not grid_tiled and y_tile is not None and y_tile < Y:
        raise ValueError(WIDE_HOST_RULE)


def hbm_bytes_model(X: int, Y: int, Z: int, itemsize: int, variant: str,
                    *, T: int = 1, y_tile: int | None = None,
                    grid_tiled: bool = True,
                    fuse_update: bool = True, n_fields: int = 3,
                    halo_depth: int | None = None) -> int:
    """Modelled device-memory bytes of one advection call advancing T
    explicit-Euler steps.

    The reference's byte algebra, with the alignment rule of the card in
    place of the TPU's lane rule: a Z row of ``Z * itemsize`` bytes moves at
    no penalty when it is a multiple of 16 bytes (one 16-byte vector access
    per thread), and is otherwise charged as the row padded up to the next
    16 bytes. The pre-fusion rungs pay a read+write pass per step, `fused`
    streams each field in and out once for all T steps. `grid_tiled=True`
    charges zero halo overlap (halo rows are re-read from the on-chip slab);
    `grid_tiled=False` models the host tile loop, restaging `2*halo` rows
    per interior tile boundary on both sides. `fuse_update=False` adds the
    separate `f + dt*s` pass of the non-fused rungs (contiguous arrays, so
    no row penalty).

    `wide` moves what `dataflow` moves: its rows are whole 16-byte vectors
    by contract, so none is padded, and its fetch halo on the card is 1 row
    (the reference's 8-row halo is the TPU's sublane rule). It equals the
    reference's value wherever the reference accepts the shape (Z % 128 ==
    0, y_tile % 8 == 0), and raises where `advect_wide` would refuse to run:
    a row that is not whole 16-byte vectors, or host tiling.

    `n_fields` and `halo_depth` price the spec ring (`stencil_fused`): it
    streams `spec.n_fields` fields per pass with a slab halo of
    `spec.halo(T)` (None keeps the ladder's depths, T for `fused` and 1
    otherwise); on the in-grid path its bytes do not depend on the halo.
    """
    if variant == "wide":
        _check_wide_model(Y, Z, itemsize, y_tile, grid_tiled)
    slice_b = Y * Z * itemsize
    row_b = _padded_row_bytes(Z, itemsize)
    if halo_depth is None:
        halo = T if variant == "fused" else 1
    else:
        halo = halo_depth
    overlap_rows = 0 if grid_tiled else _host_overlap_rows(Y, y_tile, halo)
    tiled_slice_b = (Y + overlap_rows) * row_b
    if variant == "blocked":
        reads = T * n_fields * 3 * X * tiled_slice_b
    elif variant in ("dataflow", "wide"):
        reads = T * n_fields * X * tiled_slice_b
    elif variant == "fused":
        reads = n_fields * X * tiled_slice_b   # one pass for all T steps
    elif variant == "pointwise":
        reads = T * n_fields * 7 * X * Y * row_b   # naive 7-point gathers
    else:
        raise ValueError(variant)
    w_slice_b = Y * row_b if variant == "pointwise" else tiled_slice_b
    writes = (1 if variant == "fused" else T) * n_fields * X * w_slice_b
    total = reads + writes
    if not fuse_update and variant != "fused":
        total += T * 3 * n_fields * X * slice_b
    return int(total)


def vmem_halo_bytes_model(X: int, Y: int, Z: int, itemsize: int,
                          variant: str, *, T: int = 1,
                          y_tile: int | None = None, n_fields: int = 3,
                          halo_depth: int | None = None) -> int:
    """Halo re-read bytes the in-grid tiled path serves from the on-chip
    slab (shared memory on Hopper) instead of device memory: `2*halo` rows
    per interior tile boundary, per x-slice, per field (per view for
    `blocked`); zero where no tiled execution exists.

    `wide` streams a 1-row fetch halo on the card, as `dataflow` does, so
    its value is the reference's `dataflow` value; the reference's own
    `wide` value counts its TPU 8-row sublane halo. `n_fields` and
    `halo_depth` price the spec ring: `spec.n_fields` rings each re-read a
    `spec.halo(T)`-deep slab halo."""
    if variant == "pointwise":
        return 0
    if variant == "wide":
        _check_wide_model(Y, Z, itemsize, y_tile, grid_tiled=True)
    if halo_depth is None:
        halo = T if variant == "fused" else 1
    else:
        halo = halo_depth
    _, _, n_ty = _grid_geometry(Y, y_tile, halo)
    overlap_rows = 2 * halo * (n_ty - 1)
    views = 3 if variant == "blocked" else 1
    passes = 1 if variant == "fused" else T
    return passes * views * n_fields * X * overlap_rows * Z * itemsize


# ---------------------------------------------------------------------------
# operand checks and packing
# ---------------------------------------------------------------------------


def base_address(t: torch.Tensor) -> int:
    """`t.data_ptr()`; for a fake tensor (a trace, which holds no memory)
    its byte offset into its storage, whose alignment is the address's (the
    caching allocator's blocks start 512-byte aligned)."""
    if L.is_fake(t):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def _check_fields(u, v, w, rank: int, what: str) -> None:
    for name, f in (("u", u), ("v", v), ("w", w)):
        if not torch.is_tensor(f):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(f).__name__}")
        if f.ndim != rank:
            raise ValueError(f"{name} must be {what}, got rank {f.ndim}")
        if f.dtype not in FIELD_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{f.dtype}")
        if f.dtype != u.dtype:
            raise TypeError(f"{name} is {f.dtype}, u {u.dtype}")
        if f.device != u.device:
            raise ValueError(f"{name} is on {f.device}, u on {u.device}")
        if not f.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (u.shape == v.shape == w.shape):
        raise ValueError(f"field shapes differ: {tuple(u.shape)} "
                         f"{tuple(v.shape)} {tuple(w.shape)}")


def _mask(mask, n: int, B: int, name: str, device) -> torch.Tensor:
    """(n,) shared or (B, n) per-slot interior mask as f32 on `device`."""
    m = (torch.ones((n,), dtype=torch.float32, device=device) if mask is None
         else torch.as_tensor(mask, dtype=torch.float32, device=device))
    if tuple(m.shape) not in ((n,), (B, n)):
        raise ValueError(f"{name} must have shape ({n},) or ({B}, {n}), "
                         f"got {tuple(m.shape)}")
    return m


def _check_domain_masks(y_interior_mask, x_interior_mask, X: int,
                        Y: int) -> None:
    """One domain's interior masks are (Y,) and (X,), or None."""
    for name, m, n in (("y_interior_mask", y_interior_mask, Y),
                       ("x_interior_mask", x_interior_mask, X)):
        if m is not None and tuple(torch.as_tensor(m).shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(torch.as_tensor(m).shape)}")


def coef_bf16(p: AdvectParams) -> bool:
    """Whether the coefficients are bf16: every leaf a bf16 tensor, as a
    bf16 domain's are. Then a product of one with a bf16 field value is a
    bf16 op, as in the reference, whose kernels concatenate the leaves
    into one vector (an f32 leaf makes it f32)."""
    return all(torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16
               for leaf in p)


def _slot_params(p: AdvectParams, B: Optional[int], Z: int,
                 device) -> AdvectParams:
    """Check each leaf is shared (unbatched) or per-slot (leading B);
    B = None admits unbatched leaves only (one domain). The leaves come
    back bf16 where all four are (`coef_bf16`), else f32."""
    dtype = torch.bfloat16 if coef_bf16(p) else torch.float32
    leaves = []
    for name, leaf, base in (("tcx", p.tcx, ()), ("tcy", p.tcy, ()),
                             ("tzc1", p.tzc1, (Z,)), ("tzc2", p.tzc2, (Z,))):
        t = torch.as_tensor(leaf, dtype=dtype, device=device)
        shapes = (base,) if B is None else (base, (B,) + base)
        if tuple(t.shape) not in shapes:
            raise ValueError(f"params.{name} must have shape "
                             f"{' or '.join(map(str, shapes))}, got "
                             f"{tuple(t.shape)}")
        leaves.append(t)
    return AdvectParams(*leaves)


# ---------------------------------------------------------------------------
# K1: the fused ring
# ---------------------------------------------------------------------------


def _euler(f, s, dt: float):
    """The kernels' update ``f + dt * s``, the source first rounded to the
    field's dtype and the update run in it (the reference's
    `_emit_tile_outputs` and `_kernel_fused`: ``cen + dt *
    src.astype(cen.dtype)``, dt a weakly typed scalar)."""
    return f + step_dt(dt, f.dtype) * s.to(f.dtype)


def _advect_fused_plain(u, v, w, p: AdvectParams, T: int, dt: float,
                        xm, ym):
    """Plain PyTorch version of the fused kernel: T masked Euler steps of
    the reference over (B, X, Y, Z) fields (untiled: tiled and untiled
    results are equal by contract), each level in the fields' dtype."""
    X = u.shape[-3]
    j = torch.arange(X, device=u.device)
    x_ok = (j >= 1) & (j <= X - 2) & (xm > 0.0)
    m = x_ok[..., :, None, None] & (ym > 0.0)[..., None, :, None]
    for _ in range(T):
        su, sv, sw = pw_advect_ref(u, v, w, p)
        u = _euler(u, torch.where(m, su, 0.0), dt)
        v = _euler(v, torch.where(m, sv, 0.0), dt)
        w = _euler(w, torch.where(m, sw, 0.0), dt)
    return u, v, w


def _pack_rows(rows, B: int) -> Tuple[torch.Tensor, int]:
    """Stack per-slot (or shared) rows into a contiguous (B or 1, n) table
    and the slot stride the kernel steps by (0 = shared)."""
    batched = any(r.ndim == 2 for r in rows)
    n = sum(r.shape[-1] for r in rows)
    if len(rows) == 1 and rows[0].is_contiguous():   # no copy to make
        return rows[0].reshape(-1, n), (n if batched else 0)
    table = torch.cat([r.reshape(-1, r.shape[-1]).expand(B if batched else 1,
                                                         r.shape[-1])
                       for r in rows], dim=1).contiguous()
    return table, (n if batched else 0)


def _param_table(p: AdvectParams, B: int) -> Tuple[torch.Tensor, int]:
    """The kernel's parameter rows [tcx, tcy, tzc1(Z), tzc2(Z)] in f32 (bf16
    coefficients as their exact f32 values): one row shared by every slot
    (stride 0) when no leaf is per-slot, else one row per slot (stride
    2 + 2Z), a shared leaf repeated in each."""
    return _pack_rows([leaf.float() for leaf in
                       (p.tcx[..., None], p.tcy[..., None], p.tzc1, p.tzc2)],
                      B)


def _advect_fused_cuda(u, v, w, p: AdvectParams, T: int, dt: float,
                       xm, ym, y_tile=None, *,
                       plan: Optional[FusedPlan] = None):
    """Launch K1 (`csrc/advect_fused.cuh`) on (B, X, Y, Z) fields: one launch
    a pass of `fused_passes(T)`, each on `fused_device_plan`'s plan for this
    card, or on `plan`, a plan made for these shapes and T (one pass)."""
    B, X, Y, Z = u.shape
    passes = fused_passes(T)
    if plan is not None and len(passes) > 1:
        raise ValueError(f"a given plan runs one pass, T <= "
                         f"{_build.K1_MAX_T}; got T={T}")
    if plan is None:
        for Tk in set(passes):   # the refusals, before any build
            _fused_block(Y, Z, Tk, y_tile)
        check_launch_grid((1, B, 1), "K1")
    lib = _build.load()
    pt, sp = _param_table(p, B)
    xmt, sx = _pack_rows([xm], B)
    ymt, sy = _pack_rows([ym], B)
    entry = _FUSED_ENTRY[_build_of(u.dtype, coef_bf16(p))]
    outs = (u, v, w)
    for Tk in passes:
        run = plan or fused_device_plan(u.device, X, Y, Z, Tk, B, y_tile,
                                        dtype=u.dtype, coef=coef_bf16(p))
        ins, outs = outs, tuple(torch.empty_like(u) for _ in range(3))
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = getattr(lib, entry)(
                *(f.data_ptr() for f in ins + outs), pt.data_ptr(),
                xmt.data_ptr(), ymt.data_ptr(), B, X, Y, Z, Tk, run.TY,
                run.S, run.n_ty, run.CZ, run.W, run.n_cz, run.CX, run.n_cx,
                run.cells_per_thread, run.threads, run.pitch, sp, sx, sy,
                step_dt(dt, u.dtype), run.shared_bytes, stream)
        _build.check(err, entry)
        LAUNCHES["advect_fused"] += 1
        LAUNCHED_SHARED["advect_fused"] = run.shared_bytes
    return outs


@functools.lru_cache(maxsize=64)
def _fused_attrs_cached(index: int, T: int, C: int, threads: int,
                        shared: int, build: Tuple[bool, bool] = (False, False)
                        ) -> Tuple[int, int, int, int]:
    """The card's attributes of K1's (T, C) build; `build` is (bf16
    fields, bf16 coefficients)."""
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    entry = _FUSED_ATTRS[build]
    with torch.cuda.device(index):
        err = getattr(lib, entry)(T, C, threads, shared, out)
    _build.check(err, entry)
    return tuple(out)


# K1's entry points by build (bf16 fields, bf16 coefficients): the bf16
# builds take dt rounded to bf16, as the reference's update rounds it
_FUSED_ENTRY = {(False, False): "advect_fused_f32",
                (True, False): "advect_fused_bf16",
                (True, True): "advect_fused_bf16_coef"}
_FUSED_ATTRS = {(False, False): "advect_fused_attrs",
                (True, False): "advect_fused_bf16_attrs",
                (True, True): "advect_fused_bf16_coef_attrs"}


def _build_of(dtype, coef: bool) -> Tuple[bool, bool]:
    """Which build of a PW kernel (K1, K3, K2) runs fields of `dtype`:
    (bf16 fields, bf16 coefficients); the f32 build has one kind of
    coefficient."""
    bf16 = dtype == torch.bfloat16
    return bf16, bf16 and bool(coef)


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def fused_device_plan(device, X: int, Y: int, Z: int, T: int, B: int = 1,
                      y_tile: Optional[int] = None, *,
                      dtype=torch.float32, coef: bool = False) -> FusedPlan:
    """`fused_launch_plan` on `device`'s card: its SM count, and the
    resident blocks per SM the card reports for the pass's build (f32, or
    bf16 fields with f32 or bf16 coefficients, `coef`). The bf16 build
    plans as the f32 one: its registers and shared planes hold f32 words."""
    index = _device_index(device)
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    blk = _fused_block(Y, Z, T, y_tile)
    per_sm = _fused_attrs_cached(index, T, blk.C, blk.threads, blk.shared,
                                 _build_of(dtype, coef))[3]
    return fused_launch_plan(X, Y, Z, T, B, n_sm, per_sm, y_tile=y_tile)


def fused_kernel_attrs(device, T: int, plan: FusedPlan, *,
                       dtype=torch.float32, coef: bool = False) -> dict:
    """What the card says of the K1 build that runs `plan` at depth T
    (f32, or bf16 fields with f32 or bf16 coefficients, `coef`): registers
    and local (spill) bytes per thread, the most threads a block of it can
    have, and its resident blocks per SM at the plan's threads and shared
    bytes."""
    regs, local, most, per_sm = _fused_attrs_cached(
        _device_index(device), T, plan.cells_per_thread, plan.threads,
        plan.shared_bytes, _build_of(dtype, coef))
    return {"registers": regs, "local_bytes": local, "max_threads": most,
            "blocks_per_sm": per_sm}


def _k1_cpu(u, v, w, tcx, tcy, tzc1, tzc2, xm, ym, T, dt, y_tile):
    del y_tile
    return _advect_fused_plain(u, v, w, AdvectParams(tcx, tcy, tzc1, tzc2),
                               T, dt, xm, ym)


def _k1_cuda(u, v, w, tcx, tcy, tzc1, tzc2, xm, ym, T, dt, y_tile):
    return _advect_fused_cuda(u, v, w, AdvectParams(tcx, tcy, tzc1, tzc2),
                              T, dt, xm, ym, y_tile or None)


def _fields_fake(u, v, w, *rest):
    del rest
    return tuple(torch.empty_like(f) for f in (u, v, w))


_OP_K1 = L.define(
    "advect_fused",
    "(Tensor u, Tensor v, Tensor w, Tensor tcx, Tensor tcy, Tensor tzc1, "
    "Tensor tzc2, Tensor xm, Tensor ym, int T, float dt, int y_tile) -> "
    "(Tensor, Tensor, Tensor)",
    kind="field", cpu=_k1_cpu, cuda=_k1_cuda, fake=_fields_fake,
    static=("T", "y_tile"))


def advect_fused_batched(u, v, w, p: AdvectParams, *, T: int = 4,
                         dt: float = 1.0, y_tile: int | None = None,
                         tiling: str = "grid", y_interior_mask=None,
                         x_interior_mask=None, guard: bool = False):
    """Advance B slot-stacked (B, X, Y, Z) domains T steps in one launch.

    Each `p` leaf is shared (unbatched) or per-slot (leading B);
    `x_interior_mask` / `y_interior_mask` are shared ``(X,)`` / ``(Y,)`` or
    per-slot ``(B, X)`` / ``(B, Y)`` (nonzero = the source may be applied).
    A request smaller than the slot shape freezes everything outside its
    own extent with zeros in its masks, so the padded run reproduces the
    unpadded domain bitwise. Per-slot outputs equal B sequential
    `advect_fused` calls bitwise. `guard=True` also returns the (B, X)
    finite-guard flags of the advanced fields, from a separate launch.
    """
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    _check_tiling(tiling)
    _check_y_tile(y_tile)
    _check_fields(u, v, w, 4, "slot-stacked (B, X, Y, Z)")
    B, X, Y, Z = u.shape
    if _host_tiled(tiling, y_tile, Y):
        raise ValueError("the batched launch is grid-tiled only (it always "
                         "carries interior masks); tiling='host' takes one "
                         "(X, Y, Z) domain through advect_fused")
    xm = _mask(x_interior_mask, X, B, "x_interior_mask", u.device)
    ym = _mask(y_interior_mask, Y, B, "y_interior_mask", u.device)
    ps = _slot_params(p, B, Z, u.device)
    ou, ov, ow = u, v, w
    for Tk in fused_passes(T):
        ou, ov, ow = _OP_K1(ou, ov, ow, *ps, xm, ym, Tk, float(dt),
                            y_tile or 0)
    if guard:
        return ou, ov, ow, finite_guard(ou, ov, ow)
    return ou, ov, ow


def advect_fused(u, v, w, p: AdvectParams, *, T: int = 4, dt: float = 1.0,
                 y_tile: int | None = None, tiling: str = "grid",
                 y_interior_mask=None, x_interior_mask=None,
                 guard: bool = False):
    """v4: advance (X, Y, Z) fields T explicit-Euler steps in one pass.

    Returns the advanced ``(u, v, w)``, or ``(u, v, w, flags)`` with
    `guard=True`, flags being the (X,) `finite_guard` pass over the
    advanced fields (a separate launch: the field outputs are the same bits
    as with `guard=False`). `y_tile` runs the in-grid tiling. On CUDA,
    None lets K1 plan its own tiles and chunks (`fused_launch_plan`); a
    given tile whose slab fits no block of K1 in any z window (its shared
    planes within `roofline.SMEM_PER_BLOCK`, its threads within a build's,
    `_build.K1_BUILDS`) runs as the fewest equal sub-tiles that one does
    (`_fused_block`), bitwise the same. T beyond the
    build's `_build.K1_MAX_T` runs as `fused_passes(T)`, one launch each.
    On the CPU the plain version ignores the tile.
    `tiling="host"` runs the host tile loop with a T-row halo instead (no
    interior masks there).
    `y_interior_mask` (Y,) and `x_interior_mask` (X,) freeze rows /
    x-planes whose entry is zero. This is `advect_fused_batched` with one
    slot.
    """
    _check_fields(u, v, w, 3, "(X, Y, Z)")
    X, Y, _ = u.shape
    if _host_tiled(tiling, y_tile, Y):
        if T < 1:
            raise ValueError(f"T must be >= 1, got {T}")
        if y_interior_mask is not None or x_interior_mask is not None:
            raise ValueError("interior masks require the grid-tiled path "
                             "(tiling='grid')")
        out = _y_tiled_host(lambda a, b, c: advect_fused(a, b, c, p, T=T,
                                                         dt=dt),
                            u, v, w, y_tile=y_tile, halo=T)
        return out + (finite_guard(*out),) if guard else out
    _check_domain_masks(y_interior_mask, x_interior_mask, X, Y)
    outs = advect_fused_batched(u[None], v[None], w[None], p, T=T, dt=dt,
                                y_tile=y_tile, tiling=tiling,
                                y_interior_mask=y_interior_mask,
                                x_interior_mask=x_interior_mask, guard=guard)
    return tuple(o[0] for o in outs)


# ---------------------------------------------------------------------------
# the host tile loop (tiling="host")
# ---------------------------------------------------------------------------


def _y_tiled_host(fn, u, v, w, *, y_tile: int, halo: int):
    """The reference's retained host-side tile loop (the anti-pattern
    baseline): run `fn` untiled on each halo'd y-block and restitch.

    Each block carries `halo` extra rows per interior side, copied out of
    the fields (the restaging the in-grid path avoids); `fn` treats block
    edges as walls, which spoils at most `halo` rows per side after `halo`
    sweeps: exactly the rows trimmed. Global-edge blocks get no extra rows,
    so the true boundary lands on the block edge. Plain PyTorch host code:
    slices, one `fn` call per block and a `torch.cat`.
    """
    Y = u.shape[1]
    outs = ([], [], [])
    for y0 in range(0, Y, y_tile):
        y1 = min(y0 + y_tile, Y)
        lo, hi = max(y0 - halo, 0), min(y1 + halo, Y)
        tile = fn(*(f[:, lo:hi].contiguous() for f in (u, v, w)))
        for acc, t in zip(outs, tile):
            acc.append(t[:, y0 - lo:y0 - lo + (y1 - y0)])
    return tuple(torch.cat(a, dim=1) for a in outs)


def _host_tiled(tiling: str, y_tile: Optional[int], Y: int) -> bool:
    return tiling == "host" and y_tile is not None and y_tile < Y


# ---------------------------------------------------------------------------
# K3 and K2: the v1-v3 rungs
# ---------------------------------------------------------------------------


class _RungKnobs(NamedTuple):
    """What the planner takes of a v1-v3 kernel: the (S, Z) planes a field
    holds in shared memory (K2's ring slots, K3's three slices), whether a
    block walks a chunk of x (K2, which loads two halo slices beyond it) or
    computes one x (K3), and the blocks an SM its tile aims at."""
    planes: int
    walks_x: bool
    blocks_per_sm: int


# K2's ring of 4 slots a field loads slice x+2 while x computes, at two
# blocks an SM; K3 stages the nine slabs of one x, the loads of the four or
# five blocks an SM hiding each other (the faster of two K3 designs timed
# in one call, PERF.md). The kernels hold these: K2's ring takes 4 or 5
# slots, K3 stages exactly 3 planes.
_RUNG_KNOBS = {
    "advect_blocked": _RungKnobs(3, False, 4),
    "advect_dataflow": _RungKnobs(4, True, 2),
    "advect_wide": _RungKnobs(4, True, 2)}
RUNG_MAX_THREADS = 512      # the rung kernels' launch bound
RUNG_CELLS_PER_THREAD = 4   # owned cells of a slice each thread computes


class RungPlan(NamedTuple):
    """One launch of a v1-v3 kernel: y-tiles of TY owned rows in slabs of S
    rows, x chunks of CX owned slices, the shared planes a field, the
    threads per block, the launch grid ``(n_cx, n_ty, 1)``, the block's
    shared bytes and the resident blocks per SM the x split assumed."""
    TY: int
    S: int
    n_ty: int
    CX: int
    n_cx: int
    planes: int
    threads: int
    grid: Tuple[int, int, int]
    shared_bytes: int
    blocks_per_sm: int


def _rung_shared(knobs: _RungKnobs, S: int, Z: int, itemsize: int = 4) -> int:
    """A rung block's shared bytes at a slab of S rows: 3 fields x planes of
    S x Z cells of `itemsize` bytes (cp.async stages the cells as they are
    stored: 4-byte f32, 2-byte bf16)."""
    return 3 * knobs.planes * S * Z * itemsize


def _rung_budget(blocks: int) -> int:
    """The shared bytes a block may take so that `blocks` share an SM."""
    return min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks - SMEM_RESERVED_PER_BLOCK)


def _rung_own_tile(knobs: _RungKnobs, Y: int, Z: int, what: str,
                   itemsize: int = 4) -> int:
    """A rung's own owned rows per tile: all of Y where that slab lets
    `knobs.blocks_per_sm` blocks share an SM, else the tallest tile whose
    slab does (one block an SM where none does), taking the largest divisor
    of Y instead when it is at least half that size. Raises ValueError
    naming the budget where not even a one-row tile fits one block."""
    for blocks in (knobs.blocks_per_sm, 1):
        budget = _rung_budget(blocks)
        if _rung_shared(knobs, Y, Z, itemsize) <= budget:
            return Y
        best = budget // _rung_shared(knobs, 1, Z, itemsize) - 2
        if best >= 1:
            divisor = max(d for d in range(1, best + 1) if Y % d == 0)
            return divisor if 2 * divisor >= best else best
    raise ValueError(
        f"{what}: even a y-tile of one row needs "
        f"{_rung_shared(knobs, min(3, Y), Z, itemsize)} B of shared memory "
        f"at Z={Z}; "
        f"one block may use {SMEM_PER_BLOCK} B")


class _RungBlock(NamedTuple):
    """The part of a `RungPlan` that does not depend on X or the card."""
    TY: int
    S: int
    n_ty: int
    threads: int
    shared: int


@functools.lru_cache(maxsize=256)
def _rung_block(name: str, Y: int, Z: int, y_tile: Optional[int],
                itemsize: int = 4) -> _RungBlock:
    """A rung's block at `y_tile` (None: its own, `_rung_own_tile`). A
    given tile taller than the rung's own runs as the fewest equal
    sub-tiles no taller: TY / k rows for the least k dividing TY, so that
    the caller's tile edges stay tile edges. y-tiling is bitwise invariant
    (the port's grid-tiled == untiled contract), so the result is the same
    bits. Threads: `RUNG_CELLS_PER_THREAD` owned cells each, in whole warps,
    at most `RUNG_MAX_THREADS`. `itemsize`: the fields' (4 f32, 2 bf16)."""
    knobs = _RUNG_KNOBS[name]
    own = _rung_own_tile(knobs, Y, Z, name, itemsize)
    TY, S, n_ty = _grid_geometry(Y, own if y_tile is None else y_tile, 1)
    if TY > own:
        k = next(k for k in range(2, TY + 1) if TY % k == 0 and TY // k <= own)
        TY, S, n_ty = _grid_geometry(Y, TY // k, 1)
    check_launch_grid((1, n_ty, 1), name)
    threads = -(-TY * Z // RUNG_CELLS_PER_THREAD)
    threads = min(max(-(-threads // 32) * 32, 32), RUNG_MAX_THREADS)
    return _RungBlock(TY, S, n_ty, threads,
                      _rung_shared(knobs, S, Z, itemsize))


@functools.lru_cache(maxsize=256)
def rung_launch_plan(name: str, X: int, Y: int, Z: int, n_sm: int,
                     blocks_per_sm: int, *, y_tile: Optional[int] = None,
                     x_chunk: Optional[int] = None,
                     itemsize: int = 4) -> RungPlan:
    """One launch of the v1-v3 kernel `name` (`advect_blocked`,
    `advect_dataflow`, `advect_wide`) over (X, Y, Z) fields on a card of
    `n_sm` SMs that holds `blocks_per_sm` of its blocks at once: the y-tile
    of `_rung_block` (the rung's own, or `y_tile` in equal sub-tiles where
    it is taller), x chunks of `x_chunk` slices where given, else one
    slice (K3) or chunks from `_plan_x_chunks` (K2: whole waves of the
    resident blocks, weighing the two halo slices each block loads beyond
    its own). `itemsize` is the fields' (2 for bf16, whose stage holds
    2-byte cells). Raises ValueError, naming the limit, where no tile fits
    or the grid is beyond CUDA's."""
    knobs = _RUNG_KNOBS[name]
    blk = _rung_block(name, Y, Z, y_tile, itemsize)
    CX = x_chunk or (_plan_x_chunks(X, 2, blk.n_ty, n_sm * blocks_per_sm,
                                    n_sm) if knobs.walks_x else 1)
    n_cx = -(-X // CX)
    grid = (n_cx, blk.n_ty, 1)
    check_launch_grid(grid, name)
    return RungPlan(blk.TY, blk.S, blk.n_ty, CX, n_cx, knobs.planes,
                    blk.threads, grid, blk.shared, blocks_per_sm)


@functools.lru_cache(maxsize=64)
def _rung_attrs_cached(index: int, name: str, threads: int, shared: int,
                       build: Tuple[bool, bool] = (False, False)
                       ) -> Tuple[int, int, int, int]:
    """The card's attributes of the rung's build; `build` is (bf16 fields,
    bf16 coefficients)."""
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    wide = int(name == "advect_wide")
    with torch.cuda.device(index):
        if name == "advect_blocked":
            err = (lib.advect_blocked_bf16_attrs(int(build[1]), threads,
                                                 shared, out) if build[0]
                   else lib.advect_blocked_attrs(threads, shared, out))
        elif build[0]:
            err = lib.advect_dataflow_bf16_attrs(wide, int(build[1]),
                                                 threads, shared, out)
        else:
            err = lib.advect_dataflow_attrs(wide, threads, shared, out)
    _build.check(err, f"{name} attrs")
    return tuple(out)


def rung_device_plan(device, name: str, X: int, Y: int, Z: int,
                     y_tile: Optional[int] = None,
                     x_chunk: Optional[int] = None, *, dtype=torch.float32,
                     coef: bool = False) -> RungPlan:
    """`rung_launch_plan` on `device`'s card: its SM count, and the
    resident blocks per SM the card reports for the planned block of the
    build for fields of `dtype` (bf16 with bf16 coefficients: `coef`)."""
    index = _device_index(device)
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    itemsize = _itemsize(dtype)
    blk = _rung_block(name, Y, Z, y_tile, itemsize)
    per_sm = _rung_attrs_cached(index, name, blk.threads, blk.shared,
                                _build_of(dtype, coef))[3]
    return rung_launch_plan(name, X, Y, Z, n_sm, per_sm, y_tile=y_tile,
                            x_chunk=x_chunk, itemsize=itemsize)


def rung_kernel_attrs(device, name: str, plan: RungPlan, *,
                      dtype=torch.float32, coef: bool = False) -> dict:
    """What the card says of the kernel that runs `plan` (the build for
    fields of `dtype`, bf16 coefficients where `coef`): registers and local
    (spill) bytes per thread, the most threads a block of it can have, and
    its resident blocks per SM at the plan's threads and shared bytes."""
    regs, local, most, per_sm = _rung_attrs_cached(
        _device_index(device), name, plan.threads, plan.shared_bytes,
        _build_of(dtype, coef))
    return {"registers": regs, "local_bytes": local, "max_threads": most,
            "blocks_per_sm": per_sm}


def _rung_block_geometry(plan: RungPlan, X: int, Y: int, t: int, cx: int):
    """What a rung's block (y-tile t, x-chunk cx) loads and owns, as the
    kernel computes it: ``(slab_lo, own rows [lo, hi), owned slices
    [x0, x1))``, rows and slices global. It reads slices x0 - 1 .. x1 (K2's
    walk; K3 fetches x - 1, x, x + 1 for each owned x), clipped to the
    domain."""
    x0 = cx * plan.CX
    return (_slab_lo(t, Y, plan.TY, plan.S, 1),
            (t * plan.TY, min((t + 1) * plan.TY, Y)),
            (x0, min(x0 + plan.CX, X)))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _advect_rung_plain(u, v, w, p: AdvectParams, fuse_update: bool,
                       dt: float):
    """Plain PyTorch version of every v1-v3 kernel: the reference's sources
    (zero on the boundary) in the fields' dtype, or one Euler step with
    `fuse_update`, the update in the fields' dtype (`_emit_tile_outputs`)."""
    srcs = tuple(s.to(u.dtype) for s in pw_advect_ref(u, v, w, p))
    if fuse_update:
        return tuple(_euler(f, s, dt) for f, s in zip((u, v, w), srcs))
    return srcs


def _advect_rung_cuda(name: str, u, v, w, p: AdvectParams,
                      y_tile: Optional[int], fuse_update: bool, dt: float,
                      x_chunk: Optional[int] = None):
    """Launch the blocked (K3) or dataflow/wide (K2) CUDA kernel on
    (X, Y, Z) fields, on `rung_device_plan`'s plan for this card at
    `y_tile` (None: the rung's own tile) with x chunks of `x_chunk` slices
    where given."""
    X, Y, Z = u.shape
    bf16, coef = u.dtype == torch.bfloat16, coef_bf16(p)
    _rung_block(name, Y, Z, y_tile, u.element_size())   # the refusals,
    lib = _build.load()                                  # before any build
    run = rung_device_plan(u.device, name, X, Y, Z, y_tile, x_chunk,
                           dtype=u.dtype, coef=coef)
    # [tcx, tcy, 0, 0, tzc1(Z), tzc2(Z)] in f32: the z vectors start 16
    # bytes in, so `wide` reads each run of them in 16-byte loads
    pt = torch.cat([torch.stack([p.tcx, p.tcy]), p.tcx.new_zeros(2), p.tzc1,
                    p.tzc2]).float()
    outs = [torch.empty_like(u) for _ in range(3)]
    ptrs = [f.data_ptr() for f in (u, v, w, *outs, pt)]
    geometry = (X, Y, Z, run.TY, run.S, run.n_ty, run.CX)
    wide, fuse = int(name == "advect_wide"), int(fuse_update)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if name == "advect_blocked" and bf16:
            entry = "advect_blocked_bf16"
            err = lib.advect_blocked_bf16(*ptrs, *geometry, run.threads,
                                          fuse, int(coef),
                                          step_dt(dt, u.dtype),
                                          run.shared_bytes, stream)
        elif name == "advect_blocked":
            entry = "advect_blocked_f32"
            err = lib.advect_blocked_f32(*ptrs, *geometry, run.threads,
                                         fuse, dt, run.shared_bytes, stream)
        elif bf16:
            entry = "advect_dataflow_bf16"
            err = lib.advect_dataflow_bf16(*ptrs, *geometry, run.planes,
                                           run.threads, wide, fuse,
                                           int(coef), step_dt(dt, u.dtype),
                                           run.shared_bytes, stream)
        else:
            entry = "advect_dataflow_f32"
            err = lib.advect_dataflow_f32(*ptrs, *geometry, run.planes,
                                          run.threads, wide, fuse, dt,
                                          run.shared_bytes, stream)
    _build.check(err, entry)
    LAUNCHES[name] += 1
    LAUNCHED_SHARED[name] = run.shared_bytes
    return tuple(outs)


def _advect_rung(name: str, u, v, w, p: AdvectParams, y_tile, tiling,
                 fuse_update, dt):
    _check_tiling(tiling)
    _check_y_tile(y_tile)
    _check_fields(u, v, w, 3, "(X, Y, Z)")
    X, Y, Z = u.shape
    if name == "advect_wide":
        _check_wide_model(Y, Z, u.element_size(), y_tile,
                          grid_tiled=tiling == "grid")
        if any(base_address(f) % 16 for f in (u, v, w)):
            raise ValueError("wide moves 16-byte vectors: u, v and w must "
                             "start on a 16-byte boundary")
    if _host_tiled(tiling, y_tile, Y):
        return _y_tiled_host(
            lambda a, b, c: _advect_rung(name, a, b, c, p, None, "grid",
                                         fuse_update, dt),
            u, v, w, y_tile=y_tile, halo=1)
    ps = _slot_params(p, None, Z, u.device)
    if name == "advect_blocked":
        return _OP_K3(u, v, w, *ps, y_tile or 0, bool(fuse_update),
                      float(dt))
    return _OP_K2(u, v, w, *ps, y_tile or 0, name == "advect_wide",
                  bool(fuse_update), float(dt))


def _k3_cpu(u, v, w, tcx, tcy, tzc1, tzc2, y_tile, fuse_update, dt):
    return _advect_rung_plain(u, v, w, AdvectParams(tcx, tcy, tzc1, tzc2),
                              fuse_update, dt)


def _k3_cuda(u, v, w, tcx, tcy, tzc1, tzc2, y_tile, fuse_update, dt):
    return _advect_rung_cuda("advect_blocked", u, v, w,
                             AdvectParams(tcx, tcy, tzc1, tzc2),
                             y_tile or None, fuse_update, dt)


def _k2_cpu(u, v, w, tcx, tcy, tzc1, tzc2, y_tile, wide, fuse_update, dt):
    return _advect_rung_plain(u, v, w, AdvectParams(tcx, tcy, tzc1, tzc2),
                              fuse_update, dt)


def _k2_cuda(u, v, w, tcx, tcy, tzc1, tzc2, y_tile, wide, fuse_update, dt):
    return _advect_rung_cuda("advect_wide" if wide else "advect_dataflow",
                             u, v, w, AdvectParams(tcx, tcy, tzc1, tzc2),
                             y_tile or None, fuse_update, dt)


_RUNG_ARGS = ("(Tensor u, Tensor v, Tensor w, Tensor tcx, Tensor tcy, "
              "Tensor tzc1, Tensor tzc2, int y_tile, ")
_OP_K3 = L.define(
    "advect_blocked", _RUNG_ARGS + "bool fuse_update, float dt) -> "
    "(Tensor, Tensor, Tensor)", kind="field", cpu=_k3_cpu, cuda=_k3_cuda,
    fake=_fields_fake, static=("y_tile", "fuse_update"))
_OP_K2 = L.define(
    "advect_dataflow", _RUNG_ARGS + "bool wide, bool fuse_update, float dt) "
    "-> (Tensor, Tensor, Tensor)", kind="field", cpu=_k2_cpu, cuda=_k2_cuda,
    fake=_fields_fake, static=("y_tile", "wide", "fuse_update"))


def advect_blocked(u, v, w, p: AdvectParams, *, y_tile: int | None = None,
                   tiling: str = "grid", fuse_update: bool = False,
                   dt: float = 1.0):
    """v1: PW sources of (X, Y, Z) fields, zero on the boundary, or with
    `fuse_update=True` the fields advanced one Euler step. Every output
    slice re-reads its three input slices (the paper's anti-pattern).
    `y_tile` runs the in-grid tiling; on CUDA, None runs the kernel's own
    plan (`rung_launch_plan`) and a tile taller than the plan's runs as
    equal sub-tiles, bitwise the same. `tiling="host"` runs the host tile
    loop.
    """
    return _advect_rung("advect_blocked", u, v, w, p, y_tile, tiling,
                        fuse_update, dt)


def advect_dataflow(u, v, w, p: AdvectParams, *, y_tile: int | None = None,
                    tiling: str = "grid", fuse_update: bool = False,
                    dt: float = 1.0):
    """v2: `advect_blocked`'s values, bitwise, through a ring of slices
    per field that reads each slice once per x chunk."""
    return _advect_rung("advect_dataflow", u, v, w, p, y_tile, tiling,
                        fuse_update, dt)


def advect_wide(u, v, w, p: AdvectParams, *, y_tile: int | None = None,
                tiling: str = "grid", fuse_update: bool = False,
                dt: float = 1.0):
    """v3: `advect_dataflow` with 16-byte loads and stores (4 f32 or 8
    bf16 cells a move).

    Its contract is the card's, not the TPU's (Z % 128, Y % 8): each Z row
    must be whole 16-byte vectors (Z * itemsize % 16 == 0: Z % 4 in f32,
    Z % 8 in bf16) and the fields must start on 16-byte boundaries, else
    this raises; it runs the in-grid path only and refuses host tiling, as
    the reference does. So it runs at the paper's Z = 64, where the TPU's
    contract refuses it."""
    return _advect_rung("advect_wide", u, v, w, p, y_tile, tiling,
                        fuse_update, dt)


# ---------------------------------------------------------------------------
# K4: the finite guard
# ---------------------------------------------------------------------------


def _finite_guard_plain(u, v, w):
    """Plain version: (..., X) f32 flags, 1.0 iff slice x is all finite
    (f32 or bf16 fields; the flags are f32 either way, as the
    reference's)."""
    ok = torch.ones(u.shape[:-2], dtype=torch.bool, device=u.device)
    for f in (u, v, w):
        ok &= torch.isfinite(f).flatten(-2).all(dim=-1)
    return ok.to(torch.float32)


def _finite_guard_cuda(u, v, w):
    """Launch the finite-guard CUDA kernel on (B, X, Y, Z) fields."""
    B, X, Y, Z = u.shape
    check_launch_grid((X, B, 1), "K4 (finite_guard)")
    lib = _build.load()
    flags = torch.empty((B, X), dtype=torch.float32, device=u.device)
    # 16-byte loads where a slice is whole 16-byte words: 4 f32 or 8 bf16
    # cells
    per_word = 16 // u.element_size()
    vec = int((Y * Z) % per_word == 0
              and all(f.data_ptr() % 16 == 0 for f in (u, v, w)))
    entry = ("finite_guard_bf16" if u.dtype == torch.bfloat16
             else "finite_guard_f32")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = getattr(lib, entry)(u.data_ptr(), v.data_ptr(), w.data_ptr(),
                                  flags.data_ptr(), B, X, Y * Z, vec, stream)
    _build.check(err, entry)
    LAUNCHES["finite_guard"] += 1
    return flags


def finite_guard(u, v, w):
    """Flags of the x-slices that are entirely finite in u, v and w.

    (X, Y, Z) fields (f32 or bf16) give (X,) f32 flags, slot-stacked
    (B, X, Y, Z) fields give (B, X): ``flags[..., x] == 1.0`` iff slice x of all three fields is
    finite, so ``flags.min() > 0`` iff the whole state is. Its bytes are
    `roofline.guard_bytes_model`."""
    if not torch.is_tensor(u) or u.ndim not in (3, 4):
        raise ValueError("finite_guard takes (X, Y, Z) or slot-stacked "
                         "(B, X, Y, Z) fields")
    _check_fields(u, v, w, u.ndim, "(X, Y, Z) or (B, X, Y, Z)")
    if u.ndim == 3:
        return _OP_K4(u[None], v[None], w[None])[0]
    return _OP_K4(u, v, w)


def _k4_cuda(u, v, w):
    _build.load()
    return _finite_guard_cuda(u, v, w)


def _k4_fake(u, v, w):
    return u.new_empty(u.shape[:2], dtype=torch.float32)


_OP_K4 = L.define("finite_guard", "(Tensor u, Tensor v, Tensor w) -> Tensor",
                  kind="guard", cpu=_finite_guard_plain, cuda=_k4_cuda,
                  fake=_k4_fake)


# ---------------------------------------------------------------------------
# K6: the spec ring
# ---------------------------------------------------------------------------

def _cuda_instantiation(spec):
    """(functor, stages) of the K6 build that runs `spec` on the card: the
    functor is a shipped one's id (`_build.K6_BUILDS`) or the one generated
    from the spec's callback (a `stencil.spec_cuda.Generated`), read off
    the spec (`spec.cuda_functor()`); raises NotImplementedError naming
    ROADMAP Queue 2, before any build, for a spec K6 cannot run (radius
    > 1, x-diagonal reads, more than four fields, operations other than
    + - *)."""
    return spec.cuda_functor(), spec.stages


def spec_on_card(spec) -> bool:
    """Whether K6 runs `spec` on the card (`_cuda_instantiation`)."""
    try:
        _cuda_instantiation(spec)
    except NotImplementedError:
        return False
    return True


def _k6_builds(op, stages: int) -> dict:
    """{cells per thread: threads} of the functor's builds at `stages`: a
    generated functor takes those of the shipped one of its field count."""
    return _build.K6_BUILDS[op if isinstance(op, int) else op.like, stages]


def _k6_vectors(op) -> int:
    """The z-coefficient vectors the functor stages per window cell."""
    return _build.K6_COEF_VECTORS[op] if isinstance(op, int) else \
        op.n_vectors


# K6's entry points by build (bf16 fields, bf16 coefficients): (launch,
# attributes)
_SPEC_ENTRY = {(False, False): ("stencil_fused_f32", "stencil_fused_attrs"),
               (True, False): ("stencil_fused_bf16",
                               "stencil_fused_bf16_attrs"),
               (True, True): ("stencil_fused_bf16_coef",
                              "stencil_fused_bf16_coef_attrs")}


def _k6_entry(op, stages: int, build: Tuple[bool, bool]):
    """(library, launch entry, attributes entry, op argument) of the K6
    build that runs functor `op` at `stages` in storage `build`: the shipped
    library's, or the generated functor's own build (`_build.
    load_generated`, compiled at first use)."""
    if isinstance(op, int):
        return (_build.load(),) + _SPEC_ENTRY[build] + (op,)
    flags = _build.generated_flags(stages, *build, _k6_builds(op, stages))
    return (_build.load_generated(op.text, flags), "k6_generated",
            "k6_generated_attrs", 0)


def build_spec_kernels(cases) -> int:
    """Build, all at once (one nvcc each, started together), the generated
    K6 builds that `cases` launch, each ``(spec, field dtype, whether the
    coefficients are bf16)``; a shipped functor needs none, and a build made
    before is reused. Returns the number of generated builds the cases
    take."""
    jobs = []
    for spec, dtype, coef in cases:
        op, stages = _cuda_instantiation(spec)
        if isinstance(op, int):
            continue
        job = (op.text, _build.generated_flags(
            stages, *_build_of(dtype, coef), _k6_builds(op, stages)))
        if job not in jobs:
            jobs.append(job)
    _build.build_generated(jobs)
    return len(jobs)


def _coef_is_bf16(pv) -> bool:
    """Whether the parameter vectors are bf16 (every one of them)."""
    return bool(pv) and all(p.dtype == torch.bfloat16 for p in pv)


def _check_spec_fields(fields, spec, rank: int, what: str) -> None:
    if len(fields) != spec.n_fields:
        raise ValueError(
            f"spec {spec.name!r} has {spec.n_fields} fields "
            f"({spec.fields}), got {len(fields)} arrays")
    for name, f in zip(spec.fields, fields):
        if not torch.is_tensor(f):
            raise TypeError(f"field {name!r} must be a torch.Tensor, got "
                            f"{type(f).__name__}")
        if f.ndim != rank:
            raise ValueError(f"field {name!r} must be {what}, got rank "
                             f"{f.ndim}")
    shape = fields[0].shape
    for name, f in zip(spec.fields, fields):
        if f.shape != shape:
            raise ValueError(f"field {name!r} shape {tuple(f.shape)} != "
                             f"{tuple(shape)}")
        if f.dtype not in FIELD_DTYPES:
            raise TypeError(f"field {name!r} must be float32 or bfloat16, "
                            f"got {f.dtype}")
        if f.dtype != fields[0].dtype:
            raise TypeError(f"field {name!r} is {f.dtype}, "
                            f"{spec.fields[0]!r} {fields[0].dtype}")
        if f.device != fields[0].device:
            raise ValueError(f"field {name!r} is on {f.device}, "
                             f"{spec.fields[0]!r} on {fields[0].device}")
        if not f.is_contiguous():
            raise ValueError(f"field {name!r} must be contiguous")


def _spec_param_vectors(spec, params, device,
                        dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """`spec.pack_params(params)` as vectors on `device`, checked 1-D: bf16
    where the fields are (`dtype`) and every vector is, as a bf16 domain's
    coefficients are, else f32 (K1's rule, `_slot_params`)."""
    pv = tuple(torch.as_tensor(p, device=device)
               for p in spec.pack_params(params))
    for p in pv:
        if p.ndim != 1:
            raise ValueError(
                f"spec {spec.name!r}: pack_params must return 1-D vectors, "
                f"got shape {tuple(p.shape)}")
    keep = dtype == torch.bfloat16 and _coef_is_bf16(pv)
    return tuple(p.to(torch.bfloat16 if keep else torch.float32) for p in pv)


def _stencil_fused_plain(fields, pv, spec, T: int, dt: float, xm, ym,
                         y_tile=None):
    """Plain PyTorch version of the spec ring: T masked integrator steps
    of the spec's sources over (B, X, Y, Z) fields. Euler
    `f + dt*where(m, S(f), 0)`; rk2 `g = f + (dt/2)*where(m, S(f), 0)`, then
    `f + dt*where(m, S(g), 0)`, m being the x/y interior mask, each update
    the kernels' (`_euler`: the source rounded to the field's dtype, dt a
    weak scalar), so that bf16 fields run op for op as the reference's
    ring does. `y_tile` is taken and ignored, since tiled and untiled
    results are equal by contract."""
    del y_tile
    X = fields[0].shape[-3]
    r = spec.radius
    j = torch.arange(X, device=fields[0].device)
    x_ok = (j >= r) & (j <= X - 1 - r) & (xm > 0.0)
    m = x_ok[..., :, None, None] & (ym > 0.0)[..., None, :, None]

    def masked(fs):
        return tuple(torch.where(m, s, 0.0)
                     for s in spec.packed_sources(fs, pv))

    fields = tuple(fields)
    for _ in range(T):
        if spec.stages == 1:
            fields = tuple(_euler(f, s, dt)
                           for f, s in zip(fields, masked(fields)))
        else:
            g = tuple(_euler(f, s, 0.5 * dt)
                      for f, s in zip(fields, masked(fields)))
            fields = tuple(_euler(f, s, dt) for f, s in zip(fields, masked(g)))
    return fields


def spec_passes(spec, T: int) -> List[int]:
    """The depths of the K6 launches that advance T steps of `spec`: whole
    steps, at most ``_build.K6_MAX_LEVELS // spec.stages`` a pass (two
    levels a step for rk2), split as `fused_passes` splits K1's. Each pass
    is T_k masked integrator steps, so the passes in turn are the T steps,
    bitwise."""
    return fused_passes(T, _build.K6_MAX_LEVELS // spec.stages)


def spec_plan_knobs(spec, T: int) -> PlanKnobs:
    """The `PlanKnobs` of one K6 pass of T steps of `spec`, whose planner's
    T is the pass's levels, ``spec.stages * T`` (= `spec.halo(T)`): the
    spec's fields, its functor's z-coefficient vectors
    (`_build.K6_COEF_VECTORS`, or a generated functor's), its builds
    (`_build.K6_BUILDS`; a generated functor takes those of the shipped one
    of its field count) and the slab its own tile aims at: the most cells a
    block of those builds holds (threads x cells per thread; 1024 for PW and
    the tracer, as K1's `K1_PLAN_CELLS`, 2048 for diffusion's single
    field). The storage (f32 or bf16) plans alike: the ring's registers and
    planes hold f32 words.
    Raises NotImplementedError for a spec outside the CUDA table and
    ValueError for more levels than a build holds (`spec_passes` splits
    deeper T)."""
    op, stages = _cuda_instantiation(spec)
    if stages * T > _build.K6_MAX_LEVELS:
        raise ValueError(
            f"K6 is built for up to {_build.K6_MAX_LEVELS} ring levels a "
            f"pass, and {spec.name} at T={T} needs {stages * T}; "
            f"spec_passes(spec, T) splits it into passes of whole steps")
    builds = _k6_builds(op, stages)
    return PlanKnobs(spec.n_fields, _k6_vectors(op), tuple(builds.items()),
                     max(c * n for c, n in builds.items()), "K6")


def spec_launch_plan(X: int, Y: int, Z: int, spec, T: int, B: int,
                     n_sm: int, blocks_per_sm: int, *,
                     y_tile: Optional[int] = None) -> FusedPlan:
    """One K6 pass of T steps of `spec` over (B, X, Y, Z) fields on a card
    of `n_sm` SMs that holds `blocks_per_sm` of the pass's blocks at once:
    K1's planner (`fused_launch_plan`) at the spec's ``spec.stages * T``
    levels, which are its halo D = `spec.halo(T)` at radius 1, and with its
    fields, z-coefficient vectors and builds (`spec_plan_knobs`). `y_tile`
    None is K6's own tile (a slab of about the most cells a block of its
    builds holds); a given tile runs as given, or as the fewest equal
    sub-tiles a build takes. Raises ValueError, naming the limit, for more
    levels than a build holds or a grid beyond CUDA's."""
    return _ring_launch_plan(X, Y, Z, spec.stages * T, B, n_sm,
                             blocks_per_sm, y_tile,
                             spec_plan_knobs(spec, T))


@functools.lru_cache(maxsize=64)
def _spec_attrs_cached(index: int, op, stages: int, T: int, C: int,
                       threads: int, shared: int,
                       build: Tuple[bool, bool] = (False, False)
                       ) -> Tuple[int, int, int, int]:
    """The card's attributes of K6's (op, stages, T, C) build in storage
    `build` (bf16 fields, bf16 coefficients)."""
    lib, _, entry, op_id = _k6_entry(op, stages, build)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        err = getattr(lib, entry)(op_id, stages, T, C, threads, shared, out)
    _build.check(err, entry)
    return tuple(out)


def spec_device_plan(device, X: int, Y: int, Z: int, spec, T: int,
                     B: int = 1, y_tile: Optional[int] = None, *,
                     dtype=torch.float32, coef: bool = False) -> FusedPlan:
    """`spec_launch_plan` on `device`'s card: its SM count, and the resident
    blocks per SM the card reports for the pass's build (f32, or bf16
    fields with f32 or bf16 coefficients, `coef`)."""
    index = _device_index(device)
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    op, stages = _cuda_instantiation(spec)
    blk = _fused_block(Y, Z, stages * T, y_tile, spec_plan_knobs(spec, T))
    per_sm = _spec_attrs_cached(index, op, stages, T, blk.C, blk.threads,
                                blk.shared, _build_of(dtype, coef))[3]
    return spec_launch_plan(X, Y, Z, spec, T, B, n_sm, per_sm, y_tile=y_tile)


def spec_kernel_attrs(device, spec, T: int, plan: FusedPlan, *,
                      dtype=torch.float32, coef: bool = False) -> dict:
    """What the card says of the K6 build that runs `plan` (a pass of T
    steps of `spec`, f32 or bf16 fields with f32 or bf16 coefficients):
    registers and local (spill) bytes per thread, the most threads a block
    of it can have, and its resident blocks per SM at the plan's threads and
    shared bytes."""
    op, stages = _cuda_instantiation(spec)
    regs, local, most, per_sm = _spec_attrs_cached(
        _device_index(device), op, stages, T, plan.cells_per_thread,
        plan.threads, plan.shared_bytes, _build_of(dtype, coef))
    return {"registers": regs, "local_bytes": local, "max_threads": most,
            "blocks_per_sm": per_sm}


def _param_block(pv, device, pad: int = 0) -> Tuple[torch.Tensor, int]:
    """The kernel's parameter vectors as f32 (bf16 ones as their exact f32
    values), each with `pad` zeros before it and zeros after it to the
    longest plus `pad`, p_len, and laid back to back; one zero where there
    are none."""
    if not pv:
        return torch.zeros(1, dtype=torch.float32, device=device), 1
    p_len = max(p.shape[0] for p in pv) + 2 * pad
    return torch.cat([torch.cat([p.new_zeros(pad, dtype=torch.float32),
                                 p.float(), p.new_zeros(
        p_len - pad - p.shape[0], dtype=torch.float32)]) for p in pv]), p_len


def _stencil_fused_cuda(fields, pv, spec, T: int, dt: float, xm, ym,
                        y_tile=None, *, plan: Optional[FusedPlan] = None):
    """Launch K6 on (B, X, Y, Z) fields: one launch a pass of
    `spec_passes(spec, T)`, each on `spec_device_plan`'s plan for this
    card, or on `plan`, a plan made for these shapes and T (one pass). A
    shipped functor runs in the library's build of the fields' storage
    (`csrc/stencil_fused*.cu`), a generated one in its own
    (`csrc/stencil_generated.cu`)."""
    op, stages = _cuda_instantiation(spec)
    B, X, Y, Z = fields[0].shape
    if isinstance(op, int):
        if any(tuple(p.shape) != (Z + 2,) for p in pv):
            raise ValueError(f"the CUDA operators read (Z+2,) = ({Z + 2},) "
                             f"parameter vectors, got "
                             f"{[tuple(p.shape) for p in pv]}")
        n_coef = _build.K6_COEF_VECTORS[op]
        if len(pv) != n_coef:
            raise ValueError(f"spec {spec.name!r}: its CUDA operator reads "
                             f"{n_coef} parameter vectors, got {len(pv)}")
    else:
        op.check_vectors(spec.name, pv, Z)
    passes = spec_passes(spec, T)
    if plan is not None and len(passes) > 1:
        raise ValueError(f"a given plan runs one pass, T <= "
                         f"{_build.K6_MAX_LEVELS // stages}; got T={T}")
    if plan is None:
        for Tk in set(passes):   # the refusals, before any build
            _fused_block(Y, Z, stages * Tk, y_tile, spec_plan_knobs(spec, Tk))
        check_launch_grid((1, B, 1), "K6")
    dtype, coef = fields[0].dtype, _coef_is_bf16(pv)
    lib, entry, _, op_id = _k6_entry(op, stages, _build_of(dtype, coef))
    device = fields[0].device
    table, p_len = _param_block(pv, device,
                                0 if isinstance(op, int) else op.pad)
    xmt, sx = _pack_rows([xm], B)
    ymt, sy = _pack_rows([ym], B)
    outs = tuple(fields)
    pad = [None] * (4 - len(outs))
    count = "stencil_fused" if isinstance(op, int) else "stencil_generated"
    for Tk in passes:
        run = plan or spec_device_plan(device, X, Y, Z, spec, Tk, B, y_tile,
                                       dtype=dtype, coef=coef)
        ins, outs = outs, tuple(torch.empty_like(f) for f in fields)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, entry)(
                op_id, stages, *(f.data_ptr() for f in ins), *pad,
                *(o.data_ptr() for o in outs), *pad, table.data_ptr(), p_len,
                xmt.data_ptr(), ymt.data_ptr(), B, X, Y, Z, Tk, run.TY,
                run.S, run.n_ty, run.CZ, run.W, run.n_cz, run.CX, run.n_cx,
                run.cells_per_thread, run.threads, run.pitch, sx, sy,
                step_dt(dt, dtype), run.shared_bytes, stream)
        _build.check(err, entry)
        LAUNCHES[count] += 1
        LAUNCHED_SHARED["stencil_fused"] = run.shared_bytes
    return outs


def stencil_fused_batched(fields, params, spec, *, T: int = 4,
                          dt: float = 1.0, y_tile: int | None = None,
                          y_interior_mask=None, x_interior_mask=None):
    """B domains of a StencilSpec, one launch a pass of
    `spec_passes(spec, T)` (whole steps), the slot being a dimension of the
    launch grid. `fields` are slot-stacked ``(B, X, Y, Z)``;
    `params` is shared across slots; interior masks may be shared
    ``(X,)``/``(Y,)`` or per-slot ``(B, X)``/``(B, Y)``. Per-slot outputs
    equal B sequential `stencil_fused` calls bitwise."""
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    _check_y_tile(y_tile)
    fields = tuple(fields)
    _check_spec_fields(fields, spec, 4, "slot-stacked (B, X, Y, Z)")
    B, X, Y, Z = fields[0].shape
    device = fields[0].device
    xm = _mask(x_interior_mask, X, B, "x_interior_mask", device)
    ym = _mask(y_interior_mask, Y, B, "y_interior_mask", device)
    pv = list(_spec_param_vectors(spec, params, device, fields[0].dtype))
    handle = spec_handle(spec)
    for Tk in spec_passes(spec, T):
        fields = tuple(_OP_K6(list(fields), pv, xm, ym, handle, Tk,
                              float(dt), y_tile or 0))
    return fields


_SPECS: List = []            # spec_handle's specs, by handle
_SPEC_IDS: dict = {}         # id of a spec object seen -> its handle


def spec_handle(spec) -> int:
    """The int K6's op takes for `spec` (the same for equal specs): its
    index in a table of the distinct specs the process has run."""
    handle = _SPEC_IDS.get(id(spec))
    if handle is None or _SPECS[handle] is not spec:
        handle = next((i for i, s in enumerate(_SPECS) if s == spec), None)
        if handle is None:
            handle = len(_SPECS)
            _SPECS.append(spec)
        _SPEC_IDS[id(spec)] = handle
    return handle


def spec_of(handle: int):
    return _SPECS[handle]


def _k6_cpu(fields, pv, xm, ym, spec, T, dt, y_tile):
    return list(_stencil_fused_plain(fields, tuple(pv), spec_of(spec), T,
                                     dt, xm, ym))


def _k6_cuda(fields, pv, xm, ym, spec, T, dt, y_tile):
    return list(_stencil_fused_cuda(fields, tuple(pv), spec_of(spec), T, dt,
                                    xm, ym, y_tile or None))


def _k6_fake(fields, pv, xm, ym, spec, T, dt, y_tile):
    return [torch.empty_like(f) for f in fields]


_OP_K6 = L.define(
    "stencil_fused",
    "(Tensor[] fields, Tensor[] params, Tensor xm, Tensor ym, int spec, "
    "int T, float dt, int y_tile) -> Tensor[]",
    kind="field", cpu=_k6_cpu, cuda=_k6_cuda, fake=_k6_fake,
    static=("spec", "T", "y_tile"))


def stencil_fused(fields, params, spec, *, T: int = 4, dt: float = 1.0,
                  y_tile: int | None = None, y_interior_mask=None,
                  x_interior_mask=None):
    """Spec-driven v4: advance a StencilSpec's fields T integrator steps,
    one pass over device memory for each pass of whole steps of
    `spec_passes(spec, T)`, the generalisation of `advect_fused` to any
    operator.

    `fields` is a tuple of `spec.n_fields` (X, Y, Z) tensors, all float32
    or all bfloat16 (the ring then runs in bf16 as the reference's does);
    `params` is whatever `spec.pack_params` consumes (kept bf16 for bf16
    fields where every vector is, else f32). The ring depth, the startup
    masks, the slab halo and the output lag all come from
    `spec.halo(T) = radius * stages * T`; `y_tile` and the interior masks
    mean what they mean for `advect_fused`. On CUDA tensors this launches
    K6 on its own launch plan (`spec_launch_plan`; a given `y_tile` runs as
    given, or as the fewest equal sub-tiles a build takes, bitwise the
    same), one launch a pass of `spec_passes(spec, T)`: the shipped
    specs' functors (`csrc/stencil_fused.cuh`), or for any other radius-1
    spec of + - * the functor generated from its callback
    (`stencil.spec_cuda`, built at first use); a spec it cannot generate
    raises NotImplementedError there, naming ROADMAP Queue 2. On CPU
    tensors it runs the plain version, for any spec. With the PW spec it
    equals `advect_fused` bitwise.
    """
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    _check_y_tile(y_tile)
    fields = tuple(fields)
    _check_spec_fields(fields, spec, 3, "(X, Y, Z)")
    X, Y, _ = fields[0].shape
    _check_domain_masks(y_interior_mask, x_interior_mask, X, Y)
    outs = stencil_fused_batched(tuple(f[None] for f in fields), params,
                                 spec, T=T, dt=dt, y_tile=y_tile,
                                 y_interior_mask=y_interior_mask,
                                 x_interior_mask=x_interior_mask)
    return tuple(o[0] for o in outs)


# ---------------------------------------------------------------------------
# K7: the in-kernel halo-band exchange
# ---------------------------------------------------------------------------

BAND_TIMEOUT_NS = 5_000_000_000   # the bound on every spin
BAND_ERRORS = {1: "a put waited past its bound for its partners to enter "
                  "the exchange (the capacity handshake)",
               2: "a wait ran past its bound before every band arrived"}
# one row of K7's message table (`csrc/band_exchange.cu`'s `Msg`), int64
# columns in this order, every size and offset in bytes
BAND_COLUMNS = ("src", "src_off", "dst", "arrive", "runs", "run",
                "src_stride", "dst_stride", "vec16", "tile0")
BAND_THREADS = 256         # threads of one put block (kThreads)
BAND_TILE_UNITS = 1024     # 16-byte units of one tile (kTileUnits)
BAND_MAX_SOURCES = 96      # source bases one put takes (kMaxSources)
BAND_MAX_PARTNERS = 32     # partner cards one enter signals (kMaxPartners)
BAND_MAX_BYTES = 2 ** 31 - 1    # bytes of one message (32-bit indices)


def _band_schedule(L: int, depth: int):
    """Per-hop band messages of one exchange side, shared by every engine:
    ``[(k, cnt, hi_off, lo_off), ...]``. Hop k moves `cnt` =
    min(L, depth-(k-1)L) planes/rows to/from the k-away ring neighbour;
    the received bands land at extended-slab offsets `hi_off` (from the
    predecessor side, global coordinates ascending) and `lo_off` (from the
    successor side), which partition the hi halo [0, depth) and the lo
    halo [depth+L, depth+L+depth) exactly."""
    hops = -(-depth // L)
    sched = []
    for k in range(1, hops + 1):
        cnt = min(L, depth - (k - 1) * L)
        sched.append((k, cnt, depth - (k - 1) * L - cnt, depth + k * L))
    return sched


def band_checksum(band: torch.Tensor) -> torch.Tensor:
    """Integrity word over one `_band_schedule` message: the uint32
    wraparound sum of the band's raw 32-bit words, shaped ``(1,)`` (int64
    holding a value in [0, 2**32)). The int32 bit views are summed in int64
    and taken mod 2**32, so sender and receiver get the same word from the
    same bytes whatever the order. Requires a 4-byte element type."""
    if band.element_size() != 4:
        raise TypeError(
            f"band_checksum packs 32-bit words; got dtype {band.dtype} "
            f"(itemsize {band.element_size()})")
    bits = band.contiguous().view(torch.int32).to(torch.int64)
    return (bits.sum() % 2**32).reshape((1,))


def dma_slab_bytes(shape, depth: int, dim: int, itemsize: int = 4, *,
                   n_fields: int = 3) -> Tuple[int, int]:
    """``(staged_send, recv)`` bytes of the reference's remote-DMA slabs for
    one phase over a `shape` shard: per-hop ``(n_fields, 2 sides) x
    (cnt planes/rows)`` staging slabs and ``n_fields x 2 sides x 2 slots``
    of the depth band. The port's kernel stages nothing: it stores straight
    from the field into the halos of the extended buffers
    (`ExtendedBuffers`), which hold the recv slabs' bytes and the shard."""
    other = 1
    for d, s in enumerate(shape):
        if d != dim:
            other *= s
    staged = sum(n_fields * 2 * cnt * other * itemsize
                 for _, cnt, _, _ in _band_schedule(shape[dim], depth))
    recv = n_fields * 2 * 2 * depth * other * itemsize
    return staged, recv


class BandMessage(NamedTuple):
    """One band of one exchange: `cnt` planes/rows of `field` from
    `sender`'s field at `src_lo` into `receiver`'s halo of `side` (0 = hi,
    from the predecessor; 1 = lo, from the successor) at halo-local offset
    `dst_off`, hop `k`."""
    sender: int
    receiver: int
    field: int
    side: int
    k: int
    cnt: int
    src_lo: int
    dst_off: int


def band_messages(mesh, axis: str, L: int, depth: int, *,
                  n_fields: int = 3) -> List[BandMessage]:
    """Every message of one exchange of `n_fields` fields along `axis`, per
    sender in `mesh.devices` order, then field, hop and side: the
    reference's `_kernel_band_dma` loop. Side 0: my tail to the k-away
    successor's hi halo; side 1: my head to the k-away predecessor's lo
    halo."""
    n = mesh.axis_size(axis)
    msgs = []
    for s in range(len(mesh.devices)):
        me = mesh.coords(s)
        for f in range(n_fields):
            for k, cnt, hi_off, lo_off in _band_schedule(L, depth):
                fwd = mesh.index(dma_neighbor_coords(mesh.axis_names, me,
                                                     axis, k, n))
                bwd = mesh.index(dma_neighbor_coords(mesh.axis_names, me,
                                                     axis, -k, n))
                msgs.append(BandMessage(s, fwd, f, 0, k, cnt, L - cnt,
                                        hi_off))
                msgs.append(BandMessage(s, bwd, f, 1, k, cnt, 0,
                                        lo_off - (depth + L)))
    return msgs


def band_launch_plan(n_tiles: int, n_sm: int, blocks_per_sm: int) -> int:
    """Put blocks of one launch: one wave of the card (its SMs times the
    put blocks each holds), fewer when the phase has fewer tiles."""
    if n_tiles < 1 or n_sm < 1 or blocks_per_sm < 1:
        raise ValueError(f"tiles {n_tiles}, SMs {n_sm} and blocks per SM "
                         f"{blocks_per_sm} must be >= 1")
    return min(n_tiles, n_sm * blocks_per_sm)


class ExtendedBuffers:
    """The slabs the local kernel reads after an exchange, landed in place.

    Per shard of `mesh`, on its device, one tensor ``(n_fields, 2,
    X + 2px, Y + 2py, Z)`` of the fields' `dtype` (float32 or bfloat16; 3
    fields, u, v and w, unless `n_fields` says otherwise): field f, slot k
    (block_index % 2) is ``bufs[s][f, k]``,
    the shard's ``(X, Y, Z)`` at ``[px, px + X) x [py, py + Y)`` with `px`
    halo planes and `py` halo rows on each side (`pad = (px, py)`). Two
    slots keep the reference's guarantee: block k+1's bands land where
    block k does not read. `fill` initialises them."""

    def __init__(self, mesh, shape, pad, *, fill: float = 0.0,
                 n_fields: int = 3, dtype=torch.float32):
        X, Y, Z = shape
        px, py = pad
        if px < 0 or py < 0:
            raise ValueError(f"pad must be >= 0, got {tuple(pad)}")
        if n_fields < 1:
            raise ValueError(f"n_fields must be >= 1, got {n_fields}")
        self.shape, self.pad = (X, Y, Z), (px, py)
        self.n_fields, self.dtype = n_fields, dtype
        self.ext_shape = (X + 2 * px, Y + 2 * py, Z)
        self.devices = tuple(mesh.devices)
        self.bufs = [torch.full((n_fields, 2) + self.ext_shape, fill,
                                dtype=dtype, device=dev)
                     for dev in self.devices]


class BandSlabs:
    """The state of one K7 phase on a mesh that lasts from block to block.

    The phase exchanges `depth` planes (dim 0) or rows (dim 1) of shards of
    `shape` and lands them, with each shard's own planes, in extended
    buffers: per shard, field and slot the REGION ``buffers.bufs[s][f,
    slot]`` cut to ``[window, window + shape[1 - dim])`` along the other of
    dims 0 and 1, which is `shape` widened by `depth` on each side along
    `dim` (`region`). Without `buffers` the phase has its own
    `ExtendedBuffers` of `n_fields` fields, padded along `dim` only and
    filled with `fill`; the
    distributed block gives its x and y phases one set, the y phase's
    region being the whole buffer, whose middle rows the x phase filled.
    The buffers' dtype is the fields' (`dtype`, or the given buffers').

    Per shard, three u64 words ``[barrier, arrivals, error]``
    (`words[shard]`); a card's first shard holds the card's words when its
    messages cross to other cards. They count monotone epochs, one per
    exchange (`epoch`), so no exchange resets them. `check()` raises when a
    kernel set an error word. `table()` keeps each layout's messages (a
    `BandTable`) for the next block."""

    def __init__(self, mesh, shape, depth: int, dim: int, *,
                 fill: float = 0.0, buffers: Optional[ExtendedBuffers] = None,
                 window: int = 0, n_fields: int = 3, dtype=torch.float32):
        self.shape, self.depth, self.dim = tuple(shape), depth, dim
        self.mesh, self.devices = mesh, tuple(mesh.devices)
        if buffers is None:
            pad = (depth, 0) if dim == 0 else (0, depth)
            buffers = ExtendedBuffers(mesh, shape, pad, fill=fill,
                                      n_fields=n_fields, dtype=dtype)
        self.n_fields, self.dtype = buffers.n_fields, buffers.dtype
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        ext = list(self.shape)
        ext[dim] += 2 * depth
        other = 1 - dim
        be = buffers.ext_shape
        if (buffers.devices != self.devices or be[dim] != ext[dim]
                or be[2] != ext[2] or window < 0
                or window + ext[other] > be[other]):
            raise ValueError(f"buffers of {be} on {buffers.devices} hold no "
                             f"region {tuple(ext)} at {window} along dim "
                             f"{other} on {self.devices}")
        self.buffers, self.window = buffers, window
        self.words = [torch.zeros(3, dtype=torch.int64, device=dev)
                      for dev in self.devices]
        self.epoch = 0
        self._due = {}           # card -> [barrier, arrivals] due so far
        self._msgs = {}          # axis -> (messages, bytes each shard sends)
        self._tables = {}        # (axis, slot, in place) -> BandTable
        self._views = {}         # (what, slot) -> per shard views

    def matches(self, mesh, shape, depth: int, dim: int,
                n_fields: int = 3, dtype=torch.float32) -> bool:
        return (tuple(mesh.devices) == self.devices
                and tuple(mesh.shape) == tuple(self.mesh.shape)
                and tuple(shape) == self.shape and depth == self.depth
                and dim == self.dim and n_fields == self.n_fields
                and dtype == self.dtype)

    def region(self, shard: int, field: int, slot: int) -> torch.Tensor:
        """The extended slab of one shard and field in slot `slot`."""
        return self.buffers.bufs[shard][field, slot].narrow(
            1 - self.dim, self.window, self.shape[1 - self.dim])

    def _per_shard(self, what: str, slot: int, view):
        key = (what, slot)
        if key not in self._views:
            self._views[key] = [tuple(view(self.region(s, f, slot))
                                      for f in range(self.n_fields))
                                for s in range(len(self.devices))]
        return self._views[key]

    def extended(self, slot: int):
        """Per shard the extended fields (u, v, w) of slot `slot`."""
        return self._per_shard("extended", slot, lambda r: r)

    def interior(self, slot: int):
        """Per shard the field views where its own planes land: passed
        as the fields of an exchange of that slot, they stay in place and
        only the bands move."""
        d, L = self.depth, self.shape[self.dim]
        return self._per_shard("interior", slot,
                               lambda r: r.narrow(self.dim, d, L))

    def bands(self, slot: int):
        """Per shard the reference's ``((u_hi, u_lo), (v_hi, v_lo), (w_hi,
        w_lo))`` of slot `slot`: `hi` the halo below the shard (from the
        ring predecessors), `lo` the halo above it."""
        key = ("bands", slot)
        if key not in self._views:
            d, L, dim = self.depth, self.shape[self.dim], self.dim
            self._views[key] = [
                tuple((r.narrow(dim, 0, d), r.narrow(dim, d + L, d))
                      for r in trio) for trio in self.extended(slot)]
        return self._views[key]

    def messages(self, axis: str):
        """(`band_messages` of this phase along `axis`, the bytes each shard
        sends), computed once per axis."""
        if axis not in self._msgs:
            msgs = band_messages(self.mesh, axis, self.shape[self.dim],
                                 self.depth, n_fields=self.n_fields)
            other = math.prod(self.shape) // self.shape[self.dim]
            sent = [0] * len(self.devices)
            for m in msgs:
                sent[m.sender] += m.cnt * other * self.itemsize
            self._msgs[axis] = (msgs, sent)
        return self._msgs[axis]

    def table(self, axis: str, slot: int, fields) -> "BandTable":
        """The messages of an exchange of `fields` along `axis` into slot
        `slot`, built once per (axis, slot, whether the fields are this
        slot's `interior` views: the same memory, shape and strides).
        Fields that are not must be contiguous."""
        inner = self.interior(slot)
        in_place = all(_same_view(f, own) for trio, own_trio in
                       zip(fields, inner) for f, own in zip(trio, own_trio))
        if not in_place:
            for s, trio in enumerate(fields):
                for name, f in zip(_field_names(len(trio)), trio):
                    if not f.is_contiguous():
                        raise ValueError(
                            f"shard {s} {name} must be contiguous, or the "
                            f"interior view of slot {slot} of these slabs")
        key = (axis, slot, in_place)
        if key not in self._tables:
            self._tables[key] = BandTable(self, axis, slot, in_place)
        return self._tables[key]

    def check(self) -> None:
        """Raise RuntimeError naming each shard whose kernel timed out."""
        if any(L.is_fake(w) for w in self.words):
            return   # a trace: no kernel ran
        bad = {s: int(w[2]) for s, w in enumerate(self.words) if int(w[2])}
        if bad:
            why = "; ".join(
                f"shard {s}: " + ", ".join(t for b, t in BAND_ERRORS.items()
                                           if code & b)
                for s, code in bad.items())
            raise RuntimeError(f"band exchange failed after epoch "
                               f"{self.epoch}: {why}")


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two views address the same elements of one allocation."""
    root_a = a if a._base is None else a._base
    root_b = b if b._base is None else b._base
    return (root_a is root_b and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and a.stride() == b.stride())


def _runs(shape, src_strides, dst_strides):
    """(runs, run, src_stride, dst_stride) in cells of a copy of `shape`
    between two views whose z rows are contiguous: the rows of one x
    merge into a run where both sides hold them back to back, and so do
    the x planes."""
    n0, n1, n2 = shape
    if src_strides[2] != 1 or dst_strides[2] != 1:
        raise ValueError("the band exchange copies contiguous z rows")
    if n1 > 1 and not (src_strides[1] == dst_strides[1] == n2):
        raise ValueError("the band exchange copies whole rows of an x plane")
    run = n1 * n2
    if n0 == 1 or (src_strides[0] == dst_strides[0] == run):
        return 1, n0 * run, run, run
    return n0, run, src_strides[0], dst_strides[0]


class _CardPut:
    """One card's share of a `BandTable`: its rows in device memory and
    what its launches need."""

    def __init__(self, card, shards):
        self.card, self.shards = card, shards
        self.rows, self.tiles = [], 0
        self.crossing = set()       # remote receiver cards (barrier due)
        self.senders = set()        # remote cards storing here (enter)
        self.arrivals = 0           # crossing tiles landing here
        self.table = None           # rows in device memory
        self.sources_at = None      # its sources in the call's ptrs
        self.words = None           # its leader's words, when crossing
        self.grid = 0
        self.ptrs = None            # the last call's source bases
        self.sources = None
        self.aligned = 0


# K7's op takes its table by handle: every live `BandTable`, weakly held,
# by its handle, the count of tables built before it
BAND_TABLES: "weakref.WeakValueDictionary[int, BandTable]" = \
    weakref.WeakValueDictionary()
BAND_TABLES_BUILT = 0


class BandTable:
    """K7's messages for one phase, axis, slot and source layout: the bands
    (`msgs`, the reference's `band_messages`) and, when the fields are not
    already in place, each shard's own planes into its interior. The rows
    of `csrc/band_exchange.cu`'s table (`rows()`, columns `BAND_COLUMNS`)
    are built at first use, per sender card: the device table, the peer
    pairs and the handshake's counts are made once here, not per
    exchange."""

    def __init__(self, slabs: BandSlabs, axis: str, slot: int,
                 in_place: bool):
        # held weakly: the slabs keep their tables, so that a run's extended
        # buffers go when the run does, with no cycle for the collector
        self._slabs = weakref.ref(slabs)
        self.axis, self.slot = axis, slot
        self.in_place = in_place
        self.msgs, self.sent = slabs.messages(axis)
        self._puts = None
        self.peers_enabled = False
        global BAND_TABLES_BUILT
        self.handle = BAND_TABLES_BUILT
        BAND_TABLES_BUILT += 1
        BAND_TABLES[self.handle] = self

    @property
    def slabs(self) -> BandSlabs:
        slabs = self._slabs()
        if slabs is None:
            raise ReferenceError("the BandSlabs of this BandTable are gone")
        return slabs

    def dst_offset(self, m: BandMessage) -> int:
        """Where message `m` lands along the phase's dim of its region."""
        s = self.slabs
        return (m.dst_off if m.side == 0
                else s.depth + s.shape[s.dim] + m.dst_off)

    def rows(self):
        """``{card: [row, ...]}`` with each row's columns as in
        `BAND_COLUMNS`, the sources indexed per card (`n_fields` per shard,
        in mesh order), the tiles numbered per card."""
        return {p.card: p.rows for p in self._card_puts()}

    def _card_puts(self):
        if self._puts is not None:
            return self._puts
        sl = self.slabs
        dim, depth, shape, n = sl.dim, sl.depth, sl.shape, sl.n_fields
        cards = list(dict.fromkeys(sl.devices))
        on = {c: [s for s, d in enumerate(sl.devices) if d == c]
              for c in cards}
        src_index = {s: n * on[sl.devices[s]].index(s) for s in
                     range(len(sl.devices))}
        src_strides = (sl.interior(self.slot)[0][0].stride() if self.in_place
                       else (shape[1] * shape[2], shape[2], 1))
        dst_strides = sl.region(0, 0, self.slot).stride()
        leader = {c: on[c][0] for c in cards}
        copies = []   # (sender, receiver, field, shape, src_off, dst view)
        if not self.in_place:
            for s in range(len(sl.devices)):
                for f in range(n):
                    copies.append((s, s, f, shape, 0, sl.interior(
                        self.slot)[s][f]))
        for m in self.msgs:
            cut = list(shape)
            cut[dim] = m.cnt
            dst = sl.region(m.receiver, m.field, self.slot).narrow(
                dim, self.dst_offset(m), m.cnt)
            copies.append((m.sender, m.receiver, m.field, tuple(cut),
                           m.src_lo * src_strides[dim], dst))
        if max(len(v) for v in on.values()) * n > BAND_MAX_SOURCES:
            raise ValueError(f"the band exchange kernel takes "
                             f"{BAND_MAX_SOURCES // n} shards a card")
        puts = {c: _CardPut(c, on[c]) for c in cards}
        item = sl.itemsize
        for s, r, f, cut, src_off, dst in copies:
            runs, run, ss, ds = _runs(cut, src_strides, dst_strides)
            run, ss, ds, off = run * item, ss * item, ds * item, src_off * item
            if runs * run > BAND_MAX_BYTES:
                raise ValueError(f"a band exchange message of {runs * run} "
                                 f"bytes exceeds the kernel's 32-bit indices")
            p, rc = puts[sl.devices[s]], sl.devices[r]
            crossing = rc != p.card
            arrive = sl.words[leader[rc]].data_ptr() + 8 if crossing else 0
            vec16 = int(run % 16 == 0 and ss % 16 == 0 and ds % 16 == 0
                        and off % 16 == 0 and dst.data_ptr() % 16 == 0)
            units = -(-runs * run // 16)
            tiles = -(-units // BAND_TILE_UNITS)
            p.rows.append([src_index[s] + f, off, dst.data_ptr(), arrive,
                           runs, run, ss, ds, vec16, p.tiles])
            p.tiles += tiles
            if crossing:
                p.crossing.add(rc)
                puts[rc].senders.add(p.card)
                puts[rc].arrivals += tiles
        if max(len(p.senders) for p in puts.values()) > BAND_MAX_PARTNERS:
            raise ValueError(f"the band exchange kernel's enter signals "
                             f"{BAND_MAX_PARTNERS} partner cards")
        self._puts = list(puts.values())
        return self._puts

    def launches(self):
        """The card puts with their device tables, grids and words, made
        once."""
        puts = self._card_puts()
        if puts and puts[0].words is None:
            sl = self.slabs
            n = sl.n_fields
            for p in puts:
                p.words = sl.words[p.shards[0]].data_ptr()
                at = [n * s + f for s in p.shards for f in range(n)]
                p.sources_at = (None if at == list(range(n * len(sl.devices)))
                                else at)
                if p.rows:
                    p.table = torch.tensor(p.rows, dtype=torch.int64,
                                           device=p.card)
                    n_sm, _, _, per_sm = _band_attrs_cached(p.card.index)[:4]
                    p.grid = band_launch_plan(p.tiles, n_sm, per_sm)
        return puts


@functools.lru_cache(maxsize=None)
def _band_attrs_cached(index: int):
    with torch.cuda.device(index):
        n_sm = torch.cuda.get_device_properties(index).multi_processor_count
        out = (ctypes.c_int * 7)()
        _build.check(_build.load().band_exchange_attrs(out),
                     "band_exchange_attrs")
    return (n_sm,) + tuple(out)


def band_kernel_attrs(device) -> dict:
    """What the card says of K7's put kernel: its SMs, registers and local
    (spill) bytes per thread, resident blocks per SM, and the table limits
    the source was built with (threads, tile units, sources, partners)."""
    n_sm, regs, local, per_sm, threads, tile, srcs, partners = \
        _band_attrs_cached(_device_index(device))
    return {"sms": n_sm, "registers": regs, "local_bytes": local,
            "blocks_per_sm": per_sm, "threads": threads, "tile_units": tile,
            "max_sources": srcs, "max_partners": partners}


def _band_exchange_plain(fields, slabs: BandSlabs, table: BandTable,
                         wire=None) -> None:
    """Plain PyTorch version of K7: each shard's own planes into its
    interior (unless they lie there), then each band as a tensor copy into
    the receiver's halo, slot `table.slot`, at its offset (the reference's
    `_exchange_remote_dma_emulated`). `wire(msg, sent, received)` may stand
    between send and receive (the integrity layer's checksum words and
    fault hook) and returns the band that lands."""
    dim, slot = slabs.dim, table.slot
    if not table.in_place:
        for trio, own in zip(fields, slabs.interior(slot)):
            for f, dst in zip(trio, own):
                dst.copy_(f)
    for m in table.msgs:
        sent = fields[m.sender][m.field].narrow(dim, m.src_lo, m.cnt)
        dst = slabs.region(m.receiver, m.field, slot).narrow(
            dim, table.dst_offset(m), m.cnt)
        got = L.band_send(sent, dst.device, m.sender)
        if wire is not None:
            got = wire(m, sent, got)
        dst.copy_(got)


_PEERS_ENABLED = set()


def _enable_peers(pairs) -> None:
    """Let each (card, peer) pair store into the peer's memory; raises when
    the pair has no peer access (no route through a copy)."""
    lib = _build.load()
    for dev, peer in pairs:
        if dev == peer or (dev, peer) in _PEERS_ENABLED:
            continue
        err = lib.band_exchange_enable_peer(dev, peer)
        if err == -1:
            raise RuntimeError(f"cuda:{dev} cannot access cuda:{peer}'s "
                               f"memory (cudaDeviceCanAccessPeer is 0): the "
                               f"band exchange stores across cards directly")
        _build.check(err, "band_exchange_enable_peer")
        _PEERS_ENABLED.add((dev, peer))


def _on_card(index: int):
    """Make card `index` current around a launch, unless it is."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def _band_exchange_cuda(slabs: BandSlabs, table: BandTable, ptrs) -> None:
    """Launch K7 (`csrc/band_exchange.cu`): one put per card on its current
    stream, carrying every message of its shards, whose fields' base
    pointers are `ptrs` (shard by shard, u, v, w). A card whose messages
    cross to other cards also launches an enter before any put and a wait
    after every put; on one card stream order is the handshake."""
    lib = _build.load()
    puts = table.launches()
    if not table.peers_enabled:
        _enable_peers({pair for p in puts for r in p.crossing
                       for pair in ((p.card.index, r.index),
                                    (r.index, p.card.index))})
        table.peers_enabled = True
    slabs.epoch += 1
    due = slabs._due
    streams = {}
    for p in puts:
        d = due.setdefault(p.card, [0, 0])
        d[0] += len(p.crossing)
        d[1] += p.arrivals
        streams[p.card] = torch.cuda.current_stream(p.card).cuda_stream
        if p.senders:
            words = [q.words for q in puts if q.card in p.senders]
            with _on_card(p.card.index):
                err = lib.band_exchange_enter(
                    (ctypes.c_void_p * len(words))(*words), len(words),
                    streams[p.card])
            _build.check(err, "band_exchange_enter")
            LAUNCHES["band_handshake"] += 1
    for p in puts:
        if not p.rows:
            continue
        mine = (ptrs if p.sources_at is None
                else tuple(ptrs[i] for i in p.sources_at))
        if mine != p.ptrs:
            p.ptrs = mine
            p.sources = (ctypes.c_void_p * len(mine))(*mine)
            p.aligned = int(all(q % 16 == 0 for q in mine))
        with _on_card(p.card.index):
            err = lib.band_exchange_put(
                p.table.data_ptr(), len(p.rows), p.tiles, p.grid, p.sources,
                len(mine), p.aligned, p.words if p.crossing else None,
                due[p.card][0], BAND_TIMEOUT_NS, streams[p.card])
        _build.check(err, "band_exchange_put")
        LAUNCHES["band_exchange"] += 1
    for p in puts:
        if p.arrivals:
            with _on_card(p.card.index):
                err = lib.band_exchange_wait(p.words, due[p.card][1],
                                             BAND_TIMEOUT_NS,
                                             streams[p.card])
            _build.check(err, "band_exchange_wait")
            LAUNCHES["band_handshake"] += 1


def _field_names(n: int):
    return tuple("uvw") if n == 3 else tuple(f"field {i}" for i in range(n))


def _check_band_fields(fields, mesh):
    """The shape of the same number of fields of one shape and one dtype,
    float32 or bfloat16, per shard (u, v, w, or a spec's fields), on the
    mesh's devices."""
    if len(fields) != len(mesh.devices):
        raise ValueError(f"{len(fields)} shards given for a mesh of "
                         f"{len(mesh.devices)}")
    shape = None
    n = len(fields[0]) if fields else 0
    for s, (trio, dev) in enumerate(zip(fields, mesh.devices)):
        if len(trio) != n or n < 1:
            raise ValueError(f"shard {s} holds {len(trio)} fields, shard 0 "
                             f"{n}")
        for name, f in zip(_field_names(n), trio):
            if not isinstance(f, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor, got "
                                f"{type(f).__name__}")
            if f.dtype not in FIELD_DTYPES:
                raise TypeError(f"{name} must be float32 or bfloat16, got "
                                f"{f.dtype}")
            if f.dtype != fields[0][0].dtype:
                raise TypeError(f"shard {s} {name} is {f.dtype}, shard 0's "
                                f"fields {fields[0][0].dtype}")
            if f.device != dev:
                raise ValueError(f"shard {s} lies on {f.device}, the mesh "
                                 f"puts it on {dev}")
            if shape is None:
                if f.ndim != 3:
                    raise ValueError(f"{name} must be (X, Y, Z), got rank "
                                     f"{f.ndim}")
                shape = f.shape
            elif f.shape != shape:
                raise ValueError(f"shard {s} has shape {tuple(f.shape)}, "
                                 f"shard 0 {tuple(shape)}")
    return tuple(shape)


def halo_band_exchange_dma(fields, *, mesh, axis: str, depth: int, dim: int,
                           block_index: int = 0,
                           slabs: Optional[BandSlabs] = None, wire=None,
                           checksums: bool = False):
    """Exchange depth-`depth` boundary bands of three fields (u, v, w; on
    CPU shards, any number) along mesh axis `axis`, each shard's bands
    stored from inside a kernel into its
    ring neighbours' halos (K7), and each shard's own planes beside them:
    per shard and field, slot ``block_index % 2`` of `slabs`' extended
    slab (`BandSlabs.extended`) is the field widened by `depth` planes or
    rows on each side along `dim`, what the collective engine builds with
    a concatenation.

    `fields` holds one (u, v, w) of (X, Y, Z) per shard, all float32 or all
    bfloat16 (the kernel moves bytes, so both alike), ordered like
    `mesh.devices`, each contiguous or, to move the bands alone, the slot's
    `BandSlabs.interior` views. Returns, per shard, the reference's
    ``((u_hi, u_lo), (v_hi, v_lo), (w_hi, w_lo))``: `hi` is the band from
    the ring predecessors (global coordinates just below the shard), `lo`
    from the successors, views of the slot's halos, valid until the
    exchange of block ``block_index + 2`` writes that slot again.
    Multi-hop: when `depth` exceeds the local extent each side moves in
    ceil(depth / L) messages (`_band_schedule`), each landing at its
    offset.

    `slabs` (a `BandSlabs` of this mesh, shape, depth and dim) carries the
    buffers, counters and message tables from one block to the next; None
    makes fresh ones. On CUDA shards this launches `csrc/band_exchange.cu`,
    one put per card, and the caller reads `slabs.check()` once the stream
    has run (a spin past its bound sets the error word); on CPU shards it
    runs the plain version, `_band_exchange_plain`, whose `wire` hook the
    CUDA kernel does not take.

    The exchange is the op ``repro_torch::band_exchange``: it takes every
    shard's fields and, as the buffers it writes, the slot's extended
    slabs and the counter words; its table by handle (`BandTable.handle`)
    and the hook by handle (`_WIRES`, -1 for none). The plain version's
    `band_send`s run inside the op, where a recording does not see them,
    so a ledger prices K7's messages from its table (`band_movement`), and
    `checksums=True` declares that the hook sends a checksum word beside
    each band: the ledger reads it, neither implementation does."""
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 (x-planes) or 1 (y-rows), got {dim}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    shape = _check_band_fields(fields, mesh)
    n_fields, dtype = len(fields[0]), fields[0][0].dtype
    mesh.axis_size(axis)
    if slabs is None:
        slabs = BandSlabs(mesh, shape, depth, dim, n_fields=n_fields,
                          dtype=dtype)
    elif not slabs.matches(mesh, shape, depth, dim, n_fields, dtype):
        raise ValueError(f"slabs for shape {slabs.shape}, depth "
                         f"{slabs.depth}, dim {slabs.dim}, {slabs.n_fields} "
                         f"fields of {slabs.dtype} on {slabs.devices}; this "
                         f"exchange is {shape}, {depth}, {dim}, {n_fields} "
                         f"fields of {dtype} on {tuple(mesh.devices)}")
    slot = int(block_index) % 2
    table = slabs.table(axis, slot, fields)
    if fields[0][0].is_cuda:
        if n_fields != 3:
            raise ValueError(
                f"the band exchange kernel moves (u, v, w) on the card, got "
                f"{n_fields} fields: spec-driven steps exchange through the "
                f"collective engine there (the reference's compiled kernel "
                f"is 3-field too)")
        if wire is not None:
            raise ValueError("the band exchange kernel has no wire hook: "
                             "checksums and fault injection ride the plain "
                             "version (CPU shards) or the collective engine")
    hook = -1
    if wire is not None:
        hook = next(_WIRE_HANDLES)
        _WIRES[hook] = wire
    try:
        _OP_K7([f for trio in fields for f in trio],
               [f for trio in slabs.extended(slot) for f in trio],
               slabs.words, table.handle, hook, bool(checksums))
    finally:
        _WIRES.pop(hook, None)
    return list(slabs.bands(slot))


# the plain version's wire hooks by the handle K7's op takes, each held
# for one call of `halo_band_exchange_dma`
_WIRES: dict = {}
_WIRE_HANDLES = itertools.count()


def band_movement(handle: int) -> dict:
    """What one K7 call on table `handle` moves, from its messages:
    ``{"messages": ((sender, bytes), ...), "own": ((shard, bytes), ...),
    "in_place": bool, "extended": shape}``: a band per message, per shard
    its own planes landed in its slab (none where the fields lie there
    already), and the extended shape of the slabs it writes."""
    t = BAND_TABLES[handle]
    sl = t.slabs
    size = math.prod(sl.shape)
    other = size // sl.shape[sl.dim]
    own = 0 if t.in_place else sl.n_fields * size * sl.itemsize
    ext = list(sl.shape)
    ext[sl.dim] += 2 * sl.depth
    return {"messages": tuple((m.sender, m.cnt * other * sl.itemsize)
                              for m in t.msgs),
            "own": tuple((s, own) for s in range(len(sl.devices))),
            "in_place": t.in_place, "extended": tuple(ext)}


def _k7_cpu(fields, regions, words, table, wire, checksums):
    del regions, words, checksums
    t = BAND_TABLES[table]
    n = t.slabs.n_fields
    _band_exchange_plain([tuple(fields[i:i + n])
                          for i in range(0, len(fields), n)],
                         t.slabs, t, _WIRES[wire] if wire >= 0 else None)


def _k7_cuda(fields, regions, words, table, wire, checksums):
    del regions, words, checksums
    if wire >= 0:
        raise ValueError("the band exchange kernel has no wire hook")
    _build.load()
    t = BAND_TABLES[table]
    _band_exchange_cuda(t.slabs, t, tuple(f.data_ptr() for f in fields))


def _k7_fake(fields, regions, words, table, wire, checksums):
    return None


_OP_K7 = L.define(
    "band_exchange",
    "(Tensor[] fields, Tensor(a!)[] regions, Tensor(b!)[] words, int table, "
    "int wire, bool checksums) -> ()",
    kind="band", cpu=_k7_cpu, cuda=_k7_cuda, fake=_k7_fake,
    static=("checksums",))
