"""Selective scan on Hopper (K9, Mamba-1): the port of the reference's
Pallas `repro.kernels.ssm.ssm.selective_scan` / `_kernel`.

`selective_scan` dispatches on where its tensors lie. On CUDA tensors it
launches the hand-written kernel `csrc/selective_scan.cu`, a time-parallel
chunk scan: a block takes 16 consecutive d of one batch row and walks the
sequence in tiles of `lanes * steps` steps, `lanes` lanes splitting each
d's tile in time with `steps` consecutive steps each, the lanes' partial
maps h -> P h + Q combined by a warp scan, y summed over n inside each
thread, the next tile's x, dt, B and C copied in while one computes. The
shape of a launch comes from `scan_launch_plan`, a pure function of the
shapes and the card. On CPU tensors it runs `_selective_scan_plain`, the
same recurrence in plain PyTorch. There is no fallback from one to the
other, and `LAUNCHES` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK
from repro_torch.kernels import library as L
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.advection.advection import (_device_index,
                                                     check_launch_grid)

D_TILE = 16                      # d per block of the CUDA kernel
STEP_BUILDS = (1, 2, 4, 8)       # steps a lane owns: the kernel's builds
LANE_CHOICES = (4, 8, 16, 32)    # lanes that split one d's tile in time
STATES = 2                       # states a lane walks at once (the kernel's)
PLAN_LANES = 4                   # the plan's fewest lanes
PLAN_MAX_STEPS = 8               # the plan's steps a lane at long S
MAX_N = 128                      # states per d the kernel takes
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"selective_scan": 0}
LAUNCHED_SHARED = {}    # the shared bytes the last launch asked for


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def max_lanes(steps: int) -> int:
    """The most lanes a build of `steps` launches: its launch bound is
    D_TILE * 32 threads, D_TILE * 16 where steps * STATES >= 8 (its
    registers)."""
    return 16 if steps * STATES >= 8 else 32


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def scan_shared_bytes(lanes: int, steps: int, N: int, x_itemsize: int = 4,
                      dt_itemsize: int = 4) -> int:
    """Shared memory of one block of the CUDA kernel (`layout` in its
    source): two raw stages of one tile (x and dt rows of D_TILE values,
    16 bytes of pad after each lane's rows; B and C), B and C widened to f32
    [n][t], y's [d][t] rows, A log2 e and the carried h (two buffers)."""
    TL = lanes * steps
    TLP = TL + 4
    stage = (_round16(TL * D_TILE * x_itemsize + 16 * lanes)
             + _round16(TL * D_TILE * dt_itemsize + 16 * lanes)
             + 2 * _round16(TL * N * x_itemsize))
    return 2 * stage + 4 * (2 * N * TLP + D_TILE * TLP + 3 * D_TILE * N)


class ScanPlan(NamedTuple):
    """One K9 launch: `lanes` lanes a d, `steps` consecutive steps a lane,
    a tile of `tile` = lanes * steps steps, D_TILE * lanes threads and
    `shared_bytes` of dynamic shared memory a block, `grid` blocks
    (ceil(D / D_TILE), B, 1), and the resident blocks per SM of the
    PLAN_LANES-lane block it was planned with."""
    lanes: int
    steps: int
    tile: int
    threads: int
    shared_bytes: int
    grid: Tuple[int, int, int]
    blocks_per_sm: int


def _plan_block(B: int, S: int, D: int, N: int, x_itemsize: int,
                dt_itemsize: int, lanes: int,
                steps: Optional[int]) -> Tuple[int, int, Tuple]:
    """The card-independent part of a plan: (lanes, steps, grid). Steps
    are `steps` as given, else the fewest of STEP_BUILDS whose tile covers
    S, at most PLAN_MAX_STEPS, fewer while one block's shared memory is over
    SMEM_PER_BLOCK. Raises ValueError naming the limit: N over MAX_N, lanes
    or steps no build takes, shared memory over SMEM_PER_BLOCK, a grid
    beyond CUDA's limits."""
    if not 1 <= N <= MAX_N:
        raise ValueError(f"selective_scan holds at most {MAX_N} states per "
                         f"d (N = {N})")
    if lanes not in LANE_CHOICES:
        raise ValueError(f"K9 takes {LANE_CHOICES} lanes a d; got {lanes}")
    if steps is None:
        fit = [k for k in STEP_BUILDS if k <= PLAN_MAX_STEPS]
        steps = next((k for k in fit if lanes * k >= S), fit[-1])
        while steps > 1 and scan_shared_bytes(
                lanes, steps, N, x_itemsize, dt_itemsize) > SMEM_PER_BLOCK:
            steps //= 2
    if steps not in STEP_BUILDS or lanes > max_lanes(steps):
        raise ValueError(f"K9 is built for {STEP_BUILDS} steps a lane, with "
                         f"at most {max_lanes(steps)} lanes at {steps} "
                         f"steps; got {lanes} lanes of {steps} steps")
    shared = scan_shared_bytes(lanes, steps, N, x_itemsize, dt_itemsize)
    if shared > SMEM_PER_BLOCK:
        raise ValueError(f"K9 at {lanes} lanes of {steps} steps, N = {N}, "
                         f"needs {shared} B of shared memory, over the "
                         f"{SMEM_PER_BLOCK} B one block may use")
    grid = (-(-D // D_TILE), B, 1)
    check_launch_grid(grid, "K9")
    return lanes, steps, grid


@functools.lru_cache(maxsize=256)
def scan_launch_plan(B: int, S: int, D: int, N: int, x_itemsize: int,
                     dt_itemsize: int, n_sm: int, blocks_per_sm: int, *,
                     lanes: Optional[int] = None,
                     steps: Optional[int] = None) -> ScanPlan:
    """One K9 launch over xc (B, S, D), B/C (B, S, N) on a card of `n_sm`
    SMs that holds `blocks_per_sm` blocks of the PLAN_LANES-lane block at
    once.

    Steps: `steps` as given, else the fewest of STEP_BUILDS whose tile
    covers S, at most PLAN_MAX_STEPS: a short prompt takes a short tile.
    Lanes: `lanes` as given, else PLAN_LANES, doubled while the card still
    holds every block at once with twice the lanes (taken as half the
    resident blocks): the SMs' spare warp slots then walk each tile in
    more segments. Where the tile already covers S the doubling halves the
    steps, keeping the tile. Raises ValueError (`_plan_block`) for what no
    build takes."""
    L, K, grid = _plan_block(B, S, D, N, x_itemsize, dt_itemsize,
                             PLAN_LANES if lanes is None else lanes, steps)
    blocks = grid[0] * grid[1]
    while lanes is None and 2 * L in LANE_CHOICES:
        K2 = K // 2 if steps is None and K > 1 and L * K >= S else K
        if (2 * L > max_lanes(K2)
                or blocks * 2 * L > n_sm * blocks_per_sm * PLAN_LANES
                or scan_shared_bytes(2 * L, K2, N, x_itemsize,
                                     dt_itemsize) > SMEM_PER_BLOCK):
            break
        L, K = 2 * L, K2
    return ScanPlan(L, K, L * K, D_TILE * L,
                    scan_shared_bytes(L, K, N, x_itemsize, dt_itemsize),
                    grid, blocks_per_sm)


@functools.lru_cache(maxsize=64)
def _scan_attrs_cached(index: int, x_bf16: bool, dt_bf16: bool, N: int,
                       lanes: int, steps: int,
                       shared: int) -> Tuple[int, int, int, int]:
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        err = lib.selective_scan_attrs(int(x_bf16), int(dt_bf16), N, lanes,
                                       steps, shared, out)
    _build.check(err, "selective_scan_attrs")
    return tuple(out)


def scan_device_plan(device, B: int, S: int, D: int, N: int,
                     x_type: torch.dtype, dt_type: torch.dtype, *,
                     lanes: Optional[int] = None,
                     steps: Optional[int] = None) -> ScanPlan:
    """`scan_launch_plan` on `device`'s card: its SM count and the
    resident blocks per SM the card reports for the block of PLAN_LANES
    lanes (or `lanes`) at the plan's steps. A plan no build takes raises
    ValueError before the kernels are loaded."""
    return _device_plan_cached(_device_index(device), B, S, D, N,
                               x_type.itemsize, dt_type.itemsize, lanes,
                               steps)


@functools.lru_cache(maxsize=256)
def _device_plan_cached(index: int, B: int, S: int, D: int, N: int, xi: int,
                        di: int, lanes: Optional[int],
                        steps: Optional[int]) -> ScanPlan:
    """`scan_device_plan`, planned once per card and shape (a refusal is
    not cached): a serving prompt's launch plans in one lookup."""
    L, K, _ = _plan_block(B, S, D, N, xi, di,
                          PLAN_LANES if lanes is None else lanes, steps)
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    per_sm = _scan_attrs_cached(index, xi == 2, di == 2, N, L, K,
                                scan_shared_bytes(L, K, N, xi, di))[3]
    return scan_launch_plan(B, S, D, N, xi, di, n_sm, per_sm, lanes=lanes,
                            steps=steps)


def scan_kernel_attrs(device, x_type: torch.dtype, dt_type: torch.dtype,
                      N: int, plan: ScanPlan) -> dict:
    """What the card says of the K9 build that runs `plan`: registers and
    local (spill) bytes per thread, the most threads a block of it can
    have, its shared bytes and its resident blocks per SM."""
    regs, local, most, per_sm = _scan_attrs_cached(
        _device_index(device), x_type == torch.bfloat16,
        dt_type == torch.bfloat16, N, plan.lanes, plan.steps,
        plan.shared_bytes)
    return {"registers": regs, "local_bytes": local, "max_threads": most,
            "shared_bytes": plan.shared_bytes, "blocks_per_sm": per_sm}


def hbm_bytes_model(B: int, S: int, D: int, N: int, x_itemsize: int,
                    dt_itemsize: int, h0_itemsize: int = 4) -> int:
    """Device-memory bytes of one K9 call's streams: x, B, C (x's type) and
    dt read once, h0 read once, y and the final state written once in f32.
    A (D, N) is a coefficient table, the ledger's `pallas_control`."""
    return (x_itemsize * (B * S * D + 2 * B * S * N) + dt_itemsize * B * S * D
            + h0_itemsize * B * D * N + 4 * B * S * D + 4 * B * D * N)


def vmem_bytes(chunk: int, D: int, N: int, itemsize: int = 2) -> int:
    """The reference's VMEM working set of one Pallas program: chunk IO +
    (chunk, D, N) scan tensors (its formula, pinned by the tests). The CUDA
    kernel's budget is `scan_shared_bytes`, which does not grow with
    `chunk`."""
    io = (2 * chunk * D + 2 * chunk * N) * itemsize + chunk * D * 4
    scan = 2 * chunk * D * N * 4          # a, bu in f32
    state = D * N * 4
    return 2 * io + scan + state


def _selective_scan_plain(xc, dt, Bmat, Cmat, A, h0):
    """Plain version: the sequential recurrence, in f32. Returns (y (B, S,
    D), h_final (B, D, N))."""
    xc, dt, Bmat, Cmat, A, h = (t.float()
                                for t in (xc, dt, Bmat, Cmat, A, h0))
    y = torch.empty(xc.shape, dtype=torch.float32, device=xc.device)
    for t in range(xc.shape[1]):
        dtv = dt[:, t, :, None]
        a = torch.exp(dtv * A)
        h = a * h + (dtv * xc[:, t, :, None]) * Bmat[:, t, None, :]
        y[:, t] = (h * Cmat[:, t, None, :]).sum(-1)
    return y, h


def _kernel_dtypes(xc, dt, Bmat, Cmat):
    """The types the kernel takes: x, B and C f32 or bf16, all three the
    same (else all promoted to f32), dt f32 or x's type (else f32)."""
    if xc.dtype in DTYPES and Bmat.dtype == Cmat.dtype == xc.dtype:
        x_type = xc.dtype
    else:
        x_type = torch.float32
    dt_type = dt.dtype if dt.dtype in (torch.float32, x_type) else \
        torch.float32
    return x_type, dt_type


def _selective_scan_cuda(xc, dt, Bmat, Cmat, A, h0, plan: ScanPlan):
    """Launch K9 on `plan` over (B, S, D) / (B, S, N) tensors, cast to the
    kernel's types (a plan of other lanes and steps than the wrapper's
    own, from `scan_device_plan`, times or tests them)."""
    lib = _build.load()
    tensors = (xc, dt, Bmat, Cmat, A, h0)
    if not all(t.is_cuda and t.device == xc.device for t in tensors):
        raise ValueError("selective_scan: every input must lie on one CUDA "
                         "device")
    x_type, dt_type = _kernel_dtypes(xc, dt, Bmat, Cmat)
    xc, Bmat, Cmat = (t.to(x_type).contiguous() for t in (xc, Bmat, Cmat))
    dt = dt.to(dt_type).contiguous()
    A, h0 = A.float().contiguous(), h0.float().contiguous()
    B, S, D = xc.shape
    N = Bmat.shape[-1]
    y = torch.empty((B, S, D), dtype=torch.float32, device=xc.device)
    hout = torch.empty((B, D, N), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.selective_scan_fwd(
            int(x_type == torch.bfloat16), int(dt_type == torch.bfloat16),
            xc.data_ptr(), dt.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), hout.data_ptr(),
            B, S, D, N, plan.lanes, plan.steps, plan.shared_bytes, stream)
    _build.check(err, "selective_scan_fwd")
    LAUNCHES["selective_scan"] += 1
    LAUNCHED_SHARED["selective_scan"] = plan.shared_bytes
    return y, hout


def selective_scan(xc, dt, Bmat, Cmat, A, h0, *, chunk: int = 128):
    """xc/dt (B,S,D); Bmat/Cmat (B,S,N); A (D,N); h0 (B,D,N).

    Returns (y (B,S,D) f32, h_final (B,D,N) f32). `chunk` is the
    reference's sequence block: the result does not depend on it, and S
    must be a multiple of it. On CUDA the launch follows
    `scan_device_plan`.

    Raises ValueError, on either device, where the shapes disagree, where
    S is not a multiple of `chunk` (after `min(chunk, S)`, as the reference
    asserts) and where N exceeds MAX_N; on CUDA also where no build takes
    the plan (`scan_launch_plan`). Forward-only: raises RuntimeError, on
    either device, where autograd would need a backward
    (`kernels.refuse_grad`)."""
    refuse_grad("selective_scan (K9)", xc, dt, Bmat, Cmat, A, h0)
    if xc.ndim != 3 or dt.shape != xc.shape or Bmat.ndim != 3 \
            or Cmat.shape != Bmat.shape or Bmat.shape[:2] != xc.shape[:2]:
        raise ValueError(f"selective_scan takes xc, dt (B,S,D) and Bmat, "
                         f"Cmat (B,S,N); got {tuple(xc.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bmat.shape)}, "
                         f"{tuple(Cmat.shape)}")
    B, S, D = xc.shape
    N = Bmat.shape[-1]
    if A.shape != (D, N) or h0.shape != (B, D, N):
        raise ValueError(f"A must be (D, N) = {(D, N)} and h0 (B, D, N) = "
                         f"{(B, D, N)}; got {tuple(A.shape)}, "
                         f"{tuple(h0.shape)}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    if N > MAX_N:
        raise ValueError(f"selective_scan holds at most {MAX_N} states per "
                         f"d (N = {N})")
    y, h = _OP_K9(xc, dt, Bmat, Cmat, A, h0)
    return y, h


def _k9_cuda(xc, dt, Bmat, Cmat, A, h0):
    x_type, dt_type = _kernel_dtypes(xc, dt, Bmat, Cmat)
    B, S, D = xc.shape
    N = Bmat.shape[-1]
    _plan_block(B, S, D, N, x_type.itemsize, dt_type.itemsize, PLAN_LANES,
                None)   # the refusal, before the kernels load
    _build.load()
    plan = scan_device_plan(xc.device, B, S, D, N, x_type, dt_type)
    return _selective_scan_cuda(xc, dt, Bmat, Cmat, A, h0, plan)


def _k9_fake(xc, dt, Bmat, Cmat, A, h0):
    B, S, D = xc.shape
    return (xc.new_empty((B, S, D), dtype=torch.float32),
            xc.new_empty((B, D, Bmat.shape[-1]), dtype=torch.float32))


_OP_K9 = L.define(
    "selective_scan",
    "(Tensor xc, Tensor dt, Tensor Bmat, Tensor Cmat, Tensor A, Tensor h0) "
    "-> (Tensor, Tensor)",
    kind="field", cpu=_selective_scan_plain, cuda=_k9_cuda, fake=_k9_fake)
