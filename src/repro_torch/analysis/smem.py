"""Shared-memory plans: every named buffer a kernel launch or a driver
will hold, summed against the card's budgets before anything launches.
Counterpart of `repro.analysis.vmem`, re-derived for Hopper.

The reference sums the VMEM a config allocates against
`roofline.VMEM_PER_CORE`. On the card the on-chip budget is a block's
dynamic shared memory (`roofline.SMEM_PER_BLOCK`), and several blocks
share an SM (`SMEM_PER_SM`, less `SMEM_RESERVED_PER_BLOCK` the system
keeps for each): a plan that assumes `blocks_per_sm` resident blocks must
fit them all. What the TPU kept in VMEM beside the kernel (the remote-DMA
slabs, the serving rings) lives in device memory on the card, so a plan
also names its device buffers and checks them against
`roofline.HBM_PER_CHIP`. K1 and K6 keep their rings in registers; their
plans name the ring (`fused_register_bytes`, the reference's VMEM model)
beside the shared planes, unchecked: the card's own count of the build's
registers is `kernels.advection.fused_kernel_attrs`.

`SmemPlan.check()` raises `SmemBudgetExceeded`, naming every buffer and
the largest, so an over-budget configuration fails at build time with the
buffer to shrink. The builders take the reference's names and read the
kernels' own planners (`fused_launch_plan`, `spec_launch_plan`,
`rung_launch_plan`, `scan_launch_plan`, K8's `simt_tiles`/`tc_tiles`), so
a plan's shared bytes are the bytes the launch asks for. They take the
card's SM count as an argument (132 on an H100; the linter and the CPU
tests pass it), never the card itself.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import roofline as R
from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.attention import attention as A
from repro_torch.kernels.ssm import ssm as SS

__all__ = [
    "SmemBudgetExceeded", "SmemBuffer", "SmemPlan", "fused_ring_plan",
    "distributed_block_plan", "serving_ring_plan", "plan_max_batch",
    "rung_plan", "attention_plan", "scan_plan", "H100_SMS",
]

H100_SMS = 132     # SMs of an H100 SXM: the planners' default card
SPACES = ("shared", "device", "registers")


class SmemBudgetExceeded(ValueError):
    """A statically planned footprint exceeds a budget of the card. The
    message names every buffer and the largest; the knob to shrink (tile,
    depth, batch, blocks per SM) is one of its sizing inputs."""


@dataclass(frozen=True)
class SmemBuffer:
    """One named allocation: `space` is ``shared`` (one block's dynamic
    shared memory), ``device`` (device memory) or ``registers`` (named,
    not checked); `note` records its sizing inputs."""
    name: str
    nbytes: int
    note: str = ""
    space: str = "shared"

    def __post_init__(self):
        if self.space not in SPACES:
            raise ValueError(f"space must be one of {SPACES}, got "
                             f"{self.space!r}")


@dataclass(frozen=True)
class SmemPlan:
    """Named buffers against a block's shared budget (and `blocks_per_sm`
    resident blocks against an SM's), and device buffers against the
    card's memory."""
    buffers: Tuple[SmemBuffer, ...]
    budget: int = R.SMEM_PER_BLOCK
    blocks_per_sm: int = 1
    device_budget: int = R.HBM_PER_CHIP
    context: str = ""

    def _sum(self, space: str) -> int:
        return sum(b.nbytes for b in self.buffers if b.space == space)

    def total(self) -> int:
        """Shared bytes of one block."""
        return self._sum("shared")

    def device_total(self) -> int:
        return self._sum("device")

    def per_sm(self) -> int:
        """Shared bytes of `blocks_per_sm` resident blocks, the system's
        reserve included."""
        if not self.total():
            return 0
        return self.blocks_per_sm * (self.total()
                                     + R.SMEM_RESERVED_PER_BLOCK)

    def headroom(self) -> int:
        return self.budget - self.total()

    def fits(self) -> bool:
        return (self.total() <= self.budget
                and self.per_sm() <= R.SMEM_PER_SM
                and self.device_total() <= self.device_budget)

    def table(self) -> str:
        lines = [f"  {b.nbytes:>14d} B  {b.space:<9s} {b.name}"
                 + (f"  ({b.note})" if b.note else "")
                 for b in self.buffers]
        lines.append(f"  {self.total():>14d} B  shared    TOTAL a block "
                     f"(budget {self.budget} B; {self.blocks_per_sm} a SM: "
                     f"{self.per_sm()} of {R.SMEM_PER_SM} B)")
        lines.append(f"  {self.device_total():>14d} B  device    TOTAL "
                     f"(budget {self.device_budget} B)")
        return "\n".join(lines)

    def check(self) -> "SmemPlan":
        if self.fits():
            return self
        over = []
        if self.total() > self.budget:
            over.append(f"{self.total()} B of shared memory a block, budget "
                        f"{self.budget} B ({R.SMEM_PER_BLOCK} a block)")
        if self.per_sm() > R.SMEM_PER_SM:
            over.append(f"{self.blocks_per_sm} resident blocks need "
                        f"{self.per_sm()} B of an SM's {R.SMEM_PER_SM} B")
        if self.device_total() > self.device_budget:
            over.append(f"{self.device_total()} B of device memory, budget "
                        f"{self.device_budget} B")
        worst = max(self.buffers, key=lambda b: b.nbytes)
        where = f" [{self.context}]" if self.context else ""
        raise SmemBudgetExceeded(
            f"static shared-memory plan{where} needs "
            + "; ".join(over) + f"; largest buffer: {worst.name!r} at "
            f"{worst.nbytes} B" + (f" ({worst.note})" if worst.note else "")
            + f"\n{self.table()}")


# ---- builders ----------------------------------------------------------

def _ring_buffers(plan: K.FusedPlan, levels: int, *, n_fields: int = 3,
                  n_coef: int = 2, what: str = "K1", n_slots: int = 3):
    """The shared buffers of one ring launch at `levels` ring levels
    (`fused_shared_bytes`' terms), and its register ring."""
    pitch, W, C, S = plan.pitch, plan.W, plan.cells_per_thread, plan.S
    tail = max(-(-W // C) * C + 1 - pitch, 0)
    return (
        SmemBuffer(f"{what} z coefficients", 4 * n_coef * W,
                   f"{n_coef} vectors of a {W}-cell window"),
        SmemBuffer(f"{what} centre planes",
                   4 * 2 * levels * n_fields * S * pitch,
                   f"2 buffers x {levels} levels x {n_fields} fields x {S} "
                   f"rows x pitch {pitch}"),
        SmemBuffer(f"{what} row tail", 4 * tail,
                   f"{tail} floats past the last row's window"),
        SmemBuffer(f"{what} register ring",
                   K.fused_register_bytes(
                       levels, S, W, n_fields=n_fields, n_slots=n_slots,
                       n_levels=levels, halo=levels),
                   f"{n_fields} fields x {n_slots} slots x {levels} levels "
                   f"of a {S} x {W} slab, over the block's threads",
                   space="registers"),
    )


def fused_ring_plan(X: int, Y: int, Z: int, *, T: int, B: int = 1,
                    y_tile: Optional[int] = None, spec=None,
                    n_sm: int = H100_SMS, blocks_per_sm: int = 1,
                    context: str = "") -> SmemPlan:
    """One pass of K1 (or, with `spec`, K6) over (B, X, Y, Z) fields at
    depth T, on its own launch plan (`fused_launch_plan` /
    `spec_launch_plan` on a card of `n_sm` SMs holding `blocks_per_sm` of
    its blocks): the block's shared buffers, whose sum is the plan's
    `shared_bytes`, and its register ring."""
    if spec is None:
        plan = K.fused_launch_plan(X, Y, Z, T, B, n_sm, blocks_per_sm,
                                   y_tile=y_tile)
        bufs = _ring_buffers(plan, T)
    else:
        plan = K.spec_launch_plan(X, Y, Z, spec, T, B, n_sm, blocks_per_sm,
                                  y_tile=y_tile)
        knobs = K.spec_plan_knobs(spec, T)
        levels = spec.stages * T
        bufs = _ring_buffers(plan, levels, n_fields=knobs.n_fields,
                             n_coef=knobs.n_coef, what="K6",
                             n_slots=2 * spec.radius + 1)
    return SmemPlan(bufs, blocks_per_sm=blocks_per_sm, context=context)


def distributed_block_plan(shard_shape: Tuple[int, int, int], *, T: int,
                           local_kernel: str, exchange: str,
                           y_tile: Optional[int] = None, nx: int = 1,
                           ny: int = 1, spec=None, shards_per_card: int = 1,
                           n_sm: int = H100_SMS, blocks_per_sm: int = 1,
                           itemsize: int = 4, context: str = "") -> SmemPlan:
    """One distributed substep-block of a shard: K1's (or K6's, with
    `spec`) block over the halo-extended slab at depth ``spec.halo(T)``
    (T without a spec), when `local_kernel="fused"`; and with
    `exchange="remote_dma"` K7's `ExtendedBuffers` (2 slots x the fields
    of the extended slab, cells of `itemsize` bytes) of the
    `shards_per_card` shards one card holds."""
    Xl, Yl, Z = shard_shape
    depth = spec.halo(T) if spec is not None else T
    n_fields = spec.n_fields if spec is not None else 3
    dx = depth if nx > 1 else 0
    dy = depth if ny > 1 else 0
    ext = (Xl + 2 * dx, Yl + 2 * dy, Z)
    buffers = []
    if local_kernel == "fused" and (spec is None or K.spec_on_card(spec)):
        passes = (K.spec_passes(spec, T) if spec is not None
                  else K.fused_passes(T))
        ring = fused_ring_plan(*ext, T=max(passes), y_tile=y_tile, spec=spec,
                               n_sm=n_sm, blocks_per_sm=blocks_per_sm)
        buffers += [dataclasses.replace(
            b, name=b.name + " (halo-extended shard slab)",
            note=f"slab {ext}, {b.note}") for b in ring.buffers]
    if exchange == "remote_dma" and (dx or dy):
        buffers.append(SmemBuffer(
            "K7 extended buffers (2 slots)",
            shards_per_card * n_fields * 2 * ext[0] * ext[1] * Z * itemsize,
            f"{shards_per_card} shards x {n_fields} fields x 2 slots of "
            f"{ext}", space="device"))
    return SmemPlan(tuple(buffers), blocks_per_sm=blocks_per_sm,
                    context=context)


def serving_ring_plan(X: int, Y: int, Z: int, *, batch: int, T: int,
                      itemsize: int = 4, y_tile: Optional[int] = None,
                      n_sm: int = H100_SMS, blocks_per_sm: int = 1,
                      context: str = "") -> SmemPlan:
    """The serving engine's mega-step: K5's block (K1's plan at B =
    `batch`) and the batch's slot buffers in device memory
    (`roofline.serving_slot_bytes_model` a slot), the buffer class
    `roofline.serving_max_batch` bounds; `plan_max_batch` proves the two
    agree."""
    passes = K.fused_passes(T)
    ring = fused_ring_plan(X, Y, Z, T=max(passes), B=batch, y_tile=y_tile,
                           n_sm=n_sm, blocks_per_sm=blocks_per_sm)
    slot = R.serving_slot_bytes_model(X, Y, Z, itemsize)
    slots = SmemBuffer(f"serving slot buffers (batch={batch})",
                       batch * slot, f"{slot} B a slot of {(X, Y, Z)}",
                       space="device")
    return SmemPlan(ring.buffers + (slots,), blocks_per_sm=blocks_per_sm,
                    context=context)


def plan_max_batch(X: int, Y: int, Z: int, *, itemsize: int = 4,
                   budget: int = R.HBM_PER_CHIP) -> int:
    """Largest batch whose `serving_ring_plan` fits: defined through
    `roofline.serving_max_batch`, so the serving engine's check and this
    pass cannot drift apart."""
    return R.serving_max_batch(R.serving_slot_bytes_model(X, Y, Z, itemsize),
                               device_budget=budget)


def rung_plan(name: str, X: int, Y: int, Z: int, *,
              y_tile: Optional[int] = None, n_sm: int = H100_SMS,
              blocks_per_sm: Optional[int] = None, itemsize: int = 4,
              context: str = "") -> SmemPlan:
    """One launch of a v1-v3 rung (`rung_launch_plan`): 3 fields x the
    kernel's planes of a slab of S x Z cells of `itemsize` bytes (2 for
    bf16: cp.async stages the cells as stored), at the blocks per SM its
    tile aims at (`blocks_per_sm`, else the rung's own)."""
    per_sm = (K._RUNG_KNOBS[name].blocks_per_sm if blocks_per_sm is None
              else blocks_per_sm)
    plan = K.rung_launch_plan(name, X, Y, Z, n_sm, per_sm, y_tile=y_tile,
                              itemsize=itemsize)
    buf = SmemBuffer(f"{name} slabs", plan.shared_bytes,
                     f"3 fields x {plan.planes} planes of {plan.S} x {Z} "
                     f"cells of {itemsize} B")
    return SmemPlan((buf,), blocks_per_sm=min(per_sm, _fits(plan.shared_bytes)),
                    context=context)


def _fits(shared: int) -> int:
    """Blocks of `shared` bytes an SM holds (at least 1)."""
    return max(R.SMEM_PER_SM // (shared + R.SMEM_RESERVED_PER_BLOCK), 1)


def attention_plan(D: int, dtype: torch.dtype, *, block_q: int = 128,
                   block_k: int = 128, context: str = "") -> SmemPlan:
    """One block of K8: the tensor-core kernel's Q tile and ring of K and V
    tiles (bf16, `tc_smem_bytes`), or the SIMT kernel's tiles (f32,
    `smem_bytes` at `simt_tiles`)."""
    if dtype == torch.bfloat16:
        DP, BQ, BK = A.tc_tiles(D)
        bufs = (SmemBuffer("K8 tensor-core tiles", A.tc_smem_bytes(D),
                           f"Q {BQ} x {DP} and {A.TC_STAGES} stages of K, V "
                           f"{BK} x {DP} bf16, barriers, 1024 B of "
                           f"alignment"),)
    else:
        bq, bk = A.simt_tiles(block_q, block_k, D)
        bufs = (SmemBuffer("K8 SIMT tiles", A.smem_bytes(bq, bk, D),
                           f"Q, O {bq} x {D}, K/V chunk, logits {bk} x {bq} "
                           f"f32"),)
    return SmemPlan(bufs, context=context)


def scan_plan(B: int, S: int, D: int, N: int, *, x_itemsize: int = 4,
              dt_itemsize: int = 4, n_sm: int = H100_SMS,
              blocks_per_sm: int = 1, context: str = "") -> SmemPlan:
    """One launch of K9 on its own plan (`scan_launch_plan`): the staged
    tiles of x, dt, B and C (`scan_shared_bytes`)."""
    plan = SS.scan_launch_plan(B, S, D, N, x_itemsize, dt_itemsize, n_sm,
                               blocks_per_sm)
    buf = SmemBuffer("K9 staged tiles", plan.shared_bytes,
                     f"{plan.lanes} lanes x {plan.steps} steps, N={N}")
    return SmemPlan((buf,), blocks_per_sm=min(blocks_per_sm,
                                              _fits(plan.shared_bytes)),
                    context=context)
