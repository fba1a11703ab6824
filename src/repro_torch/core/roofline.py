"""Single-device roofline terms and the stencil byte/FLOP models, for one
NVIDIA H100 SXM.

    compute term = FLOPs / peak FLOP/s
    memory term  = device-memory bytes / memory bandwidth

The hardware constants below come from NVIDIA's H100 SXM data sheet and the
Hopper architecture white paper: data sheet, not measured. Measured times
live in PERF.md beside the card's name and power limit. The collective term
and the mesh, overlap and serving models of the reference wait for the
slices that port those paths.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict

# NVIDIA H100 SXM, data sheet, not measured (dense rates, 700 W part)
PEAK_FLOPS_BF16 = 989e12     # bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12       # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
HBM_PER_CHIP = 80 * 10**9    # 80 GB
SMEM_PER_BLOCK = 232_448     # dynamic shared memory one block may use


@dataclass
class RooflineTerms:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    model_flops_global: float = 0.0
    peak_flops: float = PEAK_FLOPS_F32   # the stencil's f32 arithmetic
    hbm_bw: float = HBM_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_dev / self.hbm_bw

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap model: the bottleneck term defines the step."""
        return max(self.compute_s, self.memory_s)

    @property
    def no_overlap_s(self) -> float:
        return self.compute_s + self.memory_s

    @property
    def useful_flops_ratio(self) -> float:
        if not self.model_flops_global:
            return float("nan")
        return self.model_flops_global / self.flops_per_dev

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline step time."""
        if not self.model_flops_global:
            return float("nan")
        return self.model_flops_global / (self.peak_flops * self.step_time_s)

    @property
    def hw_flops_fraction(self) -> float:
        return self.compute_s / self.step_time_s

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 bound=self.bound, step_time_s=self.step_time_s,
                 mfu=self.mfu, useful_flops_ratio=self.useful_flops_ratio,
                 hw_flops_fraction=self.hw_flops_fraction)
        return d


GUARD_FLAG_ITEMSIZE = 4   # the finite-guard flag output is f32


def guard_bytes_model(X: int, Y: int, Z: int, *, batch: int = 1,
                      itemsize: int = 4, n_fields: int = 3) -> int:
    """Extra device-memory bytes of the finite-guard pass
    (`kernels.advection.finite_guard`): it re-reads ``n_fields * X * Y *
    Z`` field words (3 for the advection ladder, `spec.n_fields` for a
    stencil-spec operator) and writes ``X`` f32 flag words per slot. The
    guard stays a separate launch after the fused kernel, so its price is
    this read pass.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if min(X, Y, Z) < 1:
        raise ValueError(f"extents must be >= 1, got {(X, Y, Z)}")
    if n_fields < 1:
        raise ValueError(f"n_fields must be >= 1, got {n_fields}")
    parts = guard_bytes_model_parts(X, Y, Z, batch=batch,
                                    itemsize=itemsize, n_fields=n_fields)
    return parts["field_reads"] + parts["flag_words"]


def guard_bytes_model_parts(X: int, Y: int, Z: int, *, batch: int = 1,
                            itemsize: int = 4, n_fields: int = 3) -> dict:
    """`guard_bytes_model` split into ``{"field_reads", "flag_words"}``;
    their sum is `guard_bytes_model`."""
    return {"field_reads": batch * n_fields * X * Y * Z * itemsize,
            "flag_words": batch * X * GUARD_FLAG_ITEMSIZE}


def stencil_arithmetic_intensity(flops_per_cell: float,
                                 bytes_per_cell_pass: float,
                                 fusion_T: int = 1,
                                 tiling_bytes_factor: float = 1.0) -> float:
    """FLOP/byte of a temporally fused streaming stencil: one pass moves
    `bytes_per_cell_pass` per cell and does `fusion_T` steps of
    `flops_per_cell` work, so the intensity grows linearly in T."""
    if fusion_T < 1:
        raise ValueError(f"fusion_T must be >= 1, got {fusion_T}")
    if tiling_bytes_factor < 1.0:
        raise ValueError("tiling_bytes_factor must be >= 1.0, got "
                         f"{tiling_bytes_factor}")
    return fusion_T * flops_per_cell / (bytes_per_cell_pass
                                        * tiling_bytes_factor)


def stencil_ridge_T(flops_per_cell: float, bytes_per_cell_pass: float,
                    peak_flops: float = PEAK_FLOPS_F32,
                    hbm_bw: float = HBM_BW,
                    tiling_bytes_factor: float = 1.0) -> int:
    """Smallest fusion depth T at which the fused stencil's intensity
    reaches the card's ridge point (peak FLOP/s over memory bandwidth)."""
    ridge = peak_flops / hbm_bw
    ai1 = stencil_arithmetic_intensity(
        flops_per_cell, bytes_per_cell_pass,
        tiling_bytes_factor=tiling_bytes_factor)
    return max(1, math.ceil(ridge / ai1))
