"""Domain-level PW advection: the paper's application, end to end.

`AdvectionDomain` owns the (X, Y, Z) wind fields on a device and steps them
with any rung of the kernel ladder: the plain reference (the paper's CPU
baseline), v1 `blocked`, v2 `dataflow`, v3 `wide` and v4 `fused` (T Euler
steps per pass over device memory). The stratus-cloud
initialisation mirrors the paper's MONC case sizes (Fig. 8: 1M .. 268M grid
points at z=64) and produces the same bytes as the reference package's.
A (mesh_nx, mesh_ny) configuration also prices the 2D-decomposed
distributed step (`stencil.distributed`): the per-shard pass, the depth-T
exchange's wire bytes and, through `exchange` / `overlap` / `n_blocks`, how
much of that exchange the engine hides behind the interior pass
(`roofline_terms().collective_exposed_s`). `batch` prices B independent
domains of this shape packed into one mega-launch, the stencil serving
engine's (`serving.stencil_engine`): the flops, bytes and wire accounting
scale by it, and `serving_throughput` prices the packed launch in domains/s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import roofline as R
from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.advection import ops
from repro_torch.kernels.advection import ref as REF

VARIANTS = ("reference", "blocked", "dataflow", "wide", "fused")
DTYPES = ("float32", "bfloat16")

# the paper's experiment grid sizes (Fig. 8), (x, y, z)
PAPER_GRIDS = {
    "1M": (16, 1024, 64),
    "4M": (64, 1024, 64),
    "16M": (256, 1024, 64),   # Fig. 3/5 use 512x512x64 = 16.7M
    "67M": (1024, 1024, 64),
    "268M": (4096, 1024, 64),
}


def stratus_fields(X: int, Y: int, Z: int, seed: int = 0,
                   dtype=torch.float32,
                   device="cuda") -> Tuple[torch.Tensor, ...]:
    """Smooth, divergence-ish wind fields standing in for the stratus case,
    computed in numpy float64 exactly as the reference does, then cast."""
    rng = np.random.default_rng(seed)
    kx = np.linspace(0, 2 * np.pi, X)[:, None, None]
    ky = np.linspace(0, 2 * np.pi, Y)[None, :, None]
    kz = np.linspace(0, np.pi, Z)[None, None, :]
    u = 5.0 * np.sin(kx + 0.5) * np.cos(ky) * np.sin(kz + 0.1)
    v = 4.0 * np.cos(kx) * np.sin(ky + 0.3) * np.sin(kz)
    w = 0.5 * np.sin(kx) * np.sin(ky) * np.cos(kz)
    for f in (u, v, w):
        f += 0.01 * rng.normal(size=f.shape)
    return REF.fields_from_numpy(u, v, w, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class AdvectionDomain:
    """An (X, Y, Z) advection domain on `device` ("cuda" unless the caller
    asks for "cpu"). Frozen: vary it with `dataclasses.replace`.

    With a v1-v3 rung on CUDA and `y_tile=None`, the domain runs the
    reference's tile, the largest y-tile whose 3 x 3-slice slab fits one
    block's shared memory (`advection.largest_fitting_y_tile` at depth 1;
    the largest divisor of Y when it is at least half that size), or
    untiled where the whole-Y slab fits; the kernel's launch plan
    (`advection.rung_launch_plan`) runs a tile taller than its own as equal
    sub-tiles. `fused` passes `y_tile` on as it is, and with None K1 runs
    its own launch plan (`advection.fused_launch_plan`). Tiled and untiled
    results are equal bitwise, so neither changes a result; the byte and
    ring accounting below prices `run_y_tile` with the reference's models.

    `dtype` is "float32" or "bfloat16". A bf16 domain holds its fields and
    its coefficients (`params`) in bf16, as the reference's does, so every
    op of its step is a bf16 op (rounded to bf16) on every rung, the
    kernels' and the plain reference's alike, and its byte models price
    2-byte cells.
    """
    X: int
    Y: int
    Z: int
    variant: str = "dataflow"
    device: str = "cuda"
    dtype: str = "float32"
    fuse_T: int = 4                   # fused (v4): Euler steps per pass
    y_tile: Optional[int] = None      # y-tiles of the on-chip slab
    tiling: str = "grid"              # "grid": in-grid tiles, one launch;
                                      # "host": the retained host tile loop
    fuse_update: bool = False         # v1-v3: fold f + dt*s into the kernel
    dt: float = 1.0
    mesh_nx: int = 1                  # 2D (x, y) mesh shape, for the
    mesh_ny: int = 1                  # per-shard accounting below (step()
                                      # stays single-shard; the mesh runs
                                      # through stencil.distributed)
    exchange: str = "collective"      # halo-band engine and interior /
    overlap: bool = False             # boundary split, for the overlap
                                      # accounting below
    n_blocks: int = 1                 # substep-blocks per pipelined
                                      # make_distributed_run (1 = a step)
    batch: int = 1                    # serving slots: independent domains
                                      # of this shape in one mega-launch;
                                      # accounting only (step() stays one
                                      # domain)

    def __post_init__(self):
        if self.exchange not in ("collective", "remote_dma"):
            raise ValueError(f"exchange must be 'collective' or "
                             f"'remote_dma', got {self.exchange!r}")
        if self.n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {self.n_blocks}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{self.variant!r}")
        if self.dtype not in DTYPES:
            raise NotImplementedError(f"dtype must be one of {DTYPES}, got "
                                      f"{self.dtype!r}")
        K._check_tiling(self.tiling)
        K._check_y_tile(self.y_tile)
        tile = self.y_tile
        if (tile is None and self.variant not in ("reference", "fused")
                and torch.device(self.device).type == "cuda"):
            tile = K.largest_fitting_y_tile(self.substeps_per_step(), self.Y,
                                            self.Z, self.itemsize)
        object.__setattr__(self, "run_y_tile", tile)
        object.__setattr__(self, "params",
                           REF.default_params(self.Z,
                                              dtype=getattr(torch, self.dtype),
                                              device=self.device))

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=getattr(torch, self.dtype)).itemsize

    def init(self, seed: int = 0):
        return stratus_fields(self.X, self.Y, self.Z, seed,
                              getattr(torch, self.dtype), self.device)

    def sources(self, u, v, w):
        if self.variant == "fused":
            raise ValueError("fused advances fields in-kernel; use step()")
        if self.fuse_update:
            raise ValueError("fuse_update advances fields; use step()")
        return ops.pw_advect(u, v, w, self.params, variant=self.variant,
                             y_tile=self.run_y_tile, tiling=self.tiling)

    def step(self, u, v, w, dt: Optional[float] = None):
        """One advection update. `fused` (and the v1-v3 rungs with
        `fuse_update=True`) advance the fields in the kernel with dt baked
        in, so a dt override is rejected there; otherwise the sources come
        from the kernel and the update `f + dt*s` is a separate pass."""
        if self.variant == "fused" or self.fuse_update:
            if dt is not None and dt != self.dt:
                raise ValueError("the fused-update path bakes dt in; set "
                                 "AdvectionDomain(dt=...) instead")
            if self.variant == "fused":
                return ops.pw_advect_fused(u, v, w, self.params,
                                           T=self.fuse_T, dt=self.dt,
                                           y_tile=self.run_y_tile,
                                           tiling=self.tiling)
            return ops.pw_advect(u, v, w, self.params, variant=self.variant,
                                 y_tile=self.run_y_tile, tiling=self.tiling,
                                 fuse_update=True, dt=self.dt)
        dt = self.dt if dt is None else dt
        su, sv, sw = self.sources(u, v, w)
        dt = REF.step_dt(dt, su.dtype)
        return u + dt * su, v + dt * sv, w + dt * sw

    def substeps_per_step(self) -> int:
        """Euler substeps one step() call advances (T for fused, else 1)."""
        return self.fuse_T if self.variant == "fused" else 1

    def advance(self, u, v, w, n_substeps: int):
        """Run `n_substeps` Euler substeps, in chunks of `fuse_T` for the
        fused variant."""
        per = self.substeps_per_step()
        if n_substeps % per:
            raise ValueError(f"n_substeps={n_substeps} not a multiple of "
                             f"fuse_T={per}")
        for _ in range(n_substeps // per):
            u, v, w = self.step(u, v, w)
        return u, v, w

    def flops_per_step(self) -> int:
        cells = (self.X - 2) * (self.Y - 2) * (self.Z - 2)
        return (cells * REF.flops_per_cell() * self.substeps_per_step()
                * self.batch)

    def _model_variant(self) -> str:
        return "pointwise" if self.variant == "reference" else self.variant

    def _hbm_bytes_pass(self, X: int, Y: int) -> int:
        return K.hbm_bytes_model(
            X, Y, self.Z, self.itemsize, self._model_variant(),
            T=self.substeps_per_step(), y_tile=self.run_y_tile,
            grid_tiled=self.tiling == "grid",
            fuse_update=self.variant == "fused" or self.fuse_update)

    def hbm_bytes_per_step(self) -> int:
        """Modelled device-memory bytes per step() call (fused: per T-step
        pass) on the configured path: in-grid or host tiling, and the Euler
        update in the kernel (`fused`, `fuse_update`) or as a separate
        `f + dt*s` pass (always separate for `reference`). A `batch` > 1
        charges every packed slot's pass: slots share nothing."""
        return self._hbm_bytes_pass(self.X, self.Y) * self.batch

    def shard_shape(self) -> Tuple[int, int]:
        """Owned (Xl, Yl) per-shard dims on the (mesh_nx, mesh_ny) mesh."""
        if self.mesh_nx < 1 or self.mesh_ny < 1:
            raise ValueError(f"mesh shape must be >= 1, got "
                             f"({self.mesh_nx}, {self.mesh_ny})")
        if self.X % self.mesh_nx or self.Y % self.mesh_ny:
            raise ValueError(
                f"grid ({self.X}, {self.Y}) not divisible by mesh "
                f"({self.mesh_nx}, {self.mesh_ny}); the mesh requires even "
                "shards")
        return self.X // self.mesh_nx, self.Y // self.mesh_ny

    def hbm_bytes_per_shard_step(self) -> int:
        """Per-shard device-memory bytes per step(): the pass over the
        halo'd (Xl+2T, Yl+2T, Z) slab the distributed step streams."""
        Xl, Yl = self.shard_shape()
        T = self.substeps_per_step()
        return self._hbm_bytes_pass(Xl + (2 * T if self.mesh_nx > 1 else 0),
                                    Yl + (2 * T if self.mesh_ny > 1 else 0)
                                    ) * self.batch

    def halo_wire_bytes_per_step(self) -> int:
        """Per-shard wire bytes of the one depth-T exchange a distributed
        step performs (zero on a 1x1 mesh), per packed batch slot."""
        return R.halo_wire_bytes_model(self.X, self.Y, self.Z, self.itemsize,
                                       nx=self.mesh_nx, ny=self.mesh_ny,
                                       T=self.substeps_per_step()) * self.batch

    def _interior_fraction(self) -> float:
        Xl, Yl = self.shard_shape()
        return R.interior_compute_fraction(Xl, Yl, self.substeps_per_step(),
                                           nx=self.mesh_nx, ny=self.mesh_ny)

    def overlap_efficiency(self) -> float:
        """Modelled fraction of the exchange the configured engine hides
        behind the interior pass (`roofline.overlap_efficiency_model`);
        0.0 on a 1x1 mesh or with overlap=False."""
        if self.mesh_nx * self.mesh_ny == 1:
            return 0.0
        return R.overlap_efficiency_model(
            overlap=self.overlap, exchange=self.exchange,
            interior_fraction=self._interior_fraction())

    def pipeline_efficiency(self) -> float:
        """Per-block hidden fraction over an `n_blocks`-block pipelined run
        (`roofline.pipeline_efficiency_model`); 0.0 on a 1x1 mesh."""
        if self.mesh_nx * self.mesh_ny == 1:
            return 0.0
        return R.pipeline_efficiency_model(
            n_blocks=self.n_blocks, overlap=self.overlap,
            exchange=self.exchange,
            interior_fraction=self._interior_fraction())

    def roofline_terms(self, *, loopback: bool = False) -> R.RooflineTerms:
        """Three-term roofline of one distributed step() on the configured
        mesh: the exchange's wire bytes feed `collective_s` (over NVLink,
        or device memory on a `loopback` mesh whose shards share one card),
        split into hidden and exposed seconds by the engine's overlap
        efficiency (the pipelined per-block one when n_blocks > 1)."""
        n_dev = self.mesh_nx * self.mesh_ny
        eff = (self.pipeline_efficiency() if self.n_blocks > 1
               else self.overlap_efficiency())
        return R.RooflineTerms(
            flops_per_dev=self.flops_per_step() / n_dev,
            hbm_bytes_per_dev=self.hbm_bytes_per_shard_step(),
            wire_bytes=self.halo_wire_bytes_per_step(),
            wire_bw=R.LOOPBACK_BW if loopback else R.NVLINK_BW,
            n_chips=n_dev, overlap_efficiency=eff)

    def vmem_halo_bytes_per_step(self) -> int:
        """Halo re-read bytes served from the on-chip slab by the in-grid
        tiled path (zero for host tiling)."""
        if self.tiling != "grid":
            return 0
        return K.vmem_halo_bytes_model(
            self.X, self.Y, self.Z, self.itemsize, self._model_variant(),
            T=self.substeps_per_step(), y_tile=self.run_y_tile) * self.batch

    def vmem_register_bytes(self) -> int:
        """On-chip ring bytes of the configuration, the reference's model
        at `run_y_tile` (for v1-v3 one block's shared memory on Hopper; K1
        keeps its ring in registers and sizes its shared planes itself,
        `advection.fused_shared_bytes`). `wide`'s slab has the 1-row halo
        of `dataflow`, where the reference sizes its TPU 8-row sublane
        halo. One ring per packed batch slot, as the reference counts it
        (K5 runs the slots as grid blocks, so the card never holds them all;
        `serving_slot_bytes` is what binds the batch)."""
        depth = self.fuse_T if self.variant == "fused" else 1
        return K.fused_register_bytes(depth, self.Y, self.Z, self.itemsize,
                                      y_tile=self.run_y_tile) * self.batch

    def guard_bytes_per_step(self) -> int:
        """Extra device-memory bytes of the finite-guard pass
        (`roofline.guard_bytes_model`)."""
        if self.variant != "fused":
            raise ValueError("the finite guard rides the fused kernel; "
                             f"variant={self.variant!r} has no guard path")
        return R.guard_bytes_model(self.X, self.Y, self.Z, batch=self.batch,
                                   itemsize=self.itemsize)

    def serving_slot_bytes(self) -> int:
        """Device bytes one serving slot of this shape holds during a
        mega-step (`roofline.serving_slot_bytes_model`)."""
        return R.serving_slot_bytes_model(self.X, self.Y, self.Z,
                                          self.itemsize)

    def serving_throughput(self) -> float:
        """Modelled domains/s of serving `batch` copies of this domain per
        mega-launch (`roofline.serving_throughput_model`): the host's fixed
        launch cost amortised over the slots against each slot's pass and
        exposed wire seconds. Strictly rises in `batch` until the slots'
        device buffers or the launch grid's slot axis bind
        (`roofline.serving_max_batch`), where the model refuses."""
        t = self.roofline_terms()
        return R.serving_throughput_model(
            self.batch, hbm_bytes_per_domain=t.hbm_bytes_per_dev / self.batch,
            slot_bytes=self.serving_slot_bytes(),
            exposed_wire_s_per_domain=t.collective_exposed_s / self.batch)
