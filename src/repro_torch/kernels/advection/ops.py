"""Public wrappers for the PW-advection ladder.

`pw_advect(..., variant="reference")` computes the momentum sources (or,
with `fuse_update=True`, one advanced step) with the plain oracle;
`pw_advect_fused` is the v4 temporal-blocking entry point and returns the
advanced fields after `T` fused Euler steps. The v1-v3 rungs (`blocked`,
`dataflow`, `wide`) are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.advection import ref as REF

VARIANTS = ("reference", "blocked", "dataflow", "wide")
UNPORTED_RUNGS = ("blocked", "dataflow", "wide")


def pw_advect(u, v, w, params: REF.AdvectParams, *,
              variant: str = "reference", y_tile: Optional[int] = None,
              tiling: str = "grid", fuse_update: bool = False,
              dt: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """Momentum sources (or advanced fields with `fuse_update=True`) via the
    selected ladder rung."""
    if variant == "fused":
        raise ValueError("fused advances fields, not sources; "
                         "use pw_advect_fused")
    if variant in UNPORTED_RUNGS:
        raise NotImplementedError(
            f"variant {variant!r} (kernels K2/K3) is not ported yet: "
            "ROADMAP Queue 1, Slice B, the next slice of the port")
    if variant != "reference":
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if fuse_update:
        return REF.pw_step_ref(u, v, w, params, dt)
    return REF.pw_advect_ref(u, v, w, params)


def pw_advect_fused(u, v, w, params: REF.AdvectParams, *, T: int = 4,
                    dt: float = 1.0, y_tile: Optional[int] = None,
                    tiling: str = "grid") -> Tuple[torch.Tensor, ...]:
    """Advance (u, v, w) by T fused Euler steps in one pass (v4)."""
    return K.advect_fused(u, v, w, params, T=T, dt=dt, y_tile=y_tile,
                          tiling=tiling)


def traffic_model(shape, itemsize: int, variant: str, *, T: int = 1,
                  y_tile: Optional[int] = None, grid_tiled: bool = True,
                  fuse_update: bool = True) -> int:
    X, Y, Z = shape
    return K.hbm_bytes_model(X, Y, Z, itemsize,
                             "pointwise" if variant == "reference" else variant,
                             T=T, y_tile=y_tile, grid_tiled=grid_tiled,
                             fuse_update=fuse_update)
