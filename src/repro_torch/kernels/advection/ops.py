"""Public wrappers for the PW-advection ladder.

`pw_advect(..., variant=...)` selects the Fig. 3 rung (`reference`, v1
`blocked`, v2 `dataflow`, v3 `wide`) and returns the momentum sources, or
with `fuse_update=True` the fields advanced one Euler step. `y_tile` runs
the in-grid tiling (`tiling="grid"`, one launch) or the retained host tile
loop (`tiling="host"`). `pw_advect_fused` is the v4 temporal-blocking entry
point and returns the advanced fields after `T` fused Euler steps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.advection import ref as REF

# source-computing rungs dispatchable via pw_advect; the v4 `fused` rung
# advances whole steps instead and has its own entry point, pw_advect_fused
VARIANTS = {
    "reference": None,
    "blocked": K.advect_blocked,
    "dataflow": K.advect_dataflow,
    "wide": K.advect_wide,
}


def pw_advect(u, v, w, params: REF.AdvectParams, *,
              variant: str = "dataflow", y_tile: Optional[int] = None,
              tiling: str = "grid", fuse_update: bool = False,
              dt: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """Momentum sources (or advanced fields with `fuse_update=True`) via the
    selected ladder rung."""
    if variant == "fused":
        raise ValueError("fused advances fields, not sources; "
                         "use pw_advect_fused")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")
    if variant == "reference":
        if fuse_update:
            return REF.pw_step_ref(u, v, w, params, dt)
        return REF.pw_advect_ref(u, v, w, params)
    return VARIANTS[variant](u, v, w, params, y_tile=y_tile, tiling=tiling,
                             fuse_update=fuse_update, dt=dt)


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
