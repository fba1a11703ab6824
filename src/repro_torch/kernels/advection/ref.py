"""Plain PyTorch oracle for the Piacsek-Williams advection stencil (MONC).

The same discretisation as the JAX reference: depth-1 3D stencil computing
momentum source terms (su, sv, sw) for the wind fields (u, v, w), with
level-dependent z metric terms (tzc1/tzc2). Boundary cells (first/last
index in each dimension) get zero source.

Every function takes fields of shape (..., X, Y, Z): leading dimensions are
independent domains (batch slots), and parameter leaves may carry the same
leading dimensions (per-slot) or none (shared). The arithmetic is written
in the reference's exact operation order, so on one device a kernel that
repeats that order without fused multiply-adds reproduces it bitwise.

The f64 oracle is plain torch float64.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode


class AdvectParams(NamedTuple):
    tcx: torch.Tensor   # () or (B,): 0.25 / dx
    tcy: torch.Tensor   # () or (B,): 0.25 / dy
    tzc1: torch.Tensor  # (Z,) or (B, Z): 0.25 * rdz[k] * rho ratios
    tzc2: torch.Tensor  # (Z,) or (B, Z)


def default_params(Z: int, dx: float = 100.0, dy: float = 100.0,
                   dz: float = 40.0, dtype=torch.float32,
                   device="cuda") -> AdvectParams:
    k = np.arange(Z, dtype=np.float64)
    rdz = 1.0 / (dz * (1.0 + 0.001 * k))       # slightly stretched grid
    tzc1 = 0.25 * rdz * (1.0 - 0.002 * k)
    tzc2 = 0.25 * rdz * (1.0 + 0.002 * k)
    return params_from_numpy(
        AdvectParams(np.float64(0.25 / dx), np.float64(0.25 / dy), tzc1,
                     tzc2), dtype=dtype, device=device)


def params_from_numpy(p, *, dtype=torch.float32,
                      device="cuda") -> AdvectParams:
    """Any object with numpy-convertible `tcx`, `tcy`, `tzc1`, `tzc2`
    (the reference's `AdvectParams` included) -> `AdvectParams` of tensors
    on `device`."""
    return AdvectParams(*(torch.tensor(np.asarray(leaf), dtype=dtype,
                                       device=device)
                          for leaf in (p.tcx, p.tcy, p.tzc1, p.tzc2)))


def fields_from_numpy(*fields, dtype=torch.float32, device="cuda"):
    """Numpy-convertible fields -> contiguous tensors on `device`: the
    three winds (u, v, w), or any spec's fields, such as the tracer's
    (u, v, w, q) and diffusion's (phi,)."""
    return tuple(torch.tensor(np.asarray(f), dtype=dtype, device=device)
                 for f in fields)


def pw_advect_ref(u, v, w, p: AdvectParams):
    """Reference PW advection. u, v, w: (..., X, Y, Z). Returns (su, sv, sw)
    of the same shape: interior computed, boundary zero."""
    X, Y, Z = u.shape[-3:]

    def sh(f, di, dj, dk):
        return f[..., 1 + di:X - 1 + di, 1 + dj:Y - 1 + dj,
                 1 + dk:Z - 1 + dk]

    tcx = p.tcx[..., None, None, None]
    tcy = p.tcy[..., None, None, None]
    tzc1 = p.tzc1[..., None, None, 1:-1]
    tzc2 = p.tzc2[..., None, None, 1:-1]

    def source(f):
        """PW flux form: d(uf)/dx + d(vf)/dy + d(wf)/dz, centred."""
        fx = tcx * (sh(u, -1, 0, 0) * (sh(f, 0, 0, 0) + sh(f, -1, 0, 0))
                    - sh(u, 1, 0, 0) * (sh(f, 0, 0, 0) + sh(f, 1, 0, 0)))
        fy = tcy * (sh(v, 0, -1, 0) * (sh(f, 0, 0, 0) + sh(f, 0, -1, 0))
                    - sh(v, 0, 1, 0) * (sh(f, 0, 0, 0) + sh(f, 0, 1, 0)))
        fz = (tzc1 * sh(w, 0, 0, -1) * (sh(f, 0, 0, 0) + sh(f, 0, 0, -1))
              - tzc2 * sh(w, 0, 0, 1) * (sh(f, 0, 0, 0) + sh(f, 0, 0, 1)))
        return fx + fy + fz

    return tuple(F.pad(source(f), (1, 1, 1, 1, 1, 1)) for f in (u, v, w))


def pw_step_ref(u, v, w, p: AdvectParams, dt: float = 1.0):
    """One explicit-Euler advection step: f <- f + dt * source(f)."""
    su, sv, sw = pw_advect_ref(u, v, w, p)
    return u + dt * su, v + dt * sv, w + dt * sw


def _f64(fields, p: AdvectParams):
    f64 = [torch.as_tensor(np.asarray(f) if not torch.is_tensor(f) else f,
                           dtype=torch.float64) for f in fields]
    p64 = AdvectParams(*(torch.as_tensor(leaf, dtype=torch.float64,
                                         device=f64[0].device)
                         for leaf in p))
    return f64, p64


def pw_advect_ref_f64(u, v, w, p: AdvectParams):
    """f64 oracle (the paper's double-precision ground truth)."""
    f64, p64 = _f64((u, v, w), p)
    return pw_advect_ref(*f64, p64)


def pw_multistep_ref_f64(u, v, w, p: AdvectParams, T: int, dt: float = 1.0):
    """T explicit-Euler steps in f64, the oracle for the fused kernel."""
    (u64, v64, w64), p64 = _f64((u, v, w), p)
    for _ in range(T):
        u64, v64, w64 = pw_step_ref(u64, v64, w64, p64, dt)
    return u64, v64, w64


class _ArithCensus(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.add, torch.ops.aten.sub,
                                   torch.ops.aten.mul):
            self.count += 1
        return func(*args, **(kwargs or {}))


def flops_per_cell() -> int:
    """Add/sub/mul count per interior cell: every such op in
    `pw_advect_ref` acts elementwise on interior views, so the op census
    of one call is the per-cell count."""
    p = default_params(4, device="cpu")
    args = [torch.zeros((4, 4, 4))] * 3
    with _ArithCensus() as census:
        pw_advect_ref(*args, p)
    return census.count
