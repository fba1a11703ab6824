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

Fields and coefficients may be float32 or bfloat16. Each op runs in the
dtype PyTorch's promotion gives its operands, as JAX's promotion gives
the reference's: a bf16 op is computed in f32 and rounded to nearest even,
and a product with an f32 coefficient is an f32 op. The Euler update's dt,
a Python float, is rounded to the sources' dtype first, as JAX rounds a
weakly typed scalar (`step_dt`).

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


def is_bf16_array(a) -> bool:
    """Whether numpy array `a` holds bfloat16 words: an array of the
    `ml_dtypes` type (which the reference's arrays are), or the raw 2-byte
    `<V2` words `np.save` writes for one. The port never imports that
    package; it reads such arrays by their bits."""
    dt = np.asarray(a).dtype
    return dt.name == "bfloat16" or (dt.kind == "V" and dt.itemsize == 2)


def tensor_from_numpy(a, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A numpy-convertible array as a new tensor of `dtype` on `device`. A
    bfloat16 array (`is_bf16_array`) is taken bit for bit, then cast; any
    other is converted by torch, which rounds to nearest even."""
    a = np.asarray(a)
    if is_bf16_array(a):
        t = torch.from_numpy(np.array(a, order="C").view(np.int16))
        return t.view(torch.bfloat16).to(device=device, dtype=dtype)
    return torch.tensor(a, dtype=dtype, device=device)


def params_from_numpy(p, *, dtype=torch.float32,
                      device="cuda") -> AdvectParams:
    """Any object with numpy-convertible `tcx`, `tcy`, `tzc1`, `tzc2`
    (the reference's `AdvectParams` included) -> `AdvectParams` of tensors
    on `device`, in `dtype` (float32, or bfloat16 for a bf16 domain's
    coefficients)."""
    return AdvectParams(*(tensor_from_numpy(leaf, dtype, device)
                          for leaf in (p.tcx, p.tcy, p.tzc1, p.tzc2)))


def fields_from_numpy(*fields, dtype=torch.float32, device="cuda"):
    """Numpy-convertible fields -> contiguous tensors of `dtype` (float32
    or bfloat16) on `device`: the three winds (u, v, w), or any spec's
    fields, such as the tracer's (u, v, w, q) and diffusion's (phi,)."""
    return tuple(tensor_from_numpy(f, dtype, device) for f in fields)


def step_dt(dt: float, dtype: torch.dtype) -> float:
    """`dt` as the Euler update multiplies by it: rounded to bf16 when the
    update is a bf16 op (JAX rounds a weakly typed Python scalar to the
    array's dtype), else as given (an f32 op rounds it to f32 itself)."""
    if dtype == torch.bfloat16:
        return float(torch.tensor(float(dt)).to(torch.bfloat16))
    return dt


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
    dt = step_dt(dt, su.dtype)
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


BF16_UNIT_ROUNDOFF = 2.0 ** -8


def pw_multistep_bf16_bound(u, v, w, p: AdvectParams, T: int,
                            dt: float = 1.0):
    """(oracle, bounds): `pw_multistep_ref_f64` of T unmasked Euler steps
    from bf16 fields, and for each cell a bound on the distance from it of
    a run that rounds as the bf16 contract does (each op to nearest, at
    unit roundoff u = 2^-8 or finer).

    By induction on the steps: where E >= |g - f| cell by cell (g the run,
    f the oracle; E = 0 at the start), one step moves g from f by at most
    - E + dt J, the oracle's step taken from g instead of f: each term
      c * a * (b + d) of the source moves by at most
      c (E_a (|b + d| + E_b + E_d) + |a| (E_b + E_d)), summed into J;
    - u |g'|, the update's rounding, where |g'| <= |f'| + E';
    - dt ((1 + u)^2 g7 + 2u + u^2) A, the source's roundings, the product
      with dt and dt's own rounding to bf16: A sums |c| (|a| + E_a)
      (|b + d| + E_b + E_d) over the source's six terms, none of which
      meets more than seven roundings (six ops, and the cast to bf16 of a
      source with f32 coefficients), and g7 = 7u / (1 - 7u).
    Solving for E' gives (E + dt J + u |f'| + dt (...) A) / (1 - u) in the
    interior; the boundary is never updated, so its bound stays 0. Returns
    the f64 oracle's (u, v, w) and their bounds, f64 tensors."""
    U = BF16_UNIT_ROUNDOFF
    fields, p64 = _f64((u, v, w), p)
    X, Y, Z = fields[0].shape[-3:]

    def sh(f, di=0, dj=0, dk=0):
        return f[..., 1 + di:X - 1 + di, 1 + dj:Y - 1 + dj,
                 1 + dk:Z - 1 + dk]

    cx = p64.tcx.abs()[..., None, None, None]
    cy = p64.tcy.abs()[..., None, None, None]
    # (velocity, coefficient, neighbour) of each term of the source
    terms = ((0, cx, (-1, 0, 0)), (0, cx, (1, 0, 0)),
             (1, cy, (0, -1, 0)), (1, cy, (0, 1, 0)),
             (2, p64.tzc1.abs()[..., None, None, 1:-1], (0, 0, -1)),
             (2, p64.tzc2.abs()[..., None, None, 1:-1], (0, 0, 1)))
    g7 = 7 * U / (1 - 7 * U)
    rounding = dt * ((1 + U) ** 2 * g7 + 2 * U + U * U)
    bounds = [torch.zeros_like(f) for f in fields]
    for _ in range(T):
        stepped = pw_step_ref(*fields, p64, dt)
        grown = []
        for f, e, fn in zip(fields, bounds, stepped):
            A = J = 0.0
            for vi, c, d in terms:
                a, ea = sh(fields[vi], *d).abs(), sh(bounds[vi], *d)
                pair = (sh(f) + sh(f, *d)).abs()
                ep = sh(e) + sh(e, *d)
                A = A + c * (a + ea) * (pair + ep)
                J = J + c * (ea * (pair + ep) + a * ep)
            en = torch.zeros_like(e)
            sh(en).copy_((sh(e) + dt * J + U * sh(fn).abs() + rounding * A)
                         / (1 - U))
            grown.append(en)
        fields, bounds = list(stepped), grown
    return tuple(fields), tuple(bounds)


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
