"""Stencil-spec frontend: the operator-parameterised temporal-blocking engine.

Counterpart of `repro.stencil.spec`. A `StencilSpec` describes one stencil
operator by what the fused ring needs to know:

  - per-field stencil offsets (the dependence star; `radius` = max |offset|
    component bounds the ring width and the halo growth per substep),
  - a boundary condition (``zero_source``: the outermost `radius` cells
    never receive a source, the wall behaviour of the hand-written ladder),
  - a source-term callback `source(sh, pv)` written against an abstract
    accessor `sh(field_index, dx, dy, dz)`, so the same arithmetic runs on
    3-D tensor views here and, term by term, in the CUDA ring kernel's
    operator functors (`csrc/stencil_ops.cuh`),
  - an integrator (`euler` or midpoint `rk2`, which runs inside the ring:
    two ring levels per substep, so `spec.halo(T) = radius * stages * T` is
    the one depth the ring, the byte models and the tile halo consume).

The Piacsek-Williams spec (`pw_advection_spec`) mirrors `pw_advect_ref`
term by term, operand order included, so the spec kernel with it equals
the hand-written `advect_fused` bitwise on one device.

The f64 oracle `spec_multistep_ref_f64` is plain torch float64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.advection.ref import (AdvectParams, _ArithCensus,
                                               tensor_from_numpy)

INTEGRATORS = ("euler", "rk2")
BOUNDARIES = ("zero_source",)


def _check_offset(field: str, off) -> Tuple[int, int, int]:
    if not (isinstance(off, tuple) and len(off) == 3):
        raise ValueError(
            f"field {field!r}: offset {off!r} must be a 3-tuple of ints")
    for c in off:
        # bools are ints in Python; reject them (an offset of True is a bug)
        if not isinstance(c, int) or isinstance(c, bool):
            raise ValueError(
                f"field {field!r}: offset {off!r} must be a 3-tuple of ints "
                f"(component {c!r} is {type(c).__name__})")
    return off


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """One stencil operator: what the temporal-blocking engine needs to know.

    `source(sh, pv)` returns one interior source slab per field, where
    `sh(fi, dx, dy, dz)` yields field `fi` shifted by the offset (views
    trimmed by `radius` on every axis) and `pv` is `pack_params(params)`: a
    tuple of 1-D vectors broadcast along the last (z) axis only. Offsets are
    declarative metadata validated here; the accessor re-checks that every
    `sh` call stays within the declared radius.
    """
    name: str
    fields: Tuple[str, ...]
    offsets: Mapping[str, Tuple[Tuple[int, int, int], ...]]
    source: Callable
    pack_params: Callable
    boundary: str = "zero_source"
    integrator: str = "euler"

    def __post_init__(self):
        if not self.fields or not isinstance(self.fields, tuple):
            raise ValueError(
                f"fields must be a non-empty tuple of names, "
                f"got {self.fields!r}")
        seen = set()
        for f in self.fields:
            if not isinstance(f, str) or not f:
                raise ValueError(f"field name {f!r} must be a non-empty str")
            if f in seen:
                raise ValueError(f"duplicate field name {f!r}")
            seen.add(f)
        for f in self.fields:
            if f not in self.offsets:
                raise ValueError(f"field {f!r} has no stencil offsets")
        for f in self.offsets:
            if f not in seen:
                raise ValueError(
                    f"offsets name unknown field {f!r} "
                    f"(declared fields: {self.fields})")
        for f, offs in self.offsets.items():
            if not offs:
                raise ValueError(f"field {f!r}: offsets must be non-empty")
            for off in offs:
                _check_offset(f, off)
        if self.boundary not in BOUNDARIES:
            raise ValueError(
                f"boundary must be one of {BOUNDARIES}, "
                f"got {self.boundary!r}")
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {INTEGRATORS}, "
                f"got {self.integrator!r}")
        if not callable(self.source):
            raise ValueError("source must be callable")
        if not callable(self.pack_params):
            raise ValueError("pack_params must be callable")
        if self.radius < 1:
            raise ValueError(
                "spec must have at least one nonzero offset (radius >= 1); "
                "a pointwise operator needs no ring")

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    @property
    def radius(self) -> int:
        """Max |offset component| over every field: the ring half-width."""
        return max(abs(c) for offs in self.offsets.values()
                   for off in offs for c in off)

    @property
    def stages(self) -> int:
        """Ring levels consumed per substep (1 euler, 2 rk2)."""
        return 2 if self.integrator == "rk2" else 1

    def packed_sources(self, fields, pv):
        """`spec_sources` given the packed parameter vectors
        `pv = pack_params(params)`: one (..., X, Y, Z) tensor per field,
        the outermost `radius` cells zero. The callback reads each vector
        as a `CoefVector`, whose coefficients stay dimensioned."""
        fields = tuple(fields)
        if len(fields) != self.n_fields:
            raise ValueError(
                f"spec {self.name!r} has {self.n_fields} fields "
                f"({self.fields}), got {len(fields)} arrays")
        r = self.radius
        X, Y, Z = fields[0].shape[-3:]

        def raw_sh(fi, dx, dy, dz):
            f = fields[fi]
            return f[..., r + dx:X - r + dx, r + dy:Y - r + dy,
                     r + dz:Z - r + dz]

        pv = tuple(CoefVector(p) if torch.is_tensor(p) else p for p in pv)
        srcs = self.source(checked_accessor(self, raw_sh), pv)
        if len(srcs) != self.n_fields:
            raise ValueError(
                f"spec {self.name!r} source returned {len(srcs)} slabs for "
                f"{self.n_fields} fields")
        return tuple(F.pad(s, (r, r, r, r, r, r)) for s in srcs)

    @property
    def cuda_op(self) -> Optional[int]:
        """Id of the `csrc/stencil_ops.cuh` functor that runs this spec in
        the CUDA ring (`CUDA_OPS`), or None for a spec of another callback."""
        return CUDA_OPS.get((self.source, self.pack_params, self.radius,
                             self.integrator))

    def cuda_functor(self):
        """What runs this spec in K6 on the card: a shipped functor's id,
        or the functor `stencil.spec_cuda` generates from the callback (a
        `spec_cuda.Generated`); raises NotImplementedError naming ROADMAP
        Queue 2 for a spec it cannot generate (a transcendental function,
        a power, a Python branch on a traced value: `spec_cuda`)."""
        from repro_torch.stencil import spec_cuda
        return spec_cuda.instantiation(self)

    def halo(self, T: int) -> int:
        """Halo depth of T fused substeps: each ring level advances the
        dependence cone by `radius` and the integrator spends `stages`
        levels per substep, so T substeps need `radius * stages * T` cells,
        the one depth the ring's startup masks, the tile halo and the byte
        models share."""
        if T < 1:
            raise ValueError(f"T must be >= 1, got {T}")
        return self.radius * self.stages * T


class CoefVector:
    """A packed parameter vector as a source callback reads it: an int
    index gives a (1,) tensor, where a tensor's would be 0-d, and a slice a
    `CoefVector`; arithmetic and torch functions see the tensor.

    The reference's coefficients are JAX arrays, whose 0-d elements take
    part in promotion as their dtype: an f32 coefficient times a bf16 field
    is an f32 op there. A 0-d torch tensor does not (torch makes that
    product bf16, rounding the coefficient first on the card and not on the
    CPU), so the callback gets dimensioned coefficients, which make torch
    promote as JAX does, on both devices; with f32 and f64 fields nothing
    changes."""
    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    def __getitem__(self, k):
        out = self.data[k]
        if out.ndim == 0:
            return out.reshape(1)
        return CoefVector(out) if isinstance(k, slice) else out

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getattr__(self, name):
        return getattr(self.data, name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_tensors(args), **dict(zip(kwargs or {}, _tensors(
            (kwargs or {}).values()))))


def _tensors(args):
    return [a.data if isinstance(a, CoefVector) else
            type(a)(_tensors(a)) if isinstance(a, (list, tuple)) else a
            for a in args]


def _coef_op(name: str):
    def op(self, *args):
        return getattr(self.data, name)(*_tensors(args))
    op.__name__ = name
    return op


for _name in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv",
              "rtruediv", "pow", "rpow", "floordiv", "rfloordiv", "mod",
              "rmod", "neg", "pos", "abs", "lt", "le", "gt", "ge", "eq",
              "ne"):
    setattr(CoefVector, f"__{_name}__", _coef_op(f"__{_name}__"))
CoefVector.__hash__ = object.__hash__


def checked_accessor(spec: StencilSpec, raw_sh: Callable) -> Callable:
    """Wrap an `sh` accessor with the spec's declared-radius contract:
    a callback reaching past `spec.radius` on any axis is a spec bug, and
    the error names the field and the offending offset."""
    r = spec.radius

    def sh(fi, dx, dy, dz):
        if max(abs(dx), abs(dy), abs(dz)) > r:
            raise ValueError(
                f"field {spec.fields[fi]!r}: source reads offset "
                f"({dx}, {dy}, {dz}) beyond the declared radius {r}")
        return raw_sh(fi, dx, dy, dz)

    return sh


# ---------------------------------------------------------------------------
# full-array reference (the oracle the kernels are differenced against)
# ---------------------------------------------------------------------------


def spec_sources(fields, params, spec: StencilSpec):
    """Full-array source terms: one (..., X, Y, Z) tensor per field,
    interior computed, outermost `radius` cells zero (the ``zero_source``
    wall). Leading dimensions are independent domains (batch slots)."""
    return spec.packed_sources(fields, spec.pack_params(params))


def spec_step(fields, params, spec: StencilSpec, dt: float = 1.0):
    """One integrator step of the spec: euler `f + dt*S(f)` or midpoint
    rk2 `f + dt*S(f + (dt/2)*S(f))`, sources walled to zero at the
    boundary ring as the fused kernel's masks do."""
    fields = tuple(fields)
    if spec.integrator == "euler":
        srcs = spec_sources(fields, params, spec)
        return tuple(f + dt * s for f, s in zip(fields, srcs))
    half = 0.5 * dt
    g = tuple(f + half * s for f, s in
              zip(fields, spec_sources(fields, params, spec)))
    srcs = spec_sources(g, params, spec)
    return tuple(f + dt * s for f, s in zip(fields, srcs))


def spec_multistep(fields, params, spec: StencilSpec, T: int,
                   dt: float = 1.0):
    fields = tuple(fields)
    for _ in range(T):
        fields = spec_step(fields, params, spec, dt)
    return fields


def spec_multistep_ref_f64(fields, params, spec: StencilSpec, T: int,
                           dt: float = 1.0):
    """T spec steps in float64, the oracle bounding every lower dtype's
    accumulated error. Fields (tensors or numpy arrays) and every leaf of
    the params are cast here, on the fields' device."""
    f64 = tuple(_as_f64(f) for f in fields)
    p64 = type(params)(*(_as_f64(leaf, f64[0].device) for leaf in params))
    return spec_multistep(f64, p64, spec, T, dt)


def _as_f64(t, device=None) -> torch.Tensor:
    if torch.is_tensor(t):
        return t.to(device=device or t.device, dtype=torch.float64)
    return torch.tensor(np.asarray(t, np.float64), device=device)


def spec_flops_per_cell(spec: StencilSpec, params) -> int:
    """Add/sub/mul per interior cell of one source pass, by an op census
    of `spec_sources` on a probe grid (every op acts elementwise on
    interior views, so the census of one call is the per-cell count;
    `params` must be built for the probe Z below, on the CPU)."""
    n = _PROBE_N
    args = [torch.zeros((n, n, n))] * spec.n_fields
    with _ArithCensus() as census:
        spec_sources(args, params, spec)
    return census.count


_PROBE_N = 4  # probe grid edge for spec_flops_per_cell (>= 2*radius + 2)


# ---------------------------------------------------------------------------
# operator specs
# ---------------------------------------------------------------------------

_STAR = ((0, 0, 0), (-1, 0, 0), (1, 0, 0),
         (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def _pw_pack(p: AdvectParams):
    """Pack scalars + z-metrics into (Z+2,) vectors: [tcx, tcy, tzc1] and
    [tcx, tcy, tzc2]."""
    t1 = torch.cat([p.tcx[None], p.tcy[None], p.tzc1])
    t2 = torch.cat([p.tcx[None], p.tcy[None], p.tzc2])
    return (t1, t2)


def _pw_flux_source(sh, pv, n_out: int):
    """PW flux-form sources for fields 0..n_out-1 advected by the velocity
    fields 0/1/2, term by term (operand order included) as `pw_advect_ref`
    writes them. `0.0 + t1[0]` is the reference's; it equals tcx for every
    tcx but -0, and the CUDA functor keeps it too."""
    t1, t2 = pv
    tcx = 0.0 + t1[0]
    tcy = t1[1]
    tzc1 = t1[2:][1:-1]
    tzc2 = t2[2:][1:-1]

    def source(fi):
        fx = tcx * (sh(0, -1, 0, 0) * (sh(fi, 0, 0, 0) + sh(fi, -1, 0, 0))
                    - sh(0, 1, 0, 0) * (sh(fi, 0, 0, 0) + sh(fi, 1, 0, 0)))
        fy = tcy * (sh(1, 0, -1, 0) * (sh(fi, 0, 0, 0) + sh(fi, 0, -1, 0))
                    - sh(1, 0, 1, 0) * (sh(fi, 0, 0, 0) + sh(fi, 0, 1, 0)))
        fz = (tzc1 * sh(2, 0, 0, -1) * (sh(fi, 0, 0, 0) + sh(fi, 0, 0, -1))
              - tzc2 * sh(2, 0, 0, 1) * (sh(fi, 0, 0, 0) + sh(fi, 0, 0, 1)))
        return fx + fy + fz

    return tuple(source(fi) for fi in range(n_out))


def _pw_source(sh, pv):
    return _pw_flux_source(sh, pv, 3)


def _tracer_source(sh, pv):
    return _pw_flux_source(sh, pv, 4)


def pw_advection_spec(integrator: str = "euler") -> StencilSpec:
    """The Piacsek-Williams momentum advection operator, the paper's
    kernel, as a spec. With `integrator="euler"` the spec kernel equals the
    hand-written `advect_fused` bitwise."""
    return StencilSpec(
        name="pw_advection" if integrator == "euler"
        else f"pw_advection_{integrator}",
        fields=("u", "v", "w"),
        offsets={"u": _STAR, "v": _STAR, "w": _STAR},
        source=_pw_source, pack_params=_pw_pack,
        integrator=integrator)


def tracer_advection_spec(integrator: str = "euler") -> StencilSpec:
    """Scalar-tracer advection riding the velocity rings: a fourth field
    `q` advected by (u, v, w) in the same PW flux form, so one pass over
    device memory serves four fields."""
    return StencilSpec(
        name="tracer_advection" if integrator == "euler"
        else f"tracer_advection_{integrator}",
        fields=("u", "v", "w", "q"),
        offsets={"u": _STAR, "v": _STAR, "w": _STAR, "q": _STAR},
        source=_tracer_source, pack_params=_pw_pack,
        integrator=integrator)


class DiffusionParams(NamedTuple):
    kx: torch.Tensor   # scalar: nu / dx^2
    ky: torch.Tensor   # scalar: nu / dy^2
    kz: torch.Tensor   # (Z,): per-level nu / dz(k)^2 (stretched grid)


def default_diffusion_params(Z: int, dx: float = 100.0, dy: float = 100.0,
                             dz: float = 40.0, nu: float = 50.0,
                             dtype=torch.float32,
                             device="cuda") -> DiffusionParams:
    k = np.arange(Z, dtype=np.float64)
    dzk = dz * (1.0 + 0.001 * k)
    return diffusion_params_from_numpy(
        DiffusionParams(np.float64(nu / dx ** 2), np.float64(nu / dy ** 2),
                        nu / dzk ** 2), dtype=dtype, device=device)


def diffusion_params_from_numpy(p, *, dtype=torch.float32,
                                device="cuda") -> DiffusionParams:
    """Any object with numpy-convertible `kx`, `ky`, `kz` (the reference's
    `DiffusionParams` included, bf16 leaves too) -> `DiffusionParams` of
    tensors of `dtype` on `device`."""
    return DiffusionParams(*(tensor_from_numpy(leaf, dtype, device)
                             for leaf in (p.kx, p.ky, p.kz)))


def _diff_pack(p: DiffusionParams):
    return (torch.cat([p.kx[None], p.ky[None], p.kz]),)


def _diff_source(sh, pv):
    (t,) = pv
    kx = t[0]
    ky = t[1]
    kz = t[2:][1:-1]
    c = sh(0, 0, 0, 0)
    lap = (kx * (sh(0, -1, 0, 0) - 2.0 * c + sh(0, 1, 0, 0))
           + ky * (sh(0, 0, -1, 0) - 2.0 * c + sh(0, 0, 1, 0))
           + kz * (sh(0, 0, 0, -1) - 2.0 * c + sh(0, 0, 0, 1)))
    return (lap,)


def diffusion_spec(integrator: str = "euler") -> StencilSpec:
    """3D diffusion (7-point Laplacian, per-level z metric): one field,
    the n_fields=1 end of what the engine spans."""
    return StencilSpec(
        name="diffusion3d" if integrator == "euler"
        else f"diffusion3d_{integrator}",
        fields=("phi",),
        offsets={"phi": _STAR},
        source=_diff_source, pack_params=_diff_pack,
        integrator=integrator)


# (source, pack_params, radius, integrator) of each shipped operator -> the
# id of its functor in csrc/stencil_ops.cuh, the instantiations of the CUDA
# ring (csrc/stencil_fused.cuh) that `StencilSpec.cuda_op` looks up
CUDA_OPS = {
    (source, pack, 1, integrator): op
    for op, (source, pack) in enumerate(
        ((_pw_source, _pw_pack), (_tracer_source, _pw_pack),
         (_diff_source, _diff_pack)))
    for integrator in INTEGRATORS}


# ---------------------------------------------------------------------------
# deterministic initial fields for the new operators (the reference's bytes)
# ---------------------------------------------------------------------------


def tracer_field(X: int, Y: int, Z: int, seed: int = 3,
                 dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Smooth tracer blob + seeded noise (the q companion to
    `stratus_fields`), computed in numpy float64 as the reference does,
    then cast: the same bytes as the reference's."""
    rng = np.random.default_rng(seed)
    kx = np.linspace(0, 2 * np.pi, X)[:, None, None]
    ky = np.linspace(0, 2 * np.pi, Y)[None, :, None]
    kz = np.linspace(0, np.pi, Z)[None, None, :]
    q = 1.0 + 0.5 * np.sin(kx) * np.sin(ky + 0.2) * np.cos(kz)
    q += 0.01 * rng.normal(size=q.shape)
    return torch.tensor(q, dtype=dtype, device=device)


def diffusion_field(X: int, Y: int, Z: int, seed: int = 7,
                    dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Temperature-like initial field for the diffusion operator, the same
    bytes as the reference's."""
    rng = np.random.default_rng(seed)
    kx = np.linspace(0, 2 * np.pi, X)[:, None, None]
    ky = np.linspace(0, 2 * np.pi, Y)[None, :, None]
    kz = np.linspace(0, np.pi, Z)[None, None, :]
    phi = 300.0 + 2.0 * np.cos(kx + 0.1) * np.sin(ky) * np.sin(kz + 0.3)
    phi += 0.01 * rng.normal(size=phi.shape)
    return torch.tensor(phi, dtype=dtype, device=device)
