"""The four user-written specs of the spec-shape tests, torch side (the JAX
side, term by term alike, is in `test_torch_spec_shapes.py`): radius 2
(`hyperdiff4`, `tvd_vl`), x-diagonal reads (`smag_cross`), six fields
(`moist6`) and the limiter operations (`tvd_vl`); with their parameters at
unit spacings and seeded fields. No JAX here: the card tests import it."""
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.stencil import spec as TSP

BF16 = torch.bfloat16
SHAPE = (9, 10, 12)          # X, Y, Z >= 2R + 2 at radius 2
TOL_REL_F32 = 2e-5           # the reference's TOL_REL["float32"]
STORAGES = ((torch.float32, torch.float32), (BF16, torch.float32),
            (BF16, BF16))
STAR1 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
         (0, 0, -1), (0, 0, 1))
STAR2 = STAR1 + ((-2, 0, 0), (2, 0, 0), (0, -2, 0), (0, 2, 0), (0, 0, -2),
                 (0, 0, 2))
EDGES = tuple((a, b, 0) for a in (-1, 1) for b in (-1, 1)) + \
    tuple((a, 0, b) for a in (-1, 1) for b in (-1, 1)) + \
    tuple((0, a, b) for a in (-1, 1) for b in (-1, 1))
NAMES = ("hyperdiff4", "smag_cross", "moist6", "tvd_vl")
FIELDS = {"hyperdiff4": ("phi",), "smag_cross": ("phi",),
          "moist6": ("u", "v", "w", "theta", "qv", "qc"),
          "tvd_vl": ("u", "v", "w", "q")}
DT = {"hyperdiff4": 0.5, "smag_cross": 0.5, "moist6": 0.05, "tvd_vl": 0.1}


# --- the four specs, for torch -----------------------------------------------

def hyperdiff4(sh, pv):
    """-(cx d4x + cy d4y + cz(z) d4z) phi, [cx, cy, cz(Z)]."""
    (t,) = pv
    cx, cy, cz = t[0], t[1], t[2:][2:-2]
    c = sh(0, 0, 0, 0)
    d4x = (sh(0, -2, 0, 0) - 4.0 * sh(0, -1, 0, 0) + 6.0 * c
           - 4.0 * sh(0, 1, 0, 0) + sh(0, 2, 0, 0))
    d4y = (sh(0, 0, -2, 0) - 4.0 * sh(0, 0, -1, 0) + 6.0 * c
           - 4.0 * sh(0, 0, 1, 0) + sh(0, 0, 2, 0))
    d4z = (sh(0, 0, 0, -2) - 4.0 * sh(0, 0, 0, -1) + 6.0 * c
           - 4.0 * sh(0, 0, 0, 1) + sh(0, 0, 0, 2))
    return (-(cx * d4x + cy * d4y + cz * d4z),)


def smag_cross(sh, pv):
    """div(K grad phi) for a symmetric K with cross terms, [kxx, kyy, kxy,
    kxz, kyz, kzz(Z)]: the second differences and the three mixed ones
    (each the four diagonal neighbours of its plane)."""
    (t,) = pv
    kxx, kyy, kxy, kxz, kyz, kzz = t[0], t[1], t[2], t[3], t[4], t[5:][1:-1]
    c = sh(0, 0, 0, 0)
    dxx = sh(0, -1, 0, 0) - 2.0 * c + sh(0, 1, 0, 0)
    dyy = sh(0, 0, -1, 0) - 2.0 * c + sh(0, 0, 1, 0)
    dzz = sh(0, 0, 0, -1) - 2.0 * c + sh(0, 0, 0, 1)
    dxy = (sh(0, 1, 1, 0) - sh(0, 1, -1, 0) - sh(0, -1, 1, 0)
           + sh(0, -1, -1, 0))
    dxz = (sh(0, 1, 0, 1) - sh(0, 1, 0, -1) - sh(0, -1, 0, 1)
           + sh(0, -1, 0, -1))
    dyz = (sh(0, 0, 1, 1) - sh(0, 0, 1, -1) - sh(0, 0, -1, 1)
           + sh(0, 0, -1, -1))
    return (kxx * dxx + kyy * dyy + kzz * dzz
            + 0.5 * (kxy * dxy + kxz * dxz + kyz * dyz),)


def moist6(sh, pv):
    """u, v, w, theta, q_v and q_c advected by (u, v, w) in PW flux form."""
    return TSP._pw_flux_source(sh, pv, 6)


def _vl_ratio(num, den):
    return torch.where(den != 0.0, num / den, 0.0)


def _vl_limiter(r):
    """van Leer's limiter, (r + |r|) / (1 + |r|)."""
    a = abs(r)
    return (r + a) / (1.0 + a)


def _vl_face(qm, q0, q1, q2, vel):
    """The upwind-biased, limited value at the face between q0 and q1,
    kept within [min(q0, q1), max(q0, q1)], times the face's velocity."""
    d = q1 - q0
    pos = q0 + 0.5 * _vl_limiter(_vl_ratio(q0 - qm, d)) * d
    neg = q1 - 0.5 * _vl_limiter(_vl_ratio(q2 - q1, -d)) * d
    face = torch.where(vel >= 0.0, pos, neg)
    face = torch.minimum(torch.maximum(face, torch.minimum(q0, q1)),
                         torch.maximum(q0, q1))
    return vel * face


def tvd_vl(sh, pv):
    """q's flux divergence -(rx dF + ry dG + rz(z) dH), faces on a C grid
    (u at x + 1/2 is u(x)), [rx, ry, rz(Z)]; u, v and w steady."""
    (t,) = pv
    rx, ry, rz = t[0], t[1], t[2:][2:-2]

    def divergence(vel, at):
        q = [sh(3, *at(o)) for o in (-2, -1, 0, 1, 2)]
        up = _vl_face(q[1], q[2], q[3], q[4], sh(vel, *at(0)))
        down = _vl_face(q[0], q[1], q[2], q[3], sh(vel, *at(-1)))
        return up - down

    dq = -(rx * divergence(0, lambda o: (o, 0, 0))
           + ry * divergence(1, lambda o: (0, o, 0))
           + rz * divergence(2, lambda o: (0, 0, o)))
    return (0.0 * sh(0, 0, 0, 0), 0.0 * sh(1, 0, 0, 0),
            0.0 * sh(2, 0, 0, 0), dq)


def sqrt_spec():
    def src(sh, pv):
        a = sh(0, 1, 0, 0)
        return (torch.sqrt(abs(a)) / 3.0 + 1.0 / (2.0 + abs(sh(0, 0, 1, 0)))
                + torch.where(a < sh(0, -1, 0, 0), a, -1.5),)
    return TSP.StencilSpec(name="sqrt_div", fields=("a",),
                           offsets={"a": STAR1}, source=src,
                           pack_params=lambda p: ())


SOURCES = {"hyperdiff4": hyperdiff4, "smag_cross": smag_cross,
           "moist6": moist6, "tvd_vl": tvd_vl}
OFFSETS = {"hyperdiff4": STAR2, "smag_cross": STAR1 + EDGES,
           "moist6": STAR1, "tvd_vl": STAR2}


class OneVector(NamedTuple):
    """The parameters of a one-vector spec (a NamedTuple, as the
    distributed path moves params leaf by leaf)."""
    t: object


class TwoVectors(NamedTuple):
    """moist6's: PW's [tcx, tcy, tzc1(Z)] and [tcx, tcy, tzc2(Z)]."""
    t1: object
    t2: object


def _pack(p):
    return tuple(p)


def port_spec(name, integ="euler"):
    """The port's spec of one of the four (or `sqrt_div`)."""
    if name == "sqrt_div":
        return sqrt_spec()
    fields = FIELDS[name]
    return TSP.StencilSpec(
        name=name if integ == "euler" else f"{name}_{integ}",
        fields=fields, offsets={f: OFFSETS[name] for f in fields},
        source=SOURCES[name], pack_params=_pack, integrator=integ)


def np_params(name, Z):
    """The parameter vectors of one spec as numpy f32, at unit spacings:
    moist6's are PW's [tcx, tcy, tzc1(Z)] and [tcx, tcy, tzc2(Z)]."""
    k = np.arange(Z, dtype=np.float64)
    if name == "hyperdiff4":
        q = [0.012, 0.010, *(0.008 * (1.0 + 0.01 * k))]
    elif name == "smag_cross":
        q = [0.10, 0.08, 0.03, -0.02, 0.025, *(0.06 * (1.0 + 0.01 * k))]
    elif name == "tvd_vl":
        q = [1.0, 1.0, *(1.0 / (1.0 + 0.01 * k))]
    else:
        z1 = 0.5 / (1.0 + 0.01 * k)
        return (np.array([-0.25, -0.25, *z1], np.float32),
                np.array([-0.25, -0.25, *(0.9 * z1)], np.float32))
    return np.array(q, np.float32)


def np_fields(name, shape=SHAPE, seed=0):
    """Seeded fields: normal, but tvd_vl's winds at half that."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=shape).astype(np.float32)
           for _ in FIELDS[name]]
    if name == "tvd_vl":
        out[:3] = [(0.5 * f).astype(np.float32) for f in out[:3]]
    return out


def params(name, Z, dtype=torch.float32, device="cpu"):
    q = np_params(name, Z)
    if isinstance(q, tuple):
        return TwoVectors(*(torch.tensor(a).to(dtype).to(device) for a in q))
    return OneVector(torch.tensor(q).to(dtype).to(device))


def accessor(fields, r):
    X, Y, Z = fields[0].shape

    def sh(fi, dx, dy, dz):
        return fields[fi][r + dx:X - r + dx, r + dy:Y - r + dy,
                          r + dz:Z - r + dz]
    return sh


def bitwise(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
