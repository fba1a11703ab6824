"""The user-written specs of the spec-shape tests, torch side (the JAX
side, term by term alike, is in `test_torch_spec_shapes.py`): radius 2
(`hyperdiff4`, `tvd_vl`), x-diagonal reads (`smag_cross`), six fields
(`moist6`) and the limiter operations (`tvd_vl`); and three cloud-model
terms on the math functions, powers, floor division and remainder,
comparisons as numbers and a coefficient indexed from its vector's end
(`satadj3`, `sponge_log`, `wrap_phase`); with their parameters at unit
spacings and seeded fields. No JAX here: the card tests import it."""
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
MATH_NAMES = ("satadj3", "sponge_log", "wrap_phase")
FIELDS = {"hyperdiff4": ("phi",), "smag_cross": ("phi",),
          "moist6": ("u", "v", "w", "theta", "qv", "qc"),
          "tvd_vl": ("u", "v", "w", "q"), "satadj3": ("theta", "qv", "qc"),
          "sponge_log": ("u", "v", "w"), "wrap_phase": ("phi",)}
DT = {"hyperdiff4": 0.5, "smag_cross": 0.5, "moist6": 0.05, "tvd_vl": 0.1,
      "satadj3": 0.5, "sponge_log": 0.1, "wrap_phase": 0.5}


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


def satadj3(sh, pv):
    """Diffusion of theta, q_v and q_c (a 7-point star times kd) plus a
    saturation adjustment, theta an anomaly about 285 K: q_sat = 0.622
    e_s(T) / p(z) with Tetens' e_s = 610.78 exp(17.27 (T - 273.15) / (T -
    35.86)) Pa, written in the anomaly, and the condensation rate tau^-1
    max(q_v - q_sat, -q_c), which moves q_v to q_c and heats theta by L/cp;
    [kd, 1/tau, L/cp, p(Z)]."""
    (t,) = pv
    kd, rtau, lcp, p = t[0], t[1], t[2], t[3:][1:-1]

    def diff(f):
        return kd * (sh(f, -1, 0, 0) + sh(f, 1, 0, 0) + sh(f, 0, -1, 0)
                     + sh(f, 0, 1, 0) + sh(f, 0, 0, -1) + sh(f, 0, 0, 1)
                     - 6.0 * sh(f, 0, 0, 0))
    th, qv, qc = sh(0, 0, 0, 0), sh(1, 0, 0, 0), sh(2, 0, 0, 0)
    # T - 273.15 and T - 35.86 at T = 285 + th, kept small for bf16 fields
    qsat = 0.622 * 610.78 * torch.exp(17.27 * (11.85 + th) / (249.14 + th)) \
        / p
    rate = rtau * torch.maximum(qv - qsat, -qc)
    return (diff(0) + lcp * rate, diff(1) - rate, diff(2) + rate)


def sponge_log(sh, pv):
    """Vertical eddy diffusion of (u, v, w) by a mixing-length coefficient
    (kappa z)^2 |du/dz|^1.5 (kappa = 0.4, a generic power), u relaxed to
    the log-law wind u*/kappa log(z / z0) and v, w to rest by a Rayleigh
    sponge r_max tanh(max((z - z_s) / (z_top - z_s), 0)), z_top the last
    height of the vector (`t[-1]`); [u*/kappa, z0, r_max, z_s, z(Z)]."""
    (t,) = pv
    us_k, z0, rmax, zs, z = t[0], t[1], t[2], t[3], t[4:][1:-1]
    ztop = t[-1]
    kz2 = (0.4 * z) ** 2
    target = us_k * torch.log(z / z0)
    rate = rmax * torch.tanh(torch.clamp((z - zs) / (ztop - zs), min=0.0))
    out = []
    for f in range(3):
        c, up, dn = sh(f, 0, 0, 0), sh(f, 0, 0, 1), sh(f, 0, 0, -1)
        k = kz2 * (0.5 * abs(up - dn)) ** 1.5
        rest = target - c if f == 0 else -c
        out.append(k * (up - 2.0 * c + dn) + rate * rest)
    return tuple(out)


def _wrap(d):
    """An angle difference in degrees wrapped into [-180, 180)."""
    return ((d + 180.0) % 360.0) - 180.0


def wrap_phase(sh, pv):
    """Upwind advection of a wind direction phi (degrees, wrapped into
    [-180, 180) with seams where it crosses south) by steady advection
    numbers (cx, cy, cz(z)), each one-sided difference wrapped into [-180,
    180) and picked by the wind's sign (comparisons as numbers), plus a
    veering toward north at kd degrees a unit of time, kd sin(phi), on phi
    wrapped by the source's own floor division, phi - 360 floor((phi + 180)
    / 360); [cx, cy, kd, cz(Z)]."""
    (t,) = pv
    cx, cy, kd, cz = t[0], t[1], t[2], t[3:][1:-1]
    phi = sh(0, 0, 0, 0)

    def upwind(c, lo, hi):
        return c * ((c > 0.0) * _wrap(phi - lo) + (c <= 0.0) * _wrap(hi - phi))
    adv = (upwind(cx, sh(0, -1, 0, 0), sh(0, 1, 0, 0))
           + upwind(cy, sh(0, 0, -1, 0), sh(0, 0, 1, 0))
           + upwind(cz, sh(0, 0, 0, -1), sh(0, 0, 0, 1)))
    own = phi - 360.0 * ((phi + 180.0) // 360.0)
    return (-adv - kd * torch.sin(0.017453292519943295 * own),)


def sqrt_spec():
    def src(sh, pv):
        a = sh(0, 1, 0, 0)
        return (torch.sqrt(abs(a)) / 3.0 + 1.0 / (2.0 + abs(sh(0, 0, 1, 0)))
                + torch.where(a < sh(0, -1, 0, 0), a, -1.5),)
    return TSP.StencilSpec(name="sqrt_div", fields=("a",),
                           offsets={"a": STAR1}, source=src,
                           pack_params=lambda p: ())


SOURCES = {"hyperdiff4": hyperdiff4, "smag_cross": smag_cross,
           "moist6": moist6, "tvd_vl": tvd_vl, "satadj3": satadj3,
           "sponge_log": sponge_log, "wrap_phase": wrap_phase}
OFFSETS = {"hyperdiff4": STAR2, "smag_cross": STAR1 + EDGES,
           "moist6": STAR1, "tvd_vl": STAR2, "satadj3": STAR1,
           "sponge_log": STAR1, "wrap_phase": STAR1}


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
    """The port's spec of one of the seven (or `sqrt_div`)."""
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
    elif name == "satadj3":
        # p(z): 1000 hPa, a scale height of 80 levels
        q = [0.05, 1.0, 2500.0, *(1.0e5 * np.exp(-k / 80.0))]
    elif name == "sponge_log":
        # heights (k + 0.5) / Z of a unit column; z0 = 0.002, the sponge
        # above 0.7
        q = [0.75, 0.002, 0.2, 0.7, *((k + 0.5) / Z)]
    elif name == "wrap_phase":
        q = [0.6, -0.5, 20.0, *(0.4 * np.cos(0.3 * k))]
    else:
        z1 = 0.5 / (1.0 + 0.01 * k)
        return (np.array([-0.25, -0.25, *z1], np.float32),
                np.array([-0.25, -0.25, *(0.9 * z1)], np.float32))
    return np.array(q, np.float32)


def np_fields(name, shape=SHAPE, seed=0):
    """Seeded fields: normal, but tvd_vl's winds at half that; satadj3's
    theta anomaly at 3 K, q_v about 8.6 g/kg (q_sat at 285 K and 1000 hPa)
    and q_c at 0.2 g/kg; wrap_phase's phi a smooth direction field of
    random phases spanning about +-400 degrees, wrapped into [-180, 180)
    (seams where neighbours differ by about 360), plus 0.5 degrees of noise
    (which puts some cells just outside, for the source's own wrap)."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=shape).astype(np.float32)
           for _ in FIELDS[name]]
    if name == "tvd_vl":
        out[:3] = [(0.5 * f).astype(np.float32) for f in out[:3]]
    elif name == "satadj3":
        out = [3.0 * out[0], 8.6e-3 + 1.0e-3 * out[1],
               2.0e-4 * np.abs(out[2])]
    elif name == "wrap_phase":
        X, Y, Z = shape
        x, y, z = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                              indexing="ij")
        ph = rng.uniform(0.0, 2.0 * np.pi, 3)
        smooth = (250.0 * np.sin(2.0 * np.pi * x / 23.0 + ph[0])
                  + 150.0 * np.sin(2.0 * np.pi * y / 31.0 + ph[1])
                  + 40.0 * np.cos(2.0 * np.pi * z / 17.0 + ph[2]))
        out = [(smooth + 180.0) % 360.0 - 180.0 + 0.5 * out[0]]
    return [np.asarray(f, np.float32) for f in out]


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
