"""K6 for every spec shape the reference's kernel runs: radius > 1, reads
off the centre row at an x neighbour (x-diagonal), more than four fields,
and the limiter operations (/, abs, sqrt, minimum, maximum, where on
comparisons), driven by four user-written specs, each written once for
torch and once for JAX, term by term alike:

* `hyperdiff4`: fourth-order hyperdiffusion -(cx d4x + cy d4y + cz d4z), a
  13-point star of radius 2 with a z coefficient per level;
* `smag_cross`: anisotropic 3-D diffusion with the xy, xz and yz
  cross-derivative terms, a 19-point stencil with x-diagonal reads;
* `moist6`: PW flux-form advection of u, v, w and three scalars (theta,
  q_v, q_c) by the same winds, six fields;
* `tvd_vl`: van Leer flux-limited upwind advection of one scalar q by
  steady winds (u, v, w) on a C grid, radius 2, its ratio guarded by
  `where(den != 0, num / den, 0)` and each face value clipped to its
  neighbours with minimum and maximum.

Tolerances: the port's plain version against the JAX reference's
`spec_multistep` in f32 within the reference's TOL_REL["float32"] = 2e-5
of the field scale (tests/test_torch_spec.py's rule), the fields moving by
more than 5x that, so a no-op fails; in bf16 against the reference ring's
bf16 masked loop (`test_torch_stencil_bf16.jax_bf16_loop`) bitwise, as
that file holds the shipped specs, with each product of a bf16 value and
a number bf16 does not hold written in the JAX twin as torch computes it
(`by_number`), and a ring whose sources round once shown to fail it.
The traced graph against the callback, and everything within the port:
bitwise. The generated functor compiles
and runs only on the card (`chip_smoke.py` phases 44-46 and
`tests/test_torch_cuda.py`); the torch side of the four specs is
`tests/_spec_shapes.py`."""
import hashlib
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _spec_shapes import (BF16, DT, MATH_NAMES, NAMES, SHAPE, STAR1,
                          STORAGES, TOL_REL_F32, OneVector, TwoVectors,
                          accessor,
                          bitwise, np_fields, np_params, params, port_spec,
                          sqrt_spec)
from _subproc import run_ok
from repro.stencil import spec as JSP
from repro_torch import _build
from repro_torch.analysis import smem as SM
from repro_torch.kernels.advection import advection as TK
from repro_torch.stencil import spec as TSP
from repro_torch.stencil import spec_cuda as G

# --- the same four, for JAX -------------------------------------------------

def hyperdiff4_jax(sh, pv):
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


def smag_cross_jax(sh, pv):
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


def moist6_jax(sh, pv):
    return JSP._pw_flux_source(sh, pv, 6)


def _vl_face_jax(qm, q0, q1, q2, vel):
    def ratio(num, den):
        return jnp.where(den != 0.0, num / den, 0.0)

    def limiter(r):
        a = abs(r)
        return (r + a) / (1.0 + a)

    d = q1 - q0
    pos = q0 + 0.5 * limiter(ratio(q0 - qm, d)) * d
    neg = q1 - 0.5 * limiter(ratio(q2 - q1, -d)) * d
    face = jnp.where(vel >= 0.0, pos, neg)
    face = jnp.minimum(jnp.maximum(face, jnp.minimum(q0, q1)),
                       jnp.maximum(q0, q1))
    return vel * face


def tvd_vl_jax(sh, pv):
    (t,) = pv
    rx, ry, rz = t[0], t[1], t[2:][2:-2]

    def divergence(vel, at):
        q = [sh(3, *at(o)) for o in (-2, -1, 0, 1, 2)]
        up = _vl_face_jax(q[1], q[2], q[3], q[4], sh(vel, *at(0)))
        down = _vl_face_jax(q[0], q[1], q[2], q[3], sh(vel, *at(-1)))
        return up - down

    dq = -(rx * divergence(0, lambda o: (o, 0, 0))
           + ry * divergence(1, lambda o: (0, o, 0))
           + rz * divergence(2, lambda o: (0, 0, o)))
    return (0.0 * sh(0, 0, 0, 0), 0.0 * sh(1, 0, 0, 0),
            0.0 * sh(2, 0, 0, 0), dq)


def by_number(c, x):
    """The Python number c times x, as torch's CPU kernel computes it for a
    bf16 x: in f32, c an f32, the product rounded once to x's dtype. JAX
    rounds a weak-typed number to the array's dtype first (17.27 -> 17.25 in
    bf16); for an f32 x the two rules are one. (Torch's CPU kernels of a
    bf16 sum with a number round the number to bf16 first, as JAX does.)
    The three specs below multiply by numbers that bf16 does not hold; the
    four above only by numbers it does (2, 4, 6, 0.5)."""
    return (jnp.float32(c) * x.astype(jnp.float32)).astype(x.dtype)


def satadj3_jax(sh, pv):
    (t,) = pv
    kd, rtau, lcp, p = t[0], t[1], t[2], t[3:][1:-1]

    def diff(f):
        return kd * (sh(f, -1, 0, 0) + sh(f, 1, 0, 0) + sh(f, 0, -1, 0)
                     + sh(f, 0, 1, 0) + sh(f, 0, 0, -1) + sh(f, 0, 0, 1)
                     - 6.0 * sh(f, 0, 0, 0))
    th, qv, qc = sh(0, 0, 0, 0), sh(1, 0, 0, 0), sh(2, 0, 0, 0)
    qsat = by_number(0.622 * 610.78, jnp.exp(
        by_number(17.27, 11.85 + th) / (249.14 + th))) / p
    rate = rtau * jnp.maximum(qv - qsat, -qc)
    return (diff(0) + lcp * rate, diff(1) - rate, diff(2) + rate)


def sponge_log_jax(sh, pv):
    (t,) = pv
    us_k, z0, rmax, zs, z = t[0], t[1], t[2], t[3], t[4:][1:-1]
    ztop = t[-1]
    kz2 = by_number(0.4, z) ** 2
    target = us_k * jnp.log(z / z0)
    rate = rmax * jnp.tanh(jnp.clip((z - zs) / (ztop - zs), min=0.0))
    out = []
    for f in range(3):
        c, up, dn = sh(f, 0, 0, 0), sh(f, 0, 0, 1), sh(f, 0, 0, -1)
        k = kz2 * (0.5 * abs(up - dn)) ** 1.5
        rest = target - c if f == 0 else -c
        out.append(k * (up - 2.0 * c + dn) + rate * rest)
    return tuple(out)


def _wrap_jax(d):
    return ((d + 180.0) % 360.0) - 180.0


def wrap_phase_jax(sh, pv):
    (t,) = pv
    cx, cy, kd, cz = t[0], t[1], t[2], t[3:][1:-1]
    phi = sh(0, 0, 0, 0)

    def upwind(c, lo, hi):
        return c * ((c > 0.0) * _wrap_jax(phi - lo)
                    + (c <= 0.0) * _wrap_jax(hi - phi))
    adv = (upwind(cx, sh(0, -1, 0, 0), sh(0, 1, 0, 0))
           + upwind(cy, sh(0, 0, -1, 0), sh(0, 0, 1, 0))
           + upwind(cz, sh(0, 0, 0, -1), sh(0, 0, 0, 1)))
    own = phi - 360.0 * ((phi + 180.0) // 360.0)
    return (-adv - kd * jnp.sin(by_number(0.017453292519943295, own)),)


JAX_SOURCES = {"hyperdiff4": hyperdiff4_jax, "smag_cross": smag_cross_jax,
               "moist6": moist6_jax, "tvd_vl": tvd_vl_jax,
               "satadj3": satadj3_jax, "sponge_log": sponge_log_jax,
               "wrap_phase": wrap_phase_jax}


def specs(name, integ="euler"):
    """(port spec, reference spec) of one of the seven."""
    port = port_spec(name, integ)
    return port, JSP.StencilSpec(
        name=port.name, fields=port.fields, offsets=port.offsets,
        source=JAX_SOURCES[name], pack_params=port.pack_params,
        integrator=integ)


def jparams(name, Z, dtype=jnp.float32):
    q = np_params(name, Z)
    if isinstance(q, tuple):
        return TwoVectors(*(jnp.asarray(a, dtype) for a in q))
    return OneVector(jnp.asarray(q, dtype))


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def as_np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# --- the tracer --------------------------------------------------------------

def test_the_four_specs_trace_to_their_ring_shapes():
    """radius, x offsets read off the centre row, fields, and what follows:
    the lag, the plane slots and the builds (none a shipped one's)."""
    want = {"hyperdiff4": (2, 0, 0, 1, 2, 2),
            "smag_cross": (1, -1, 1, 1, 2, 4),
            "moist6": (1, 0, 0, 6, 1, 2),
            "tvd_vl": (2, 0, 0, 4, 2, 2)}
    for name, (r, lo, hi, nf, lag, slots) in want.items():
        gen = specs(name)[0].cuda_functor()
        assert isinstance(gen, G.Generated)
        assert (gen.radius, gen.plane_lo, gen.plane_hi, gen.n_fields,
                gen.lag, gen.slots) == (r, lo, hi, nf, lag, slots)
        assert gen.like is None and gen.head == 0 and gen.pad == r
        assert TK.spec_on_card(specs(name)[0])


@pytest.mark.parametrize("name", NAMES + MATH_NAMES)
@pytest.mark.parametrize("integ", ["euler", "rk2"])
@pytest.mark.parametrize("storage", range(3))
def test_graph_replayed_equals_the_callback(name, integ, storage):
    """The traced graph run op by op in torch (`spec_cuda.evaluate`) ==
    the callback, bitwise, in each storage build's dtypes."""
    spec = specs(name, integ)[0]
    fd, cd = STORAGES[storage]
    X, Y, Z = SHAPE
    fields = [torch.tensor(f).to(fd) for f in np_fields(name, seed=storage)]
    pv = TK._spec_param_vectors(spec, params(name, Z, cd), "cpu", fd)
    wrapped = tuple(TSP.CoefVector(p) for p in pv)
    gen = G.trace(spec)
    sh = accessor(fields, spec.radius)
    got = G.evaluate(gen, sh, wrapped)
    want = spec.source(sh, wrapped)
    assert bitwise(got, want)
    r = spec.radius
    assert all(g.shape == (X - 2 * r, Y - 2 * r, Z - 2 * r) for g in got)


# the digest of each spec's generated text (euler and rk2 trace alike),
# pinned: a change to the tracer or the emitter that changes what the
# kernel computes changes these
DIGESTS = {"hyperdiff4": "f9f3663de3f817a5", "smag_cross": "5ae39cea87eb8d0d",
           "moist6": "527f190ca06d0e95", "tvd_vl": "a1bfd85d0941c2cb",
           "satadj3": "bc23f335cfa5e1be", "sponge_log": "18569ed29a9ebbcd",
           "wrap_phase": "9271f3aa7dbb548d"}


@pytest.mark.parametrize("name", NAMES + MATH_NAMES)
def test_generated_text_against_its_pinned_digest(name):
    gen = specs(name)[0].cuda_functor()
    assert gen.digest == DIGESTS[name], gen.digest
    assert gen.digest == hashlib.sha256(gen.text.encode()).hexdigest()[:16]
    assert specs(name, "rk2")[0].cuda_functor().text == gen.text


def test_the_text_holds_each_new_operation():
    tvd = specs("tvd_vl")[0].cuda_functor().text
    for part in ("static constexpr int kRadius = 2, kPlaneLo = 0, "
                 "kPlaneHi = 0, kHead = 0;", "fabsf(", " / t",
                 "fminf(", "fmaxf(", "const bool t", " != rpk<RF>(0x0.0p+0f))",
                 " >= rpk<RF>(0x0.0p+0f))", "? t", "at<3, 0, 0, -2>(sh)"):
        assert part in tvd, part
    # a NaN operand propagates as torch's minimum does
    assert "(t4 != t4 ? t4 : t5 != t5 ? t5 : fminf(t4, t5))" in tvd
    smag = specs("smag_cross")[0].cuda_functor().text
    assert "kPlaneLo = -1, kPlaneHi = 1" in smag
    assert "at<0, 1, 1, 0>(sh)" in smag and "at<0, -1, 0, -1>(sh)" in smag
    hd = specs("hyperdiff4")[0].cuda_functor()
    # z coefficient at interior z: element start + z - R of a vector padded
    # by R zeros a side, so zoff = start
    assert hd.zslots == ((0, 4, 2),) and "return 4;" in hd.text
    assert "pv[0 * (size_t)p_len + 2]" in hd.text
    assert specs("moist6")[0].cuda_functor().text.count("constexpr (FI ==") \
        == 6


@pytest.mark.parametrize("storage", range(3))
def test_sqrt_and_division_by_a_number(storage):
    """torch.sqrt, a division by a Python number (emitted as torch's card
    kernel runs it, a product with the f32 reciprocal) and a number divided
    by a node; the graph replays the callback bitwise."""
    spec = sqrt_spec()
    gen = spec.cuda_functor()
    assert "sqrtf(" in gen.text
    assert f"* {float(np.float32(1) / np.float32(3)).hex()}f" in gen.text
    assert "0x1.0000000000000p+1f + " in gen.text
    fd = STORAGES[storage][0]
    f = torch.tensor(np_fields("smag_cross", seed=3)[0]).to(fd)
    sh = accessor([f], 1)
    assert bitwise(G.evaluate(gen, sh, ()), spec.source(sh, ()))


# --- refusals that remain ----------------------------------------------------

def _one(src):
    return TSP.StencilSpec(name="r", fields=("a",), offsets={"a": STAR1},
                           source=src, pack_params=lambda p: ())


def _branch(sh, pv):
    a = sh(0, 1, 0, 0)
    if a > sh(0, 0, 0, 0):
        return (a,)
    return (sh(0, 0, 0, 0),)


REFUSED = {
    "a Python branch": (_branch, "a Python branch on a traced value"),
    "where on a value": (
        lambda sh, pv: (torch.where(sh(0, 1, 0, 0), sh(0, 0, 0, 0), 0.0),),
        "not a comparison"),
}


@pytest.mark.parametrize("case_name", sorted(REFUSED))
def test_remaining_refusals_name_the_queue_and_launch_nothing(case_name,
                                                              monkeypatch):
    """Each still raises NotImplementedError naming ROADMAP Queue 2 and
    why, before any build or launch (the loaders monkeypatched to raise):
    a Python branch on a traced value (JAX's trace refuses it too) and
    `where` on a condition that is not a comparison (torch refuses it for
    a float tensor)."""
    def refuse(*args, **kwargs):
        raise RuntimeError("kernel loader unavailable")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "load_generated", refuse)
    src, why = REFUSED[case_name]
    spec = _one(src)
    before = dict(TK.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2") as e:
        TK._cuda_instantiation(spec)
    assert why in str(e.value)
    fields = [torch.zeros(1, 6, 6, 6)]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        TK._stencil_fused_cuda(fields, (), spec, 1, 0.01, torch.ones(6),
                               torch.ones(6))
    assert not TK.spec_on_card(spec)
    assert TK.LAUNCHES == before


# refused until the math nodes came: each now traces to a generated functor
FORMERLY_REFUSED = {
    "torch.exp": lambda sh, pv: (torch.exp(sh(0, 1, 0, 0)),),
    "torch.log": lambda sh, pv: (torch.log(sh(0, 1, 0, 0)),),
    "torch.tanh": lambda sh, pv: (torch.tanh(sh(0, 1, 0, 0)),),
    "a power": lambda sh, pv: (sh(0, 1, 0, 0) ** 0.5,),
    "a comparison as a number": (
        lambda sh, pv: ((sh(0, 1, 0, 0) > 0.0) * sh(0, 0, 0, 0),)),
    "floor division": lambda sh, pv: (sh(0, 1, 0, 0) // 2.0,),
}


@pytest.mark.parametrize("case_name", sorted(FORMERLY_REFUSED))
def test_formerly_refused_callbacks_now_trace(case_name, monkeypatch):
    """Each gets a generated functor and runs on the card (`spec_on_card`),
    deciding so without a build or a launch; its graph replays the
    callback bitwise in every storage."""
    def refuse(*args, **kwargs):
        raise RuntimeError("kernel loader unavailable")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "load_generated", refuse)
    spec = _one(FORMERLY_REFUSED[case_name])
    before = dict(TK.LAUNCHES)
    op, stages = TK._cuda_instantiation(spec)
    assert isinstance(op, G.Generated) and TK.spec_on_card(spec)
    TK.spec_launch_plan(16, 16, 8, spec, 1, 1, 132, 1)
    for fd, _ in STORAGES:
        # positive fields: log and the square root of a negative are NaN
        f = torch.tensor(np.abs(np_fields("smag_cross", seed=2)[0])
                         + 0.25).to(fd)
        sh = accessor([f], 1)
        assert bitwise(G.evaluate(op, sh, ()), spec.source(sh, ()))
    assert TK.LAUNCHES == before


# --- each new node ------------------------------------------------------------

def node_operands(dtype):
    """Two operands over signs, zeros, integers, halves and wide
    magnitudes (the probe's own inputs are every bit pattern, on the
    card)."""
    rng = np.random.default_rng(38)
    a = np.concatenate([rng.normal(size=200) * 10.0 ** rng.integers(
        -3, 4, 200), [0.0, -0.0, 1.0, -1.0, 0.5, 2.0, 3.0, -2.5, 180.0,
                      -180.0, 360.0, 720.0, 7.5, -7.5]])
    b = np.roll(a, 7)
    return (torch.tensor(a, dtype=torch.float32).to(dtype),
            torch.tensor(b, dtype=torch.float32).to(dtype))


def bits_or_nan(a, b) -> bool:
    nan = torch.isnan(a) & torch.isnan(b)
    return a.dtype == b.dtype and bool(torch.all(nan | (a == b) & (
        torch.signbit(a) == torch.signbit(b))))


@pytest.mark.parametrize("case", range(len(G.probe_cases())),
                         ids=[c[0] for c in G.probe_cases()])
@pytest.mark.parametrize("storage", range(3))
def test_each_node_replays_its_callback(case, storage):
    """Each new node in a one-line spec (the cases `chip_smoke.py` phase
    54 probes on the card): its graph replayed by `evaluate` == the
    callback, bitwise (NaN for NaN), in each storage's field dtype."""
    _, arity, fn = G.probe_cases()[case]
    gen = G.probe_functor(case)
    a, b = node_operands(STORAGES[storage][0])

    def sh(f, dx, dy, dz):
        return (a, b)[f]
    got, want = G.evaluate(gen, sh, ())[0], fn(sh, ())[0]
    assert bits_or_nan(got, want)
    # the op model counts each node one operation: a comparison and its
    # product, two; three comparisons, ~, &, | and the select, seven
    want_ops = {"(a > b) * a": 2,
                "where((a > 0) & ~(b < 0) | (a == b), a, b)": 7}
    assert gen.ops_per_cell() == want_ops.get(G.probe_cases()[case][0], 1)


# (function form, method or keyword form): one text
FORMS = {
    "exp": (torch.exp, lambda a: a.exp()),
    "clamp(min=)": (lambda a: torch.clamp(a, min=0.0),
                    lambda a: a.clamp(min=0.0)),
    "clamp(max=) by keyword": (lambda a: torch.clamp(a, None, 0.5),
                               lambda a: torch.clamp(input=a, max=0.5)),
    "clamp_min": (lambda a: torch.clamp_min(a, 0.0),
                  lambda a: a.clamp_min(0.0)),
    "pow": (lambda a: a ** 2, lambda a: a.pow(2)),
    "pow(exponent=)": (lambda a: a ** 1.5,
                       lambda a: torch.pow(a, exponent=1.5)),
    "square": (torch.square, lambda a: a.square()),
    "remainder": (lambda a: a % 3.0, lambda a: a.remainder(3.0)),
    "floor_divide": (lambda a: a // 3.0, lambda a: a.floor_divide(3.0)),
    "sigmoid": (torch.sigmoid, lambda a: a.sigmoid()),
    "maximum": (lambda a: torch.maximum(a, -a), lambda a: a.maximum(-a)),
    "where": (lambda a: torch.where(a > 0.0, a, -a),
              lambda a: a.where(a > 0.0, -a)),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_method_and_keyword_forms_trace_alike(form):
    fn, method = FORMS[form]
    texts = [_one(lambda sh, pv, f=f: (f(sh(0, 1, 0, 0)),)).cuda_functor()
             .text for f in (fn, method)]
    assert texts[0] == texts[1]


# --- the three cloud-model specs ------------------------------------------------

def test_the_math_specs_trace_and_one_build_serves_every_z():
    """satadj3, sponge_log and wrap_phase trace to generated functors of
    PW's and diffusion's rings (radius 1, no x-diagonal read); sponge_log's
    `t[-1]` is a coefficient the launch copies into a row of its own after
    the vector (`rows`), read at a fixed place, so the text is one for
    every Z; the launch's checks take every Z whose slices line up."""
    for name, like in (("satadj3", 0), ("sponge_log", 0),
                       ("wrap_phase", 2)):
        gen = specs(name)[0].cuda_functor()
        assert isinstance(gen, G.Generated) and gen.like == like
        assert TK.spec_on_card(specs(name)[0])
    gen = specs("sponge_log")[0].cuda_functor()
    assert gen.resolved == ((0, -1, 0, (-1,)),) and gen.used == 1
    assert "pv[1 * (size_t)p_len + 1]" in gen.text
    for Z in (6, 12, 64):
        pv = TK._spec_param_vectors(specs("sponge_log")[0],
                                    params("sponge_log", Z), "cpu")
        gen.check_vectors("sponge_log", pv, Z)
        rows = gen.rows(pv)
        assert len(rows) == 2 and torch.equal(rows[1], pv[0][-1:])
        table, p_len = TK._param_block(rows, "cpu", gen.pad)
        assert table[p_len + gen.pad] == pv[0][-1]
        assert specs("sponge_log")[0].cuda_functor().text == gen.text


def test_a_positive_stop_lines_up_at_one_z():
    """A z slice with a positive stop (`t[1:13]`) traces; the launch takes
    it at the Z where it holds the Z - 2 interior cells and refuses it,
    naming the queue, at any other, before any build."""
    spec = _one(lambda sh, pv: (pv[0][1:13] * sh(0, 1, 0, 0),))
    spec = TSP.StencilSpec(name="stop", fields=("a",),
                           offsets={"a": STAR1}, source=spec.source,
                           pack_params=lambda p: (p,))
    gen = spec.cuda_functor()
    assert gen.zslots == ((0, 1, 0, ((1, 13),)),)
    assert "return 1;" in gen.text      # zoff: element 1 - 1 + pad
    gen.check_vectors("stop", (torch.zeros(20),), 14)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        gen.check_vectors("stop", (torch.zeros(20),), 16)
    # an element past its view (Python's slicing, whatever the length)
    # is refused at the launch too
    past = _one(lambda sh, pv: (pv[0][1:3][5] * sh(0, 1, 0, 0),))
    with pytest.raises(ValueError, match="past its"):
        past.cuda_functor().check_vectors("past", (torch.zeros(20),), 14)


# --- builds, plans and shared bytes ------------------------------------------

def test_builds_follow_the_ring_registers():
    """Each new ring's builds by `RING_TIERS` (floats a thread keeps: L
    levels x (R + LAG) slices x fields x cells, the newest and the loaded
    slice, rk2's FIFO where it is deeper than one), at the most levels a
    pass whose 2-cell ring fits the last tier and whose largest block
    holds a slab of 4 x its halo rows of a 64-cell column (one step a
    pass where none does: tvd_vl at rk2)."""
    cases = {  # name, stages: (max levels, {C: threads}, 2-cell floats)
        ("hyperdiff4", 1): (3, {2: 512, 4: 512}, 28),
        ("hyperdiff4", 2): (2, {2: 512, 4: 512}, 20),
        ("smag_cross", 1): (4, {2: 512, 4: 512}, 28),
        ("smag_cross", 2): (4, {2: 512, 4: 384}, 36),
        ("moist6", 1): (3, {2: 384}, 96),
        ("moist6", 2): (2, {2: 384}, 72),
        ("tvd_vl", 1): (1, {2: 512, 4: 384}, 48),
        ("tvd_vl", 2): (2, {2: 384}, 80),
    }
    for (name, stages), (levels, builds, floats) in cases.items():
        gen = specs(name)[0].cuda_functor()
        assert gen.max_levels(stages) == levels
        assert gen.builds(stages) == builds
        assert gen.ring_floats(levels, 2, stages) == floats
        integ = "rk2" if stages == 2 else "euler"
        spec = specs(name, integ)[0]
        assert TK.spec_levels(spec) == levels
        assert TK.spec_passes(spec, 4) == TK.fused_passes(
            4, levels // stages)
    # a ring of radius 1 without x-diagonal reads keeps the shipped builds
    lap = TSP.StencilSpec(name="lap", fields=("a",), offsets={"a": STAR1},
                          source=lambda sh, pv: (sh(0, 1, 0, 0)
                                                 - sh(0, 0, 1, 0),),
                          pack_params=lambda p: ())
    assert lap.cuda_functor().builds(1) == _build.K6_BUILDS[2, 1]


def hand_shared(levels, S, W, C, n_fields, n_coef, radius, slots, head=0):
    """K6's shared bytes counted by hand: head floats, the z coefficients,
    `slots` planes a level and field of S rows at the planes' pitch, and
    the tail the last row's z + radius reads reach past the last plane."""
    zs = -(-W // C)
    pitch = W if zs >= 32 or 32 % zs else (-(-W // zs) | 1) * zs
    tail = max(zs * C + radius - pitch, 0)
    return 4 * (head + n_coef * W + slots * levels * n_fields * S * pitch
                + tail)


@pytest.mark.parametrize("name,integ,T", [
    ("hyperdiff4", "euler", 3), ("hyperdiff4", "rk2", 1),
    ("smag_cross", "euler", 4), ("smag_cross", "rk2", 2),
    ("moist6", "euler", 3), ("moist6", "rk2", 1),
    ("tvd_vl", "euler", 1), ("tvd_vl", "rk2", 1)])
@pytest.mark.parametrize("shape", [(1024, 1024, 64), (40, 300, 200),
                                   (9, 10, 12)])
def test_plans_at_radius_two_diagonal_planes_and_six_fields(name, integ, T,
                                                            shape):
    """`spec_launch_plan` at the spec's halo (radius x levels) with its
    ring's planes: the shared bytes by hand, the slab and window halos
    radius x levels deep, the threads within the build's bound, and the
    analyzer's plan (`smem.fused_ring_plan`) summing to the same bytes."""
    X, Y, Z = shape
    spec = specs(name, integ)[0]
    gen = spec.cuda_functor()
    L, D = spec.stages * T, spec.halo(T)
    plan = TK.spec_launch_plan(X, Y, Z, spec, T, 1, 132, 1)
    C = plan.cells_per_thread
    assert plan.shared_bytes == hand_shared(
        L, plan.S, plan.W, C, spec.n_fields, gen.n_vectors, gen.radius,
        gen.slots)
    assert plan.shared_bytes <= TK.SMEM_PER_BLOCK
    assert plan.S == min(plan.TY + 2 * D, Y)
    assert plan.W == Z or plan.W == plan.CZ + 2 * D
    assert plan.threads <= gen.builds(spec.stages)[C]
    ring = SM.fused_ring_plan(X, Y, Z, T=T, spec=spec)
    assert ring.total() == plan.shared_bytes


def test_a_ring_of_too_many_fields_is_refused_naming_its_bytes():
    """Four hundred fields at radius 4 (one level a pass): not even a
    one-row tile's block (a slab of 9 rows, a window of 9 cells) fits one
    block's shared memory, so the planner raises ValueError naming the
    bytes, before any build; a hundred fit."""
    def spec_of(n):
        def src(sh, pv):
            return tuple(sh(f, 4, 0, 0) - sh(f, 0, 4, 0) for f in range(n))

        names = tuple(f"f{i}" for i in range(n))
        return TSP.StencilSpec(name=f"fields{n}", fields=names,
                               offsets={f: ((4, 0, 0), (0, 4, 0))
                                        for f in names},
                               source=src, pack_params=lambda p: ())

    big = spec_of(400)
    assert TK.spec_on_card(big) and TK.spec_levels(big) == 1
    with pytest.raises(ValueError, match=r"needs \d+ B"):
        TK.spec_launch_plan(64, 1024, 512, big, 1, 1, 132, 1)
    plan = TK.spec_launch_plan(64, 1024, 512, spec_of(100), 1, 1, 132, 1)
    assert plan.shared_bytes <= TK.SMEM_PER_BLOCK


# --- the plain version against the reference ---------------------------------

def run_port(name, integ, fields, T, dtype, coef_dtype, xm=None, ym=None):
    spec = specs(name, integ)[0]
    X, Y, Z = fields[0].shape
    tf = [torch.tensor(f).to(dtype) for f in fields]
    return TK.stencil_fused(tf, params(name, Z, coef_dtype), spec, T=T,
                            dt=DT[name], x_interior_mask=xm,
                            y_interior_mask=ym)


@pytest.mark.parametrize("name", NAMES + MATH_NAMES)
@pytest.mark.parametrize("integ", ["euler", "rk2"])
def test_f32_plain_equals_jax_spec_multistep(name, integ):
    """f32: the port's `stencil_fused` (its plain version here) == the
    reference's `spec_multistep` within TOL_REL_F32 of the field scale;
    the fields move by more than 5x that."""
    T = 3
    fields = np_fields(name)
    js = specs(name, integ)[1]
    want = JSP.spec_multistep(tuple(jnp.asarray(f) for f in fields),
                              jparams(name, SHAPE[2]), js, T, DT[name])
    got = run_port(name, integ, fields, T, torch.float32, torch.float32)
    scale = max(1.0, max(float(np.max(np.abs(as_np(w)))) for w in want))
    tol = TOL_REL_F32 * scale
    assert max_diff([as_np(g) for g in got], want) <= tol
    assert max_diff(want, fields) > 5 * tol


def jax_bf16_ring(name, integ, fields, coef, T, xm, ym, spec=None):
    """The reference ring's bf16 masked loop of one spec (or `spec`) from
    `fields` rounded to bf16, its coefficients in `coef`."""
    from test_torch_stencil_bf16 import jax_bf16_loop
    jd = jnp.float32 if coef == "f32" else jnp.bfloat16
    return jax_bf16_loop(tuple(jnp.asarray(f, jnp.bfloat16) for f in fields),
                         jparams(name, SHAPE[2], jd),
                         spec or specs(name, integ)[1], T, DT[name], xm, ym)


@pytest.mark.parametrize("name", NAMES + MATH_NAMES)
@pytest.mark.parametrize("integ", ["euler", "rk2"])
@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_bf16_plain_equals_jax_bf16_ring(name, integ, coef):
    """bf16 fields, f32 or bf16 coefficients, with interior masks: the
    port's plain version == the reference ring's bf16 masked loop,
    bitwise (the three math specs' twins multiply by a number as torch
    does, `by_number`); the fields move."""
    from test_torch_stencil_bf16 import masks
    T = 2
    fields = np_fields(name, seed=5)
    xm, ym = masks(SHAPE)
    cd = torch.float32 if coef == "f32" else BF16
    want = jax_bf16_ring(name, integ, fields, coef, T, xm, ym)
    got = run_port(name, integ, fields, T, BF16, cd, torch.tensor(xm),
                   torch.tensor(ym))
    assert all(g.dtype == BF16 for g in got)
    assert all(np.array_equal(as_np(g), np.asarray(w, np.float32))
               for g, w in zip(got, want))
    assert max_diff([as_np(g) for g in got],
                    [np.asarray(jnp.asarray(f, jnp.bfloat16), np.float32)
                     for f in fields]) > 0.0


def f32_once(js):
    """A JAX spec whose sources are `js`'s computed in f32 from the bf16
    fields and coefficients and rounded once to bf16: what a port that
    skipped the bf16 roundings between a source's operations would give."""
    def source(sh, pv):
        out = js.source(lambda *a: sh(*a).astype(jnp.float32),
                        tuple(v.astype(jnp.float32) for v in pv))
        return tuple(o.astype(jnp.bfloat16) for o in out)
    return JSP.StencilSpec(name=js.name, fields=js.fields,
                           offsets=js.offsets, source=source,
                           pack_params=js.pack_params,
                           integrator=js.integrator)


@pytest.mark.parametrize("name", MATH_NAMES)
@pytest.mark.parametrize("integ", ["euler", "rk2"])
@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_the_bf16_gate_fails_sources_rounded_once(name, integ, coef):
    """The bitwise bf16 gate above can tell where the roundings fall: the
    reference ring with each source computed in f32 and rounded once
    (`f32_once`) differs from the port's plain version in some cell of
    some field."""
    from test_torch_stencil_bf16 import masks
    T = 2
    fields = np_fields(name, seed=5)
    xm, ym = masks(SHAPE)
    cd = torch.float32 if coef == "f32" else BF16
    once = jax_bf16_ring(name, integ, fields, coef, T, xm, ym,
                         f32_once(specs(name, integ)[1]))
    got = run_port(name, integ, fields, T, BF16, cd, torch.tensor(xm),
                   torch.tensor(ym))
    assert not all(np.array_equal(as_np(g), np.asarray(w, np.float32))
                   for g, w in zip(got, once))


@pytest.mark.parametrize("name", MATH_NAMES)
def test_spec_flops_per_cell_equals_the_reference(name):
    """The port's op census == the reference's jaxpr census on each of the
    three specs (a math function, a power, a floor division, a remainder
    and a clip count nothing in either; a comparison times a value one
    mul)."""
    ts, js = specs(name)
    want = {"satadj3": 34, "sponge_log": 33, "wrap_phase": 38}[name]
    assert TSP.spec_flops_per_cell(ts, params(name, 4)) == want
    assert JSP.spec_flops_per_cell(js, jparams(name, 4)) == want


# one-line specs, torch and JAX, and their census
CENSUS = {
    "(a > 0) * b": (lambda sh, pv: ((sh(0, 1, 0, 0) > 0.0) * sh(0, 0, 0, 0),),
                    lambda sh, pv: ((sh(0, 1, 0, 0) > 0.0) * sh(0, 0, 0, 0),),
                    1),
    "a ** 2": (lambda sh, pv: (sh(0, 1, 0, 0) ** 2,),
               lambda sh, pv: (sh(0, 1, 0, 0) ** 2,), 0),
    "a ** 1.5": (lambda sh, pv: (sh(0, 1, 0, 0) ** 1.5,),
                 lambda sh, pv: (sh(0, 1, 0, 0) ** 1.5,), 0),
    "a // 3 + a % 3": (
        lambda sh, pv: (sh(0, 1, 0, 0) // 3.0 + sh(0, 1, 0, 0) % 3.0,),
        lambda sh, pv: (sh(0, 1, 0, 0) // 3.0 + sh(0, 1, 0, 0) % 3.0,), 1),
    "clip * 2": (lambda sh, pv: (torch.clamp(sh(0, 1, 0, 0), min=0.0) * 2.0,),
                 lambda sh, pv: (jnp.clip(sh(0, 1, 0, 0), min=0.0) * 2.0,),
                 1),
    "exp - sigmoid": (
        lambda sh, pv: (torch.exp(sh(0, 1, 0, 0))
                        - torch.sigmoid(sh(0, 0, 0, 0)),),
        lambda sh, pv: (jnp.exp(sh(0, 1, 0, 0))
                        - jax.nn.sigmoid(sh(0, 0, 0, 0)),), 1),
}


@pytest.mark.parametrize("case", sorted(CENSUS))
def test_one_node_census_equals_the_reference(case):
    tf, jf, want = CENSUS[case]
    ts = TSP.StencilSpec(name="c", fields=("a",), offsets={"a": STAR1},
                         source=tf, pack_params=lambda p: ())
    js = JSP.StencilSpec(name="c", fields=("a",), offsets={"a": STAR1},
                         source=jf, pack_params=lambda p: ())
    assert TSP.spec_flops_per_cell(ts, ()) == want == \
        JSP.spec_flops_per_cell(js, ())


@pytest.mark.parametrize("name", NAMES + MATH_NAMES)
def test_batched_equals_sequential_and_passes_equal_one_run(name):
    """B = 3 slots with per-slot masks == three calls, bitwise; T = 5 as
    the passes `spec_passes` splits it == five steps of the plain loop."""
    spec = specs(name)[0]
    X, Y, Z = SHAPE
    slots = [np_fields(name, seed=s) for s in range(3)]
    rng = np.random.default_rng(1)
    xm = torch.tensor((rng.random((3, X)) > 0.2).astype(np.float32))
    ym = torch.tensor((rng.random((3, Y)) > 0.2).astype(np.float32))
    stacked = [torch.stack([torch.tensor(s[f]) for s in slots])
               for f in range(spec.n_fields)]
    p = params(name, Z)
    got = TK.stencil_fused_batched(stacked, p, spec, T=2, dt=DT[name],
                                   x_interior_mask=xm, y_interior_mask=ym)
    for b in range(3):
        one = TK.stencil_fused([torch.tensor(f) for f in slots[b]], p, spec,
                               T=2, dt=DT[name], x_interior_mask=xm[b],
                               y_interior_mask=ym[b])
        assert bitwise([g[b] for g in got], one)
    fields = [torch.tensor(f) for f in slots[0]]
    deep = TK.stencil_fused(fields, p, spec, T=5, dt=DT[name])
    steps = fields
    for _ in range(5):
        steps = TK.stencil_fused(steps, p, spec, T=1, dt=DT[name])
    assert bitwise(deep, steps)


@pytest.mark.parametrize("name", NAMES + MATH_NAMES)
def test_the_plain_version_does_not_trace_the_callback(name, monkeypatch):
    """On CPU tensors the plain version neither traces the callback into
    CUDA text nor asks the functor's levels: with the functor raising (a
    tracer fault) the CPU run is what it was, bitwise, in whole steps of
    `_build.K6_MAX_LEVELS` levels a pass; the card's split still asks the
    functor."""
    spec = specs(name)[0]
    Z = SHAPE[2]
    fields = [torch.tensor(f) for f in np_fields(name, seed=3)]
    p = params(name, Z)
    want = TK.stencil_fused(fields, p, spec, T=4, dt=DT[name])

    def fault(self):
        raise AssertionError("a fault in the tracer")

    monkeypatch.setattr(TSP.StencilSpec, "cuda_functor", fault)
    got = TK.stencil_fused(fields, p, spec, T=4, dt=DT[name])
    assert bitwise(got, want) and not bitwise(got, fields)
    assert TK.spec_passes(spec, 4, "cpu") == TK.fused_passes(
        4, _build.K6_MAX_LEVELS // spec.stages)
    with pytest.raises(AssertionError, match="a fault in the tracer"):
        TK.spec_passes(spec, 4, "cuda")


# --- the analyzer ------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES + MATH_NAMES)
def test_the_ledger_prices_each_pass_at_its_model(name):
    """On fake CUDA tensors: each K6 pass of the spec is one op whose
    bytes are its model (each field read and written once), live == fake
    does not need the card: the recorded ops are the passes."""
    from repro_torch.analysis import programs as PR
    from repro_torch.analysis import trace as TR
    spec = specs(name)[0]
    X, Y, Z = 64, 48, 16
    prog = PR.user_spec_program(spec, X, Y, Z, params=params(name, Z),
                                T=4, dt=DT[name])
    with TR.fake_mode():
        fn, args = prog.build("cuda")
        records = TR.record_ops(fn, *args)
    from repro_torch.analysis.ledger import MovementLedger
    led = MovementLedger.from_ops(records)
    for cat, want in prog.claims.items():
        assert led.total(cat) == want
    assert sum(1 for r in records if r.op == "stencil_fused") == \
        len(TK.spec_passes(spec, 4))


# --- the distributed plain run against the reference's -----------------------

JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "tests")
    import jax.numpy as jnp
    import numpy as np
    from repro.kernels.advection.ref import default_params
    from repro.launch.mesh import make_stencil_mesh
    from repro.stencil import distributed as D
    from test_torch_spec_shapes import (DIST_CASES, DIST_GRID, DT, jparams,
                                        np_fields, specs)

    res = {}
    for integ, T, (nx, ny) in DIST_CASES:
        _, spec = specs("hyperdiff4", integ)
        fields = tuple(jnp.asarray(f)
                       for f in np_fields("hyperdiff4", DIST_GRID, 7))
        sp = jparams("hyperdiff4", DIST_GRID[2])
        p = default_params(DIST_GRID[2])
        mesh = make_stencil_mesh(nx, ny)
        for ex in ("collective", "remote_dma"):
            fn = D.make_distributed_step(
                mesh, p, axis="y", x_axis="x", T=T, dt=DT["hyperdiff4"],
                exchange=ex, spec=spec, spec_params=sp)
            res[f"{integ}/{T}/{nx}x{ny}/{ex}"] = np.asarray(fn(*fields)[0])
    np.savez(OUT, **res)
    print("OK")
""")
# (integrator, T, mesh) of the distributed hyperdiff4 runs: depth
# spec.halo(T) = 2 to 4 at radius 2
DIST_CASES = (("euler", 1, (2, 2)), ("euler", 2, (2, 2)),
              ("rk2", 1, (2, 2)), ("euler", 1, (1, 4)))
DIST_GRID = (12, 16, 12)


@pytest.fixture(scope="module")
def jax_dist(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_spec_shapes") / "out.npz"
    run_ok(f"OUT = {str(out)!r}\n" + JAX_CHILD, timeout=300)
    with np.load(out) as r:
        return {k: r[k] for k in r.files}


@pytest.mark.parametrize("case", DIST_CASES)
@pytest.mark.parametrize("engine", ["collective", "remote_dma"])
@pytest.mark.parametrize("local_kernel", ["reference", "fused"])
def test_distributed_hyperdiff4_equals_jax(jax_dist, case, engine,
                                           local_kernel):
    """The port's distributed hyperdiff4 step on CPU shards of a loopback
    mesh (K6's and K7's plain versions) == the reference's distributed
    spec step on 4 host devices, within TOL_REL_F32 of the field scale;
    and == the single-domain `stencil_fused`, bitwise."""
    from repro_torch.kernels.advection.ref import default_params
    from repro_torch.launch import mesh as TM
    from repro_torch.stencil import distributed as TD
    integ, T, (nx, ny) = case
    spec = specs("hyperdiff4", integ)[0]
    fields = [torch.tensor(f) for f in np_fields("hyperdiff4", DIST_GRID, 7)]
    sp = params("hyperdiff4", DIST_GRID[2])
    mesh = TM.make_stencil_mesh(nx, ny, devices=["cpu"] * (nx * ny))
    step = TD.make_distributed_step(
        mesh, default_params(DIST_GRID[2], device="cpu"), T=T,
        dt=DT["hyperdiff4"], spec=spec, spec_params=sp, exchange=engine,
        local_kernel=local_kernel)
    got = TD.gather(mesh, step(TD.shard(mesh, *fields)))
    want = jax_dist[f"{integ}/{T}/{nx}x{ny}/{engine}"]
    scale = max(1.0, float(np.max(np.abs(want))))
    assert max_diff([as_np(got[0])], [want]) <= TOL_REL_F32 * scale
    single = TK.stencil_fused(fields, sp, spec, T=T, dt=DT["hyperdiff4"])
    assert bitwise(got, single)
    assert max_diff([as_np(got[0])], [fields[0].numpy()]) > 0.0
