"""The port's stencil-spec frontend (`repro_torch.stencil.spec`) against the
JAX reference (`repro.stencil.spec`), on the same numpy inputs: spec
validation and its error texts, the radius/stages/halo geometry, the
full-array sources and integrator steps of every shipped operator, the f64
oracle, the op census and the seeded initial fields."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.advection import ref as JREF
from repro.stencil import spec as JSP
from repro.stencil.advection import stratus_fields as j_stratus
from repro_torch.kernels.advection import ref as TREF
from repro_torch.stencil import spec as TSP

SHAPE = (8, 10, 8)
TOL_REL_F32 = 2e-5      # the reference's TOL_REL["float32"]
KEYS = ["pw", "pw_rk2", "tracer", "tracer_rk2", "diffusion", "diffusion_rk2"]
# At the reference's dt (1e-3) diffusion moves phi ~ 300 by ~3e-5 a step,
# far inside the f32 tolerance at that scale (~6e-3), so a comparison there
# cannot fail a wrong update. The "_dt10" keys run it at dt = 10, which
# moves phi by ~0.2 a step and is explicit-stable (dt * 4(kx+ky+kz) = 1.65).
RESOLVED_DT = 10.0
F32_KEYS = KEYS + ["diffusion_dt10", "diffusion_rk2_dt10"]
UNRESOLVED = ("diffusion", "diffusion_rk2")

# the reference's pins (tests/test_seed_determinism.py), shape (8, 10, 8)
PINNED = {
    "q": "0c6e5ce4c464a7b0a694a93de6db212ce0292c723a14ba1eaf9da61cd73fdffe",
    "phi": "6779ad1c4b2cfcf0756335d0c28d3dce729495618672c79d3f896b44b09479df",
}


def operator(key, shape=SHAPE):
    """(port spec, reference spec, port params, reference params, numpy
    fields, dt) of one operator key, on the reference's seeded fields."""
    X, Y, Z = shape
    if key.endswith("_dt10"):
        return operator(key[:-len("_dt10")], shape)[:5] + (RESOLVED_DT,)
    integ = "rk2" if key.endswith("rk2") else "euler"
    if key.startswith("diffusion"):
        jp = JSP.default_diffusion_params(Z)
        fields = [np.asarray(JSP.diffusion_field(X, Y, Z))]
        return (TSP.diffusion_spec(integ), JSP.diffusion_spec(integ),
                TSP.diffusion_params_from_numpy(jp, device="cpu"), jp,
                fields, 1e-3)
    jp = JREF.default_params(Z)
    fields = [np.asarray(f) for f in j_stratus(X, Y, Z)]
    if key.startswith("tracer"):
        fields.append(np.asarray(JSP.tracer_field(X, Y, Z)))
        ts, js = TSP.tracer_advection_spec(integ), \
            JSP.tracer_advection_spec(integ)
    else:
        ts, js = TSP.pw_advection_spec(integ), JSP.pw_advection_spec(integ)
    return ts, js, TREF.params_from_numpy(jp, device="cpu"), jp, fields, 0.01


def tfields(fields):
    return TREF.fields_from_numpy(*fields, device="cpu")


def jfields(fields):
    return tuple(jnp.asarray(f, jnp.float32) for f in fields)


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def scale_of(fields):
    return max(1.0, max(float(np.max(np.abs(np.asarray(f, np.float64))))
                        for f in fields))


def assert_f32_close(key, got, want, before):
    """`got` within the f32 tolerance of `want`; and, but for the keys at
    the reference's unresolved diffusion dt, `want` moved from `before` by
    more than 5x that tolerance, so the comparison fails a no-op update."""
    tol = TOL_REL_F32 * scale_of(want)
    assert max_diff(got, want) <= tol
    if key not in UNRESOLVED:
        assert max_diff(want, before) > 5 * tol


# --- validation: the reference's cases (tests/test_stencil_spec_props.py) ---

def _src_one(sh, pv):
    return (sh(0, 0, 0, 0),)


def _pack_one(p):
    return (p,)


def _spec(mod, offs, integrator="euler", fields=("a",), **kw):
    return mod.StencilSpec(name="prop", fields=tuple(fields),
                           offsets={f: tuple(offs) for f in fields},
                           source=_src_one, pack_params=_pack_one,
                           integrator=integrator, **kw)


BAD_SPECS = {
    "offset not a 3-tuple": lambda m: _spec(m, [(1, 0)]),
    "bool offset": lambda m: _spec(m, [(True, 0, 0)]),
    "float offset": lambda m: _spec(m, [(1.5, 0, 0)]),
    "duplicate field": lambda m: _spec(m, [(1, 0, 0)], fields=("a", "a")),
    "field without offsets": lambda m: m.StencilSpec(
        name="x", fields=("a", "b"), offsets={"a": ((1, 0, 0),)},
        source=_src_one, pack_params=_pack_one),
    "unknown field": lambda m: m.StencilSpec(
        name="x", fields=("a",),
        offsets={"a": ((1, 0, 0),), "ghost": ((1, 0, 0),)},
        source=_src_one, pack_params=_pack_one),
    "empty offsets": lambda m: _spec(m, []),
    "bad integrator": lambda m: _spec(m, [(1, 0, 0)], integrator="rk9"),
    "pointwise": lambda m: _spec(m, [(0, 0, 0)]),
    "bad boundary": lambda m: _spec(m, [(1, 0, 0)], boundary="periodic"),
    "empty fields": lambda m: m.StencilSpec(
        name="x", fields=(), offsets={}, source=_src_one,
        pack_params=_pack_one),
    "fields not a tuple": lambda m: m.StencilSpec(
        name="x", fields=["a"], offsets={"a": ((1, 0, 0),)},
        source=_src_one, pack_params=_pack_one),
    "empty field name": lambda m: _spec(m, [(1, 0, 0)], fields=("",)),
    "source not callable": lambda m: m.StencilSpec(
        name="x", fields=("a",), offsets={"a": ((1, 0, 0),)}, source=3,
        pack_params=_pack_one),
    "pack not callable": lambda m: m.StencilSpec(
        name="x", fields=("a",), offsets={"a": ((1, 0, 0),)},
        source=_src_one, pack_params=None),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_errors_equal_reference(case):
    with pytest.raises(ValueError) as want:
        BAD_SPECS[case](JSP)
    with pytest.raises(ValueError) as got:
        BAD_SPECS[case](TSP)
    assert str(got.value) == str(want.value)


def test_accessor_beyond_radius_error_equals_reference():
    def greedy(sh, pv):
        return (sh(0, 2, 0, 0),)

    def make(mod):
        return mod.StencilSpec(name="x", fields=("a",),
                               offsets={"a": ((1, 0, 0),)}, source=greedy,
                               pack_params=lambda p: ())
    with pytest.raises(ValueError) as want:
        JSP.spec_sources((jnp.zeros((6, 6, 6)),), None, make(JSP))
    with pytest.raises(ValueError) as got:
        TSP.spec_sources((torch.zeros((6, 6, 6)),), None, make(TSP))
    assert str(got.value) == str(want.value)
    assert "radius 1" in str(got.value)


def test_halo_of_nonpositive_T_raises_as_reference():
    for T in (0, -1):
        with pytest.raises(ValueError) as want:
            JSP.pw_advection_spec().halo(T)
        with pytest.raises(ValueError) as got:
            TSP.pw_advection_spec().halo(T)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("offs", [[(1, 0, 0)], [(0, -2, 0), (0, 0, 1)],
                                  [(3, 0, 0), (0, 1, 1)], [(-1, -1, -1)]])
@pytest.mark.parametrize("integrator", ["euler", "rk2"])
@pytest.mark.parametrize("n_fields", [1, 4])
def test_radius_stages_halo_equal_reference(offs, integrator, n_fields):
    names = tuple(f"f{i}" for i in range(n_fields))
    ts = _spec(TSP, offs, integrator, names)
    js = _spec(JSP, offs, integrator, names)
    assert (ts.radius, ts.stages, ts.n_fields) == \
        (js.radius, js.stages, js.n_fields)
    for T in (1, 2, 3, 5):
        assert ts.halo(T) == js.halo(T)


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_shipped_specs_mirror_reference(integrator):
    for name in ("pw_advection_spec", "tracer_advection_spec",
                 "diffusion_spec"):
        ts, js = getattr(TSP, name)(integrator), getattr(JSP, name)(integrator)
        assert (ts.name, ts.fields, dict(ts.offsets), ts.boundary,
                ts.integrator) == (js.name, js.fields, dict(js.offsets),
                                   js.boundary, js.integrator)
        assert ts.source.__name__ == js.source.__name__
        assert ts.pack_params.__name__ == js.pack_params.__name__
        assert ts.halo(4) == js.halo(4)


# --- sources, steps, multisteps against the reference ----------------------

@pytest.mark.parametrize("key", KEYS)
def test_spec_sources_match_jax(key):
    ts, js, tp, jp, fields, _ = operator(key)
    got = TSP.spec_sources(tfields(fields), tp, ts)
    want = JSP.spec_sources(jfields(fields), jp, js)
    assert len(got) == ts.n_fields
    assert all(tuple(g.shape) == SHAPE for g in got)
    assert max_diff(got, want) <= TOL_REL_F32 * scale_of(want)


@pytest.mark.parametrize("key", F32_KEYS)
@pytest.mark.parametrize("T", [1, 3])
def test_spec_step_and_multistep_match_jax(key, T):
    ts, js, tp, jp, fields, dt = operator(key)
    step = TSP.spec_step(tfields(fields), tp, ts, dt)
    jstep = JSP.spec_step(jfields(fields), jp, js, dt)
    assert_f32_close(key, step, jstep, fields)
    got = TSP.spec_multistep(tfields(fields), tp, ts, T, dt)
    want = JSP.spec_multistep(jfields(fields), jp, js, T, dt)
    assert_f32_close(key, got, want, fields)


def jax_spec_multistep_f64(fields, jp, js, T, dt):
    """The reference's `spec_multistep` on genuinely f64 inputs, through
    `jax.enable_x64(True)` where `jax.experimental.enable_x64` (which
    `spec_multistep_ref_f64` uses) is gone."""
    if hasattr(jax.experimental, "enable_x64"):
        return JSP.spec_multistep_ref_f64(fields, jp, js, T, dt)
    f_np = [np.asarray(t, np.float64) for t in fields]
    p_np = [np.asarray(t, np.float64) for t in jp]
    with jax.enable_x64(True):
        out = JSP.spec_multistep(tuple(jnp.asarray(t) for t in f_np),
                                 type(jp)(*(jnp.asarray(t) for t in p_np)),
                                 js, T, dt)
        return [np.asarray(t, np.float64) for t in out]


@pytest.mark.parametrize("key", KEYS)
def test_f64_oracle_matches_jax_f64(key):
    ts, js, tp, jp, fields, dt = operator(key)
    got = TSP.spec_multistep_ref_f64(fields, tp, ts, 2, dt)
    assert all(g.dtype == torch.float64 for g in got)
    want = jax_spec_multistep_f64(fields, jp, js, 2, dt)
    assert max_diff(got, want) <= 1e-12 * scale_of(want)


@pytest.mark.parametrize("key", F32_KEYS)
def test_f32_multistep_within_tolerance_of_f64_oracle(key):
    ts, _, tp, _, fields, dt = operator(key)
    oracle = TSP.spec_multistep_ref_f64(tfields(fields), tp, ts, 3, dt)
    got = TSP.spec_multistep(tfields(fields), tp, ts, 3, dt)
    assert_f32_close(key, got, oracle, fields)


def test_pw_spec_sources_equal_pw_advect_ref_bitwise():
    """The PW callback is `pw_advect_ref` term by term: the `0.0 + tcx` it
    adds changes no bit."""
    ts, _, tp, _, fields, _ = operator("pw")
    got = TSP.spec_sources(tfields(fields), tp, ts)
    want = TREF.pw_advect_ref(*tfields(fields), tp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tracer_sources_of_velocities_equal_pw_bitwise():
    ts, _, tp, _, fields, _ = operator("tracer")
    got = TSP.spec_sources(tfields(fields), tp, ts)
    pw = TSP.spec_sources(tfields(fields[:3]), tp, TSP.pw_advection_spec())
    assert all(torch.equal(a, b) for a, b in zip(got[:3], pw))


def test_spec_sources_take_leading_slot_dims():
    ts, _, tp, _, fields, _ = operator("tracer")
    one = TSP.spec_sources(tfields(fields), tp, ts)
    two = TSP.spec_sources([torch.stack([f, 2 * f]) for f in
                            tfields(fields)], tp, ts)
    assert all(torch.equal(a[0], b) for a, b in zip(two, one))


def test_spec_sources_wrong_field_count_raises_as_reference():
    ts, js, tp, jp, fields, _ = operator("tracer")
    with pytest.raises(ValueError) as want:
        JSP.spec_sources(jfields(fields[:3]), jp, js)
    with pytest.raises(ValueError) as got:
        TSP.spec_sources(tfields(fields[:3]), tp, ts)
    assert str(got.value) == str(want.value)


# --- op census --------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_spec_flops_per_cell_pinned(integrator):
    p = TREF.default_params(4, device="cpu")
    dp = TSP.default_diffusion_params(4, device="cpu")
    assert TSP.spec_flops_per_cell(TSP.pw_advection_spec(integrator), p) \
        == 64
    assert TSP.spec_flops_per_cell(TSP.tracer_advection_spec(integrator),
                                   p) == 85
    assert TSP.spec_flops_per_cell(TSP.diffusion_spec(integrator), dp) == 14


@pytest.mark.parametrize("name,params", [
    ("pw_advection_spec", "adv"), ("tracer_advection_spec", "adv"),
    ("diffusion_spec", "diff")])
def test_spec_flops_per_cell_equals_jaxpr_count(name, params):
    jp = (JREF.default_params(4) if params == "adv"
          else JSP.default_diffusion_params(4))
    tp = (TREF.default_params(4, device="cpu") if params == "adv"
          else TSP.default_diffusion_params(4, device="cpu"))
    assert TSP.spec_flops_per_cell(getattr(TSP, name)(), tp) == \
        JSP.spec_flops_per_cell(getattr(JSP, name)(), jp)


def test_pw_spec_counts_one_more_than_flops_per_cell():
    p = TREF.default_params(4, device="cpu")
    assert TSP.spec_flops_per_cell(TSP.pw_advection_spec(), p) == \
        TREF.flops_per_cell() + 1


# --- seeded fields and params ----------------------------------------------

@pytest.mark.parametrize("shape,seed", [((8, 10, 8), None), ((5, 9, 8), 0),
                                        ((16, 24, 64), 11)])
def test_tracer_and_diffusion_fields_byte_identical(shape, seed):
    kw = {} if seed is None else {"seed": seed}
    for name in ("tracer_field", "diffusion_field"):
        got = getattr(TSP, name)(*shape, device="cpu", **kw)
        want = getattr(JSP, name)(*shape, **kw)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), name


def test_spec_fields_content_pinned():
    X, Y, Z = SHAPE
    for name, f in (("q", TSP.tracer_field(X, Y, Z, device="cpu")),
                    ("phi", TSP.diffusion_field(X, Y, Z, device="cpu"))):
        assert hashlib.sha256(f.numpy().tobytes()).hexdigest() == \
            PINNED[name], name


@pytest.mark.parametrize("Z", [8, 64])
def test_default_diffusion_params_equal_reference(Z):
    got = TSP.default_diffusion_params(Z, device="cpu")
    want = JSP.default_diffusion_params(Z)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    again = TSP.diffusion_params_from_numpy(want, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_fields_from_numpy_takes_any_number_of_fields():
    rng = np.random.default_rng(5)
    arrs = [rng.normal(size=(3, 4, 5)) for _ in range(4)]
    out = TREF.fields_from_numpy(*arrs, device="cpu")
    assert len(out) == 4
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in out)
    assert all(np.array_equal(t.numpy(), a.astype(np.float32))
               for t, a in zip(out, arrs))
    (phi,) = TREF.fields_from_numpy(arrs[0], device="cpu")
    assert torch.equal(phi, out[0])


def test_default_devices_are_cuda():
    import inspect
    for fn in (TSP.tracer_field, TSP.diffusion_field,
               TSP.default_diffusion_params,
               TSP.diffusion_params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
