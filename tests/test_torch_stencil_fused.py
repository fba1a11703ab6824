"""The port's spec ring (`repro_torch.kernels.advection.advection.
stencil_fused[_batched]`), its byte models and its CUDA dispatch table,
against the JAX reference on the same numpy inputs.

On the CPU the wrapper runs the kernel's plain version; it is held here
against a masked JAX `spec_multistep` loop, the f64 oracle, the port's own
hand-written `advect_fused` (bitwise) and, where the installed Pallas still
has `pl.Unblocked`, the JAX `stencil_fused` kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.core import roofline as JR
from repro.kernels.advection import advection as JK
from repro.stencil import spec as JSP
from repro_torch import _build
from repro_torch.core import roofline as TR
from repro_torch.core.roofline import SMEM_PER_BLOCK
from repro_torch.kernels.advection import advection as TK
from repro_torch.stencil import spec as TSP

from test_torch_spec import F32_KEYS, KEYS, SHAPE, TOL_REL_F32, \
    assert_f32_close, max_diff, operator, scale_of, tfields

needs_unblocked = pytest.mark.skipif(
    not hasattr(pl, "Unblocked"), reason="the installed Pallas has no "
    "pl.Unblocked, which the JAX stencil_fused kernel needs (jax 0.4.x has "
    "it)")


def masks(shape):
    X, Y, _ = shape
    return ((np.arange(X) % 5 != 0).astype(np.float32),
            (np.arange(Y) % 4 != 0).astype(np.float32))


def jax_masked_multistep(fields, jp, js, T, dt, xm=None, ym=None):
    """The reference's spec step with the kernel's x/y interior masks:
    sources walled to zero outside `r <= x <= X-1-r`, `xm > 0`, `ym > 0`."""
    X, Y, _ = fields[0].shape
    r = js.radius
    xm = np.ones(X, np.float32) if xm is None else xm
    ym = np.ones(Y, np.float32) if ym is None else ym
    j = np.arange(X)
    x_ok = (j >= r) & (j <= X - 1 - r) & (xm > 0)
    m = jnp.asarray(x_ok[:, None, None] & (ym > 0)[None, :, None])
    fs = tuple(jnp.asarray(f, jnp.float32) for f in fields)

    def masked(gs):
        return [jnp.where(m, s, 0.0) for s in JSP.spec_sources(gs, jp, js)]

    for _ in range(T):
        if js.integrator == "euler":
            fs = tuple(f + dt * s for f, s in zip(fs, masked(fs)))
        else:
            g = tuple(f + (0.5 * dt) * s for f, s in zip(fs, masked(fs)))
            fs = tuple(f + dt * s for f, s in zip(fs, masked(g)))
    return fs


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --- the plain version against the reference --------------------------------

@pytest.mark.parametrize("key", F32_KEYS)
@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_jax_masked_spec_loop(key, T, masked):
    ts, js, tp, jp, fields, dt = operator(key)
    xm, ym = masks(SHAPE) if masked else (None, None)
    got = TK.stencil_fused(tfields(fields), tp, ts, T=T, dt=dt,
                           x_interior_mask=xm, y_interior_mask=ym)
    want = jax_masked_multistep(fields, jp, js, T, dt, xm, ym)
    assert all(tuple(g.shape) == SHAPE for g in got)
    assert_f32_close(key, got, want, fields)


@pytest.mark.parametrize("key", F32_KEYS)
def test_plain_within_tolerance_of_f64_oracle(key):
    ts, _, tp, _, fields, dt = operator(key)
    got = TK.stencil_fused(tfields(fields), tp, ts, T=2, dt=dt)
    oracle = TSP.spec_multistep_ref_f64(fields, tp, ts, 2, dt)
    assert_f32_close(key, got, oracle, fields)


@needs_unblocked
@pytest.mark.parametrize("key", F32_KEYS)
@pytest.mark.parametrize("y_tile", [None, 5])
def test_plain_matches_jax_stencil_fused(key, y_tile):
    ts, js, tp, jp, fields, dt = operator(key)
    xm, ym = masks(SHAPE)
    want = JK.stencil_fused(tuple(jnp.asarray(f, jnp.float32)
                                  for f in fields), jp, js, T=2, dt=dt,
                            y_tile=y_tile, x_interior_mask=xm,
                            y_interior_mask=ym)
    got = TK.stencil_fused(tfields(fields), tp, ts, T=2, dt=dt,
                           y_tile=y_tile, x_interior_mask=xm,
                           y_interior_mask=ym)
    assert_f32_close(key, got, want, fields)


# --- internal bitwise contracts ----------------------------------------------

@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("y_tile", [None, 3, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_pw_spec_equals_advect_fused_bitwise(T, y_tile, masked):
    _, _, tp, _, fields, dt = operator("pw")
    xm, ym = masks(SHAPE) if masked else (None, None)
    kw = dict(T=T, dt=dt, y_tile=y_tile, x_interior_mask=xm,
              y_interior_mask=ym)
    got = TK.stencil_fused(tfields(fields), tp, TSP.pw_advection_spec(),
                           **kw)
    assert bitwise(got, TK.advect_fused(*tfields(fields), tp, **kw))


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
@pytest.mark.parametrize("masked", [False, True])
def test_tracer_velocities_equal_pw_bitwise(integrator, masked):
    _, _, tp, _, fields, dt = operator("tracer")
    xm, ym = masks(SHAPE) if masked else (None, None)
    kw = dict(T=2, dt=dt, x_interior_mask=xm, y_interior_mask=ym)
    out4 = TK.stencil_fused(tfields(fields), tp,
                            TSP.tracer_advection_spec(integrator), **kw)
    out3 = TK.stencil_fused(tfields(fields[:3]), tp,
                            TSP.pw_advection_spec(integrator), **kw)
    assert bitwise(out4[:3], out3)
    assert not torch.equal(out4[3], tfields(fields)[3])


@pytest.mark.parametrize("key", KEYS)
def test_batched_equals_sequential_bitwise(key):
    ts, _, tp, _, _, dt = operator(key)
    B, (X, Y, Z) = 3, SHAPE
    rng = np.random.default_rng(11)
    fields = [torch.tensor(rng.normal(size=(B, X, Y, Z)), dtype=torch.float32)
              for _ in range(ts.n_fields)]
    xm = torch.ones(B, X)
    ym = torch.ones(B, Y)
    xm[1, 3] = 0.0
    ym[2, 4:7] = 0.0
    out = TK.stencil_fused_batched(fields, tp, ts, T=2, dt=dt, y_tile=4,
                                   x_interior_mask=xm, y_interior_mask=ym)
    for b in range(B):
        one = TK.stencil_fused([f[b] for f in fields], tp, ts, T=2, dt=dt,
                               y_tile=4, x_interior_mask=xm[b],
                               y_interior_mask=ym[b])
        assert bitwise([o[b] for o in out], one), b


@pytest.mark.parametrize("key", KEYS)
def test_boundary_cells_frozen(key):
    ts, _, tp, _, fields, dt = operator(key)
    f0 = tfields(fields)
    out = TK.stencil_fused(f0, tp, ts, T=3, dt=dt)
    r = ts.radius
    for a, b in zip(f0, out):
        assert torch.equal(b[:r], a[:r]) and torch.equal(b[-r:], a[-r:])
        assert torch.equal(b[:, :r], a[:, :r])
        assert torch.equal(b[:, -r:], a[:, -r:])
        assert torch.equal(b[:, :, :r], a[:, :, :r])
        assert torch.equal(b[:, :, -r:], a[:, :, -r:])
        assert not torch.equal(a, b)


def test_all_ones_masks_are_a_bitwise_no_op():
    ts, _, tp, _, fields, dt = operator("tracer_rk2")
    plain = TK.stencil_fused(tfields(fields), tp, ts, T=2, dt=dt)
    ones = TK.stencil_fused(tfields(fields), tp, ts, T=2, dt=dt,
                            x_interior_mask=np.ones(SHAPE[0]),
                            y_interior_mask=torch.ones(SHAPE[1]))
    assert bitwise(plain, ones)


def test_user_defined_spec_runs_on_cpu():
    """A spec outside the CUDA table still runs through the plain version
    on CPU tensors, and agrees with the reference's steps."""
    def src(sh, pv):
        (k,) = pv
        return (k[2:][2:-2] * (sh(0, 2, 0, 0) - sh(0, -2, 0, 0)),)

    def pack(p):
        return (p,)

    def make(mod):
        return mod.StencilSpec(name="wide_x", fields=("a",),
                               offsets={"a": ((2, 0, 0), (-2, 0, 0))},
                               source=src, pack_params=pack)
    rng = np.random.default_rng(3)
    a = rng.normal(size=(9, 8, 10)).astype(np.float32)
    k = (0.1 * np.arange(12)).astype(np.float32)
    got = TK.stencil_fused([torch.tensor(a)], torch.tensor(k), make(TSP),
                           T=2, dt=0.01)
    want = JSP.spec_multistep([jnp.asarray(a)], jnp.asarray(k), make(JSP), 2,
                              0.01)
    assert max_diff(got, want) <= TOL_REL_F32 * scale_of(want)


# --- arguments ---------------------------------------------------------------

def test_rejects_bad_args_as_reference():
    ts, _, tp, _, fields, _ = operator("tracer")
    f = tfields(fields)
    with pytest.raises(ValueError, match="T must be"):
        TK.stencil_fused(f, tp, ts, T=0)
    with pytest.raises(ValueError, match="got 3 arrays"):
        TK.stencil_fused(f[:3], tp, ts, T=1)
    with pytest.raises(ValueError, match="shape"):
        TK.stencil_fused(f[:3] + (f[3][:, :-1].contiguous(),), tp, ts, T=1)
    with pytest.raises(ValueError, match="y_tile must be"):
        TK.stencil_fused(f, tp, ts, T=1, y_tile=0)
    with pytest.raises(ValueError, match="y_interior_mask must have shape"):
        TK.stencil_fused(f, tp, ts, T=1, y_interior_mask=np.ones(3))
    with pytest.raises(ValueError, match="x_interior_mask must have shape"):
        TK.stencil_fused(f, tp, ts, T=1, x_interior_mask=np.ones(3))
    with pytest.raises(ValueError, match="must be slot-stacked"):
        TK.stencil_fused_batched(f, tp, ts, T=1)
    with pytest.raises(ValueError, match=r"must be \(X, Y, Z\)"):
        TK.stencil_fused([g[None] for g in f], tp, ts, T=1)
    with pytest.raises(TypeError, match="float32"):
        TK.stencil_fused([g.double() for g in f], tp, ts, T=1)
    with pytest.raises(ValueError, match="contiguous"):
        TK.stencil_fused([g.transpose(0, 1) for g in f], tp, ts, T=1)
    with pytest.raises(TypeError, match="torch.Tensor"):
        TK.stencil_fused(fields, tp, ts, T=1)


def test_bf16_is_refused_naming_the_queue():
    """The bf16 refusal is lifted: the bf16 call runs, keeps the dtype and
    equals the plain loop (`_stencil_fused_plain`) bitwise."""
    ts, _, tp, _, fields, _ = operator("pw")
    dt = 0.5    # most updates move a cell by more than half a bf16 ulp
    f16 = [f.bfloat16() for f in tfields(fields)]
    got = TK.stencil_fused(f16, tp, ts, T=2, dt=dt)
    X, Y, _ = SHAPE
    pv = TK._spec_param_vectors(ts, tp, "cpu", torch.bfloat16)
    want = TK._stencil_fused_plain([f[None] for f in f16], pv, ts, 2, dt,
                                   torch.ones(X), torch.ones(Y))
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert bitwise(got, [w[0] for w in want])
    assert not bitwise(got, f16)


def test_pack_params_must_return_vectors():
    spec = TSP.StencilSpec(name="flat", fields=("a",),
                           offsets={"a": ((1, 0, 0),)},
                           source=lambda sh, pv: (sh(0, 1, 0, 0),),
                           pack_params=lambda p: (torch.ones(2, 2),))
    with pytest.raises(ValueError, match="pack_params must return 1-D"):
        TK.stencil_fused([torch.ones(4, 5, 6)], None, spec, T=1)


# --- byte models with the spec knobs ---------------------------------------

@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("Y,Z", [(1024, 64), (17, 12)])
@pytest.mark.parametrize("y_tile", [None, 5, 16])
@pytest.mark.parametrize("knobs", [
    dict(), dict(halo=8), dict(n_fields=4, n_slots=3, n_levels=4, halo=4),
    dict(n_fields=1, n_slots=5, n_levels=8, halo=16), dict(n_fields=4)])
def test_fused_register_bytes_knobs_equal_jax(T, Y, Z, y_tile, knobs):
    for itemsize in (2, 4):
        got = TK.fused_register_bytes(T, Y, Z, itemsize, y_tile, **knobs)
        assert got == JK.fused_register_bytes(T, Y, Z, itemsize, y_tile,
                                              **knobs)
        if not knobs:
            assert got == TK.fused_register_bytes(T, Y, Z, itemsize, y_tile,
                                                  None, n_fields=3,
                                                  n_slots=3, n_levels=T)


@pytest.mark.parametrize("key", KEYS)
def test_spec_ring_knobs_size_the_reference_ring(key):
    ts, js, *_ = operator(key)
    for T in (1, 2, 4):
        k = TK.spec_ring_knobs(ts, T)
        assert k == dict(n_fields=js.n_fields, n_slots=2 * js.radius + 1,
                         n_levels=js.stages * T, halo=js.halo(T))
        assert TK.fused_register_bytes(T, 1024, 64, 4, 16, **k) == \
            JK.fused_register_bytes(T, 1024, 64, 4, 16, **k)


@pytest.mark.parametrize("variant", ["pointwise", "blocked", "dataflow",
                                     "fused"])
@pytest.mark.parametrize("n_fields,halo_depth", [(3, None), (4, 4), (1, 8),
                                                 (4, None), (3, 2)])
def test_hbm_bytes_model_knobs_equal_jax_lane_aligned(variant, n_fields,
                                                       halo_depth):
    kw = dict(n_fields=n_fields, halo_depth=halo_depth)
    for T in (1, 2, 4):
        for extra in (dict(), dict(y_tile=16, grid_tiled=False),
                      dict(fuse_update=False)):
            assert TK.hbm_bytes_model(32, 64, 128, 4, variant, T=T, **extra,
                                      **kw) == \
                JK.hbm_bytes_model(32, 64, 128, 4, variant, T=T, **extra,
                                   **kw)


@pytest.mark.parametrize("Z", [64, 12])
@pytest.mark.parametrize("n_fields", [1, 4])
def test_hbm_bytes_model_knobs_off_lane_rule(Z, n_fields):
    """Off the 128 lanes the port charges the card's 16-byte row rule; the
    knobs scale it as they scale the reference."""
    lane_eff = (Z % 128) / 128.0
    pad = (-(-Z * 4 // 16) * 16) / (Z * 4)
    for kw in (dict(T=4, halo_depth=8), dict(T=2, y_tile=16,
                                             grid_tiled=False,
                                             halo_depth=4)):
        got = TK.hbm_bytes_model(32, 64, Z, 4, "fused", n_fields=n_fields,
                                 **kw)
        want = JK.hbm_bytes_model(32, 64, Z, 4, "fused", n_fields=n_fields,
                                  **kw)
        assert got == pytest.approx(want * lane_eff * pad, rel=1e-9)


def test_hbm_bytes_model_defaults_unchanged():
    for variant in ("pointwise", "blocked", "dataflow", "wide", "fused"):
        for T in (1, 4):
            assert TK.hbm_bytes_model(16, 64, 64, 4, variant, T=T) == \
                TK.hbm_bytes_model(16, 64, 64, 4, variant, T=T, n_fields=3,
                                   halo_depth=T if variant == "fused" else 1)


@pytest.mark.parametrize("variant", ["pointwise", "blocked", "dataflow",
                                     "fused"])
@pytest.mark.parametrize("y_tile", [None, 4, 16, 100])
@pytest.mark.parametrize("n_fields,halo_depth", [(4, 4), (1, 8), (3, 2),
                                                 (4, None)])
def test_vmem_halo_bytes_model_knobs_equal_jax(variant, y_tile, n_fields,
                                               halo_depth):
    for T in (1, 2, 4):
        for X, Y, Z in ((16, 64, 128), (8, 33, 10)):
            kw = dict(T=T, y_tile=y_tile, n_fields=n_fields,
                      halo_depth=halo_depth)
            assert TK.vmem_halo_bytes_model(X, Y, Z, 4, variant, **kw) == \
                JK.vmem_halo_bytes_model(X, Y, Z, 4, variant, **kw)


def test_vmem_halo_bytes_model_wide_with_halo_depth_equals_jax():
    kw = dict(T=1, y_tile=8, n_fields=4, halo_depth=8)
    assert TK.vmem_halo_bytes_model(8, 64, 128, 4, "wide", **kw) == \
        JK.vmem_halo_bytes_model(8, 64, 128, 4, "wide", **kw)


@pytest.mark.parametrize("shape", [(16, 1024, 64), (3, 5, 7)])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n_fields", [1, 3, 4])
def test_guard_bytes_model_n_fields_equals_jax(shape, batch, n_fields):
    kw = dict(batch=batch, n_fields=n_fields)
    assert TR.guard_bytes_model(*shape, **kw) == \
        JR.guard_bytes_model(*shape, **kw)
    assert TR.guard_bytes_model_parts(*shape, **kw) == \
        JR.guard_bytes_model_parts(*shape, **kw)
    assert sum(TR.guard_bytes_model_parts(*shape, **kw).values()) == \
        TR.guard_bytes_model(*shape, **kw)


def test_guard_bytes_model_refuses_no_fields_as_reference():
    with pytest.raises(ValueError) as want:
        JR.guard_bytes_model(4, 4, 4, n_fields=0)
    with pytest.raises(ValueError) as got:
        TR.guard_bytes_model(4, 4, 4, n_fields=0)
    assert str(got.value) == str(want.value)


# --- tile choice at the 67M grid --------------------------------------------

SIXTY_SEVEN_M = [("pw", 4, 16), ("pw_rk2", 2, 16), ("tracer", 4, 8),
                 ("tracer_rk2", 2, 8), ("diffusion", 4, 64),
                 ("diffusion_rk2", 4, 16)]


@pytest.mark.parametrize("key,T,tile", SIXTY_SEVEN_M)
def test_largest_fitting_y_tile_for_spec_rings(key, T, tile):
    ts = operator(key)[0]
    knobs = TK.spec_ring_knobs(ts, T)
    assert TK.largest_fitting_y_tile(T, 1024, 64, **knobs) == tile
    assert TK.fused_register_bytes(T, 1024, 64, 4, tile, **knobs) <= \
        SMEM_PER_BLOCK


def test_largest_fitting_y_tile_refuses_pw_rk2_at_T4():
    knobs = TK.spec_ring_knobs(TSP.pw_advection_spec("rk2"), 4)
    with pytest.raises(ValueError, match="232448"):
        TK.largest_fitting_y_tile(4, 1024, 64, **knobs)
    # y_tile 1 streams a 17-row slab; the budget holds 12 rows
    assert TK.fused_register_bytes(4, 1024, 64, 4, 1, **knobs) == \
        17 * TK.fused_register_bytes(4, 1, 64, 4, None, **knobs)
    assert SMEM_PER_BLOCK // TK.fused_register_bytes(4, 1, 64, 4, None,
                                                     **knobs) == 12


def test_largest_fitting_y_tile_defaults_unchanged():
    for T in (1, 2, 4):
        assert TK.largest_fitting_y_tile(T, 1024, 64) == \
            TK.largest_fitting_y_tile(T, 1024, 64, n_fields=3, n_slots=3,
                                      n_levels=T, halo=T)


# --- the CUDA dispatch table ---------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_shipped_specs_have_cuda_instantiations(key):
    ts = operator(key)[0]
    op, stages = TK._cuda_instantiation(ts)
    assert stages == ts.stages
    assert op == ts.cuda_op == \
        {"pw": 0, "tracer": 1, "diffusion": 2}[key.split("_")[0]]
    assert len(TSP.CUDA_OPS) == 6


def test_kernel_module_does_not_import_the_spec_layer():
    """The wrapper reads the instantiation off the spec (`cuda_op`); the
    list of shipped operators lives in the spec layer alone."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(TK))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.startswith("repro_torch.stencil")]


def _custom_specs():
    star2 = tuple((d, 0, 0) for d in (-2, -1, 0, 1, 2))
    return {
        "custom source": TSP.StencilSpec(
            name="custom", fields=("a",), offsets={"a": ((1, 0, 0),)},
            source=lambda sh, pv: (sh(0, 1, 0, 0),),
            pack_params=lambda p: ()),
        "radius 2": TSP.StencilSpec(
            name="diffusion_r2", fields=("phi",), offsets={"phi": star2},
            source=TSP._diff_source, pack_params=TSP._diff_pack),
        "pw source, diffusion pack": TSP.StencilSpec(
            name="mixed", fields=("u", "v", "w"),
            offsets={f: TSP._STAR for f in "uvw"}, source=TSP._pw_source,
            pack_params=TSP._diff_pack),
    }


# what the CUDA route makes of each: a generated functor, the shipped PW
# functor (its callback's text is PW's), or a generated functor whose
# parameter vectors the launch refuses (diffusion's callback declared at
# radius 2 slices its z coefficients for radius 1)
CUSTOM_OUTCOMES = {"custom source": "generated",
                   "pw source, diffusion pack": 0,
                   "radius 2": "misaligned"}


@pytest.mark.parametrize("case", sorted(_custom_specs()))
def test_unlisted_spec_refused_on_the_cuda_route(case, monkeypatch):
    """Each spec outside the shipped table meets its expected outcome on
    the CUDA route, which launches nothing and builds nothing before it
    decides: a callback gets an instantiation (its own generated functor,
    or the shipped one whose text it generates); a radius-2 spec whose z
    coefficients are sliced for radius 1 is refused at launch, naming the
    queue."""
    monkeypatch.setattr(_build, "load", _refuse)
    monkeypatch.setattr(_build, "load_generated", _refuse)
    spec = _custom_specs()[case]
    want = CUSTOM_OUTCOMES[case]
    before = dict(TK.LAUNCHES)
    fields = [torch.zeros(1, 6, 6, 6) for _ in range(spec.n_fields)]
    if want == "misaligned":
        op, _ = TK._cuda_instantiation(spec)
        assert op.radius == 2 and op.zslots == ((0, 3, 1),)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 2") as e:
            TK._stencil_fused_cuda(fields, (torch.zeros(8),), spec, 1, 0.01,
                                   torch.ones(6), torch.ones(6))
        assert "Z - 4 = 2 interior cells" in str(e.value)
    else:
        op, stages = TK._cuda_instantiation(spec)
        assert stages == spec.stages
        if want == "generated":
            assert op.n_fields == spec.n_fields and op.n_vectors == 0
            assert "struct GeneratedOp" in op.text
        else:
            assert op == want
        # the parameter vectors are checked before the build: PW's functor
        # reads two, the diffusion pack gives one
        pv = () if want == "generated" else (torch.zeros(8),)
        err, msg = ((RuntimeError, "kernel loader unavailable")
                    if want == "generated" else
                    (ValueError, "reads 2 parameter vectors"))
        with pytest.raises(err, match=msg):
            TK._stencil_fused_cuda(fields, pv, spec, 1, 0.01, torch.ones(6),
                                   torch.ones(6))
    assert TK.LAUNCHES == before


def _refuse(*args, **kwargs):
    raise RuntimeError("kernel loader unavailable")


def test_cuda_route_propagates_loader_errors(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    before = dict(TK.LAUNCHES)
    for key in KEYS:
        ts, _, tp, _, _, _ = operator(key, (4, 8, 8))
        fields = [torch.zeros(1, 4, 8, 8) for _ in range(ts.n_fields)]
        pv = TK._spec_param_vectors(ts, tp, "cpu")
        with pytest.raises(RuntimeError, match="kernel loader unavailable"):
            TK._stencil_fused_cuda(fields, pv, ts, 1, 0.01, torch.ones(4),
                                   torch.ones(8))
    assert TK.LAUNCHES == before


def test_cuda_route_checks_parameter_vectors(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    ts, _, tp, _, _, _ = operator("pw", (4, 8, 8))
    fields = [torch.zeros(1, 4, 8, 10) for _ in range(3)]
    pv = TK._spec_param_vectors(ts, tp, "cpu")      # built for Z = 8
    with pytest.raises(ValueError, match=r"\(Z\+2,\)"):
        TK._stencil_fused_cuda(fields, pv, ts, 1, 0.01, torch.ones(4),
                               torch.ones(8))


def test_cpu_tensors_take_the_plain_version_without_launching(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    before = dict(TK.LAUNCHES)
    for key in KEYS:
        ts, _, tp, _, fields, dt = operator(key)
        TK.stencil_fused(tfields(fields), tp, ts, T=1, dt=dt, y_tile=3)
    assert TK.LAUNCHES == before
    assert "stencil_fused" in TK.LAUNCHES
    TK.reset_launch_counts()
    assert TK.LAUNCHES["stencil_fused"] == 0


def test_build_registers_the_spec_kernel():
    assert "stencil_fused.cu" in _build.SOURCES
    assert "stencil_ops.cuh" in _build.HEADERS
    assert len(_build.SIGNATURES["stencil_fused_f32"]) == 3
