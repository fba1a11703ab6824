"""The port's v1-v3 rungs (`advect_blocked`, `advect_dataflow`,
`advect_wide`), the host tile loop and the domain's default variant against
the JAX reference, on the same numpy inputs.

On the CPU the port's wrappers run their kernels' plain versions; those are
held here against JAX `pw_advect_ref` / `pw_step_ref` and, where the
installed Pallas still has `pl.Unblocked`, against the JAX
`advect_blocked` / `advect_dataflow` / `advect_wide` kernels in interpret
mode. Tolerance 1e-6 max abs, as the fused tests use against the jnp loop:
the two frameworks round the same operations, at most an ulp apart."""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels.advection import advection as JK
from repro.kernels.advection import ops as JOPS
from repro.kernels.advection import ref as JREF
from repro.stencil import advection as JSA
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ops as TOPS
from repro_torch.kernels.advection import ref as TREF
from repro_torch.stencil import advection as TSA

DT = 0.01
TOL = 1e-6
RUNGS = ("blocked", "dataflow", "wide")
needs_unblocked = pytest.mark.skipif(
    not hasattr(pl, "Unblocked"), reason="the installed Pallas has no "
    "pl.Unblocked, which the JAX ladder kernels need (jax 0.4.x has it)")


def np_fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def tfields(fields):
    return list(TREF.fields_from_numpy(*fields, device="cpu"))


def tparams(jp):
    return TREF.params_from_numpy(jp, device="cpu")


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def rung(name):
    return getattr(TK, f"advect_{name}")


def jax_ref(fields, jp, fuse_update):
    jf = [jnp.asarray(f) for f in fields]
    if fuse_update:
        return JREF.pw_step_ref(*jf, jp, DT)
    return JREF.pw_advect_ref(*jf, jp)


# --- values against the JAX reference ---------------------------------------

@pytest.mark.parametrize("fuse_update", [False, True])
@pytest.mark.parametrize("name", RUNGS)
@pytest.mark.parametrize("shape", [(5, 9, 8), (5, 17, 12), (4, 16, 128)])
def test_plain_rung_matches_jax_reference(shape, name, fuse_update):
    fields = np_fields(shape, seed=sum(shape))
    jp = JREF.default_params(shape[2])
    got = rung(name)(*tfields(fields), tparams(jp), fuse_update=fuse_update,
                     dt=DT)
    assert all(g.shape == shape for g in got)
    assert max_diff(got, jax_ref(fields, jp, fuse_update)) <= TOL


def test_sources_zero_and_fields_frozen_on_the_boundary():
    shape = (6, 9, 12)
    u0 = tfields(np_fields(shape, seed=1))
    p = tparams(JREF.default_params(12))
    edges = (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
             np.s_[:, :, -1])
    for name in RUNGS:
        src = rung(name)(*u0, p)
        adv = rung(name)(*u0, p, fuse_update=True, dt=DT)
        for s, a, f0 in zip(src, adv, u0):
            for sl in edges:
                assert not torch.any(s[sl]), (name, sl)
                assert torch.equal(a[sl], f0[sl]), (name, sl)


# --- internal bitwise contracts ----------------------------------------------

@pytest.mark.parametrize("tiling", TK.TILINGS)
@pytest.mark.parametrize("y_tile", [3, 4, 5, 17, 64])
@pytest.mark.parametrize("name", RUNGS)
def test_tiled_equals_untiled_bitwise(name, y_tile, tiling):
    """17 rows over tiles of 3, 4 or 5 leave a remainder tile; 17 and 64
    are the untiled fallback. `wide` refuses the host loop when it would
    tile."""
    shape = (5, 17, 12)
    fields = tfields(np_fields(shape, seed=2))
    p = tparams(JREF.default_params(12))
    for fuse in (False, True):
        full = rung(name)(*fields, p, fuse_update=fuse, dt=DT)
        if name == "wide" and tiling == "host" and y_tile < shape[1]:
            with pytest.raises(ValueError, match="in-grid"):
                rung(name)(*fields, p, y_tile=y_tile, tiling=tiling)
            continue
        tiled = rung(name)(*fields, p, y_tile=y_tile, tiling=tiling,
                           fuse_update=fuse, dt=DT)
        assert bitwise(tiled, full), fuse


@pytest.mark.parametrize("y_tile", [3, 5, 7])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_fused_host_tiling_equals_grid_bitwise(T, y_tile):
    fields = tfields(np_fields((6, 17, 12), seed=3))
    p = tparams(JREF.default_params(12))
    grid = TK.advect_fused(*fields, p, T=T, dt=DT, y_tile=y_tile)
    host = TK.advect_fused(*fields, p, T=T, dt=DT, y_tile=y_tile,
                           tiling="host")
    assert bitwise(host, grid)
    *guarded, flags = TK.advect_fused(*fields, p, T=T, dt=DT, y_tile=y_tile,
                                      tiling="host", guard=True)
    assert bitwise(guarded, grid) and flags.tolist() == [1.0] * 6


@pytest.mark.parametrize("shape", [(5, 17, 12), (4, 16, 128), (7, 9, 64)])
def test_rungs_agree_bitwise(shape):
    """blocked == dataflow == wide: one function, three data movements."""
    fields = tfields(np_fields(shape, seed=4))
    p = tparams(JREF.default_params(shape[2]))
    for fuse in (False, True):
        outs = [rung(n)(*fields, p, fuse_update=fuse, dt=DT) for n in RUNGS]
        assert bitwise(outs[0], outs[1]) and bitwise(outs[1], outs[2])


# --- contracts ---------------------------------------------------------------

def test_wide_contract_errors():
    p = tparams(JREF.default_params(10))
    fields = tfields(np_fields((4, 8, 10)))
    with pytest.raises(ValueError, match="multiple of 16"):
        TK.advect_wide(*fields, p)
    assert TK.advect_dataflow(*fields, p)[0].shape == (4, 8, 10)
    p12 = tparams(JREF.default_params(12))
    n = 4 * 8 * 12
    offset = [torch.zeros(n + 1)[1:].view(4, 8, 12) for _ in range(3)]
    assert offset[0].is_contiguous() and offset[0].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        TK.advect_wide(*offset, p12)
    aligned = tfields(np_fields((4, 8, 12)))
    with pytest.raises(ValueError, match="in-grid"):
        TK.advect_wide(*aligned, p12, y_tile=4, tiling="host")
    # Z = 12 is refused by the TPU's Z % 128 rule, not by the card's
    assert bitwise(TK.advect_wide(*aligned, p12),
                   TK.advect_dataflow(*aligned, p12))


@pytest.mark.parametrize("name", RUNGS)
def test_rung_contract_errors(name):
    fields = tfields(np_fields((4, 8, 8)))
    p = tparams(JREF.default_params(8))
    fn = rung(name)
    with pytest.raises(ValueError):
        fn(*fields, p, y_tile=0)
    with pytest.raises(ValueError):
        fn(*fields, p, tiling="rows")
    with pytest.raises(ValueError):
        fn(*(f[None] for f in fields), p)
    with pytest.raises(TypeError, match="float32"):
        fn(*(f.double() for f in fields), p)
    with pytest.raises(ValueError, match="tcx"):
        fn(*fields, p._replace(tcx=torch.ones(1)))


@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow",
                                  "advect_wide"])
@pytest.mark.parametrize("y_tile", [None, 99])
def test_cuda_plan_fits_the_budget_the_old_slab_exceeded(name, y_tile,
                                                         monkeypatch):
    """Y = 1024 untiled at Z = 64 once needed a 2.4 MB slab and y_tile = 99
    one of 232,704 B, both refused. The CUDA route's plan runs them in
    tiles that fit one block's shared memory, at least two blocks an SM,
    and goes on to the build (here a loader that raises)."""
    plan = TK.rung_launch_plan(name, 3, 1024, 64, 132, 2, y_tile=y_tile)
    assert plan.shared_bytes <= 232448
    assert 2 * (plan.shared_bytes + 1024) <= 233472
    assert plan.TY * plan.n_ty >= 1024 and plan.TY <= 99

    def refuse():
        raise RuntimeError("kernel loader unavailable")

    monkeypatch.setattr(TK._build, "load", refuse)
    u, v, w = (torch.zeros((3, 1024, 64)) for _ in range(3))
    p = TK._slot_params(TREF.default_params(64, device="cpu"), None, 64,
                        "cpu")
    with pytest.raises(RuntimeError, match="kernel loader unavailable"):
        TK._advect_rung_cuda(name, u, v, w, p, y_tile, False, DT)


def test_largest_fitting_y_tile_of_the_rungs():
    assert TK.largest_fitting_y_tile(1, 1024, 64) == 64
    assert TK.fused_register_bytes(1, 1024, 64, 4, y_tile=64) == 152064
    assert TK.fused_register_bytes(1, 1024, 64, 4, y_tile=98) <= 232448
    assert TK.fused_register_bytes(1, 1024, 64, 4, y_tile=99) > 232448
    assert TK.largest_fitting_y_tile(1, 1021, 64) == 98     # 1021 is prime
    assert TK.largest_fitting_y_tile(1, 17, 12) is None     # whole Y fits


# --- byte models -------------------------------------------------------------

@pytest.mark.parametrize("fuse_update", [False, True])
@pytest.mark.parametrize("y_tile", [None, 8, 16])
@pytest.mark.parametrize("Z", [128, 256])
@pytest.mark.parametrize("T", [1, 2])
def test_wide_hbm_model_equals_jax_where_the_reference_runs(T, Z, y_tile,
                                                            fuse_update):
    kw = dict(T=T, y_tile=y_tile, fuse_update=fuse_update)
    assert TK.hbm_bytes_model(16, 64, Z, 4, "wide", **kw) == \
        JK.hbm_bytes_model(16, 64, Z, 4, "wide", **kw)
    assert TOPS.traffic_model((16, 64, Z), 4, "wide", **kw) == \
        JOPS.traffic_model((16, 64, Z), 4, "wide", **kw)


@pytest.mark.parametrize("Z", [4, 12, 64, 100])
def test_wide_hbm_model_is_dataflows_at_the_cards_alignment(Z):
    for kw in (dict(), dict(T=2, y_tile=5), dict(fuse_update=False)):
        assert TK.hbm_bytes_model(8, 33, Z, 4, "wide", **kw) == \
            TK.hbm_bytes_model(8, 33, Z, 4, "dataflow", **kw)


@pytest.mark.parametrize("y_tile", [None, 4, 8, 16, 100])
@pytest.mark.parametrize("T", [1, 2])
def test_wide_vmem_halo_equals_jax_dataflow(T, y_tile):
    """The card's wide streams a 1-row halo; the reference's wide counts
    its TPU 8-row sublane halo, so the pin is the reference's dataflow."""
    for X, Y, Z in ((16, 64, 128), (8, 33, 12)):
        assert TK.vmem_halo_bytes_model(X, Y, Z, 4, "wide", T=T,
                                        y_tile=y_tile) == \
            JK.vmem_halo_bytes_model(X, Y, Z, 4, "dataflow", T=T,
                                     y_tile=y_tile)
    with pytest.raises(ValueError, match="multiple of 16"):
        TK.vmem_halo_bytes_model(8, 33, 10, 4, "wide", T=T, y_tile=y_tile)


# --- the domain and ops defaults (the repaired fault) ------------------------

def test_domain_defaults_to_dataflow_like_the_reference():
    dom = TSA.AdvectionDomain(5, 9, 8, device="cpu")
    jdefault = {f.name: f.default for f in
                dataclasses.fields(JSA.AdvectionDomain)}["variant"]
    assert dom.variant == jdefault == "dataflow"
    assert dom.substeps_per_step() == 1
    jdom = JSA.AdvectionDomain(5, 9, 8)
    assert dom.flops_per_step() == jdom.flops_per_step()
    assert dom.vmem_register_bytes() == jdom.vmem_register_bytes()
    # the reference's byte model charges Z = 8 its TPU lane penalty; at a
    # lane-aligned Z the two defaults price the same rung alike
    assert TSA.AdvectionDomain(5, 9, 128, device="cpu").hbm_bytes_per_step() \
        == JSA.AdvectionDomain(5, 9, 128).hbm_bytes_per_step()
    out = dom.step(*dom.init())
    want = JREF.pw_step_ref(*JSA.stratus_fields(5, 9, 8), jdom.params, 1.0)
    assert max_diff(out, want) <= TOL


def test_ops_default_variant_is_dataflow_like_the_reference():
    assert inspect.signature(TOPS.pw_advect).parameters["variant"].default \
        == inspect.signature(JOPS.pw_advect).parameters["variant"].default \
        == "dataflow"
    fields = np_fields((5, 9, 8), seed=5)
    jp = JREF.default_params(8)
    got = TOPS.pw_advect(*tfields(fields), tparams(jp))
    assert bitwise(got, TOPS.pw_advect(*tfields(fields), tparams(jp),
                                       variant="dataflow"))
    assert max_diff(got, jax_ref(fields, jp, False)) <= TOL


DOMAIN_RUNS = [dict(variant=v, fuse_update=f, y_tile=y, tiling=t)
               for v in RUNGS for f in (False, True)
               for y, t in ((None, "grid"), (4, "grid"), (4, "host"))
               if not (v == "wide" and t == "host")]


@pytest.mark.parametrize("kw", DOMAIN_RUNS)
def test_domain_rung_steps_match_jax_reference(kw):
    dom = TSA.AdvectionDomain(5, 16, 8, dt=DT, device="cpu", **kw)
    fields = dom.init(seed=1)
    jdom = JSA.AdvectionDomain(5, 16, 8, dt=DT)
    jfields = jdom.init(seed=1)
    out = dom.step(*fields)
    assert max_diff(out, JREF.pw_step_ref(*jfields, jdom.params, DT)) <= TOL
    assert bitwise(dom.advance(*fields, 2), dom.step(*dom.step(*fields)))
    if kw["fuse_update"]:
        with pytest.raises(ValueError, match="fuse_update"):
            dom.sources(*fields)
    else:
        assert max_diff(dom.sources(*fields),
                        JREF.pw_advect_ref(*jfields, jdom.params)) <= TOL


# --- against the JAX ladder kernels (interpret mode) -------------------------

@needs_unblocked
@pytest.mark.parametrize("fuse_update", [False, True])
@pytest.mark.parametrize("y_tile,tiling", [(None, "grid"), (4, "grid"),
                                           (3, "host")])
@pytest.mark.parametrize("name", ["blocked", "dataflow"])
def test_rung_matches_jax_kernel(name, y_tile, tiling, fuse_update):
    shape = (5, 17, 12)
    fields = np_fields(shape, seed=6)
    jp = JREF.default_params(12)
    kw = dict(y_tile=y_tile, tiling=tiling, fuse_update=fuse_update, dt=DT)
    want = getattr(JK, f"advect_{name}")(*(jnp.asarray(f) for f in fields),
                                         jp, **kw)
    got = rung(name)(*tfields(fields), tparams(jp), **kw)
    assert max_diff(got, want) <= TOL


@needs_unblocked
@pytest.mark.parametrize("fuse_update", [False, True])
@pytest.mark.parametrize("y_tile", [None, 8])
def test_wide_matches_jax_kernel(y_tile, fuse_update):
    shape = (4, 16, 128)
    fields = np_fields(shape, seed=7)
    jp = JREF.default_params(128)
    kw = dict(y_tile=y_tile, fuse_update=fuse_update, dt=DT)
    want = JK.advect_wide(*(jnp.asarray(f) for f in fields), jp, **kw)
    got = TK.advect_wide(*tfields(fields), tparams(jp), **kw)
    assert max_diff(got, want) <= TOL


@needs_unblocked
def test_fused_host_tiling_matches_jax_kernel():
    fields = np_fields((5, 17, 12), seed=8)
    jp = JREF.default_params(12)
    want = JK.advect_fused(*(jnp.asarray(f) for f in fields), jp, T=2, dt=DT,
                           y_tile=5, tiling="host")
    got = TK.advect_fused(*tfields(fields), tparams(jp), T=2, dt=DT,
                          y_tile=5, tiling="host")
    assert max_diff(got, want) <= 1e-5   # the fused tests' JAX-kernel bound


@needs_unblocked
def test_domain_default_step_matches_jax_domain():
    dom = TSA.AdvectionDomain(5, 9, 8, device="cpu")
    jdom = JSA.AdvectionDomain(5, 9, 8)
    assert max_diff(dom.step(*dom.init()), jdom.step(*jdom.init())) <= TOL


@needs_unblocked
def test_ops_default_matches_jax_ops_default():
    fields = np_fields((5, 9, 8), seed=9)
    jp = JREF.default_params(8)
    want = JOPS.pw_advect(*(jnp.asarray(f) for f in fields), jp)
    got = TOPS.pw_advect(*tfields(fields), tparams(jp))
    assert max_diff(got, want) <= TOL
