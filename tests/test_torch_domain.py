"""The port's domain, ops wrappers and models (`repro_torch.stencil.
advection`, `kernels.advection.ops`, the byte models and `core.roofline`)
against the JAX reference, on the same inputs."""
import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import roofline as JR
from repro.kernels.advection import advection as JK
from repro.kernels.advection import ops as JOPS
from repro.kernels.advection import ref as JREF
from repro.stencil import advection as JSA
from repro_torch.core import roofline as TR
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ops as TOPS
from repro_torch.kernels.advection import ref as TREF
from repro_torch.stencil import advection as TSA

DT = 0.01

# the reference's pins (tests/test_seed_determinism.py), shape (8, 10, 8)
PINNED = {
    "u": "195d0ce8471c66833b113445574b08d05b053fd7410e0a1f75e4badee85cb349",
    "v": "51a5d1872a214ab1ab5170b406f91e67f12a9e8acaaf37a608ede91fcb6441b5",
    "w": "a56ca1671aa89d367ab70e0b12a0c1f03c67d80633f74cff11df93d0da6a8b37",
}


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


# --- stratus_fields ---------------------------------------------------------

def test_stratus_fields_content_pinned():
    fields = TSA.stratus_fields(8, 10, 8, device="cpu")
    for name, f in zip("uvw", fields):
        got = hashlib.sha256(f.numpy().tobytes()).hexdigest()
        assert got == PINNED[name], name


@pytest.mark.parametrize("shape,seed", [((5, 9, 8), 0), ((16, 24, 64), 3)])
def test_stratus_fields_byte_identical_to_jax(shape, seed):
    want = JSA.stratus_fields(*shape, seed=seed)
    got = TSA.stratus_fields(*shape, seed=seed, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_paper_grids_equal():
    assert TSA.PAPER_GRIDS == JSA.PAPER_GRIDS


# --- AdvectionDomain --------------------------------------------------------

def test_domain_fused_step_and_advance():
    dom = TSA.AdvectionDomain(5, 8, 8, variant="fused", fuse_T=2, dt=DT,
                              device="cpu")
    u, v, w = dom.init()
    jdom = JSA.AdvectionDomain(5, 8, 8, variant="fused", fuse_T=2, dt=DT)
    ju, jv, jw = jdom.init()
    ref = (ju, jv, jw)
    for _ in range(2):
        ref = JREF.pw_step_ref(*ref, jdom.params, DT)
    out = dom.step(u, v, w)
    assert max_diff(out, ref) < 1e-6
    ru, rv, rw = u, v, w
    for _ in range(2):
        ru, rv, rw = TREF.pw_step_ref(ru, rv, rw, dom.params, DT)
    assert all(torch.equal(a, b) for a, b in zip(out, (ru, rv, rw)))
    assert dom.substeps_per_step() == 2
    out4 = dom.advance(u, v, w, 4)
    assert out4[0].shape == u.shape
    assert all(torch.equal(a, b) for a, b in
               zip(out4, dom.step(*dom.step(u, v, w))))
    with pytest.raises(ValueError):
        dom.advance(u, v, w, 3)     # not a multiple of fuse_T
    with pytest.raises(ValueError):
        dom.step(u, v, w, dt=0.5)   # fused bakes dt in
    with pytest.raises(ValueError):
        dom.sources(u, v, w)


@pytest.mark.parametrize("fuse_update", [False, True])
def test_domain_reference_step_matches_jax(fuse_update):
    kw = dict(variant="reference", dt=DT, fuse_update=fuse_update)
    dom = TSA.AdvectionDomain(6, 10, 12, device="cpu", **kw)
    jdom = JSA.AdvectionDomain(6, 10, 12, **kw)
    out = dom.step(*dom.init(seed=2))
    want = jdom.step(*jdom.init(seed=2))
    assert max_diff(out, want) <= 1e-6
    if not fuse_update:
        assert max_diff(dom.sources(*dom.init(seed=2)),
                        jdom.sources(*jdom.init(seed=2))) <= 1e-6


def test_domain_contract_errors():
    for variant in ("blocked", "dataflow", "wide"):
        dom = TSA.AdvectionDomain(5, 8, 8, variant=variant, device="cpu")
        assert dom.substeps_per_step() == 1
        with pytest.raises(ValueError, match="bakes dt in"):
            dataclasses.replace(dom, fuse_update=True).step(
                *dom.init(), dt=0.5)
    with pytest.raises(ValueError):
        TSA.AdvectionDomain(5, 8, 8, variant="nope", device="cpu")
    with pytest.raises(ValueError):
        TSA.AdvectionDomain(5, 8, 8, tiling="rows", device="cpu")
    assert TSA.AdvectionDomain(5, 8, 8, tiling="host", device="cpu").tiling \
        == "host"
    # bf16 is ported (its coefficients in the domain's dtype); other
    # dtypes are refused, naming the ones there are
    assert TSA.AdvectionDomain(5, 8, 8, dtype="bfloat16",
                               device="cpu").params.tzc1.dtype \
        == torch.bfloat16
    with pytest.raises(NotImplementedError, match="bfloat16"):
        TSA.AdvectionDomain(5, 8, 8, dtype="float16", device="cpu")
    with pytest.raises(ValueError):
        TSA.AdvectionDomain(5, 8, 8, y_tile=0, device="cpu")
    with pytest.raises(ValueError):
        TSA.AdvectionDomain(5, 8, 8, variant="reference",
                            device="cpu").guard_bytes_per_step()


def test_domain_runs_given_tile_and_untiled_on_cpu():
    dom = TSA.AdvectionDomain(5, 17, 8, variant="fused", fuse_T=2, y_tile=5,
                              dt=DT, device="cpu")
    assert dom.run_y_tile == 5
    untiled = TSA.AdvectionDomain(5, 17, 8, variant="fused", fuse_T=2, dt=DT,
                                  device="cpu")
    assert untiled.run_y_tile is None
    fields = dom.init()
    assert all(torch.equal(a, b) for a, b in
               zip(dom.step(*fields), untiled.step(*fields)))


DOMAIN_CASES = [
    dict(variant="fused", fuse_T=4),
    dict(variant="fused", fuse_T=2, y_tile=8),
    dict(variant="fused", fuse_T=4, y_tile=16),
    dict(variant="reference"),
    dict(variant="reference", fuse_update=True),
    dict(variant="blocked"),
    dict(variant="blocked", y_tile=16, fuse_update=True),
    dict(variant="dataflow"),
    dict(variant="dataflow", y_tile=8),
    dict(variant="dataflow", y_tile=16, tiling="host", fuse_update=True),
    dict(variant="blocked", y_tile=8, tiling="host"),
    dict(variant="fused", fuse_T=2, y_tile=8, tiling="host"),
]


@pytest.mark.parametrize("kw", DOMAIN_CASES)
@pytest.mark.parametrize("shape", [(16, 64, 128), (12, 40, 256)])
def test_domain_accounting_equals_jax(kw, shape):
    dom = TSA.AdvectionDomain(*shape, device="cpu", **kw)
    jdom = JSA.AdvectionDomain(*shape, **kw)
    assert dom.flops_per_step() == jdom.flops_per_step()
    assert dom.hbm_bytes_per_step() == jdom.hbm_bytes_per_step()
    assert dom.vmem_halo_bytes_per_step() == jdom.vmem_halo_bytes_per_step()
    assert dom.vmem_register_bytes() == jdom.vmem_register_bytes()
    if kw["variant"] == "fused":
        assert dom.guard_bytes_per_step() == jdom.guard_bytes_per_step()


# --- ops --------------------------------------------------------------------

def test_ops_wrappers_match_jax():
    rng = np.random.default_rng(4)
    fields = [rng.normal(size=(5, 8, 8)).astype(np.float32)
              for _ in range(3)]
    jp = JREF.default_params(8)
    tf = TREF.fields_from_numpy(*fields, device="cpu")
    tp = TREF.params_from_numpy(jp, device="cpu")
    jf = [jnp.asarray(f) for f in fields]
    for fuse in (False, True):
        got = TOPS.pw_advect(*tf, tp, variant="reference", fuse_update=fuse,
                             dt=DT)
        want = JOPS.pw_advect(*jf, jp, variant="reference", fuse_update=fuse,
                              dt=DT)
        assert max_diff(got, want) <= 1e-6
    fused = TOPS.pw_advect_fused(*tf, tp, T=2, dt=DT)
    assert all(torch.equal(a, b) for a, b in
               zip(fused, TK.advect_fused(*tf, tp, T=2, dt=DT)))
    with pytest.raises(ValueError):
        TOPS.pw_advect(*tf, tp, variant="fused")
    for rung in ("blocked", "dataflow", "wide"):
        for fuse in (False, True):
            got = TOPS.pw_advect(*tf, tp, variant=rung, fuse_update=fuse,
                                 dt=DT)
            want = JOPS.pw_advect(*jf, jp, variant="reference",
                                  fuse_update=fuse, dt=DT)
            assert max_diff(got, want) <= 1e-6, (rung, fuse)


@pytest.mark.parametrize("variant", ["reference", "blocked", "dataflow",
                                     "fused"])
@pytest.mark.parametrize("T", [1, 4])
def test_traffic_model_equals_jax_lane_aligned(variant, T):
    for kw in (dict(), dict(y_tile=16, grid_tiled=False),
               dict(fuse_update=False)):
        assert TOPS.traffic_model((32, 64, 128), 4, variant, T=T, **kw) == \
            JOPS.traffic_model((32, 64, 128), 4, variant, T=T, **kw)


# --- byte models --------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 2, 4, 8])
@pytest.mark.parametrize("Y,Z", [(1024, 64), (17, 12), (65536, 64)])
@pytest.mark.parametrize("y_tile", [None, 5, 16, 128])
def test_fused_register_bytes_equals_jax(T, Y, Z, y_tile):
    for itemsize in (2, 4):
        assert TK.fused_register_bytes(T, Y, Z, itemsize, y_tile) == \
            JK.fused_register_bytes(T, Y, Z, itemsize, y_tile)


@pytest.mark.parametrize("variant", ["pointwise", "blocked", "dataflow",
                                     "fused"])
@pytest.mark.parametrize("y_tile", [None, 4, 16, 100])
def test_vmem_halo_bytes_model_equals_jax(variant, y_tile):
    for T in (1, 2, 4):
        for X, Y, Z in ((16, 64, 128), (8, 33, 10)):
            assert TK.vmem_halo_bytes_model(X, Y, Z, 4, variant, T=T,
                                            y_tile=y_tile) == \
                JK.vmem_halo_bytes_model(X, Y, Z, 4, variant, T=T,
                                         y_tile=y_tile)


@pytest.mark.parametrize("variant", ["pointwise", "blocked", "dataflow",
                                     "fused"])
@pytest.mark.parametrize("Z", [128, 256, 64, 100, 12, 10])
def test_hbm_bytes_model_against_jax(variant, Z):
    """Equal to the reference where Z is lane-aligned (Z % 128 == 0).
    Elsewhere the TPU lane penalty is gone: a row of Z*4 bytes costs
    nothing extra when it is a multiple of 16 bytes and is otherwise
    charged padded up to 16 bytes, so the port is the reference times the
    lane efficiency, times padded over unpadded row bytes."""
    lane_eff = 1.0 if Z % 128 == 0 else (Z % 128) / 128.0
    pad = (-(-Z * 4 // 16) * 16) / (Z * 4)
    for T in (1, 2, 4):
        for kw in (dict(), dict(y_tile=16, grid_tiled=False)):
            got = TK.hbm_bytes_model(32, 64, Z, 4, variant, T=T, **kw)
            want = JK.hbm_bytes_model(32, 64, Z, 4, variant, T=T, **kw)
            if Z % 128 == 0:
                assert got == want
            else:
                assert got == pytest.approx(want * lane_eff * pad, rel=1e-9)
    if variant != "fused" and Z % 128 == 0:
        assert TK.hbm_bytes_model(32, 64, Z, 4, variant, T=2,
                                  fuse_update=False) == \
            JK.hbm_bytes_model(32, 64, Z, 4, variant, T=2, fuse_update=False)


def test_byte_models_refuse_the_unported_wide_rung():
    """`wide` is ported: the models price it where `advect_wide` runs and
    refuse it only where the rung itself refuses to run."""
    assert TK.hbm_bytes_model(8, 16, 128, 4, "wide") == \
        JK.hbm_bytes_model(8, 16, 128, 4, "wide")
    assert TK.vmem_halo_bytes_model(8, 16, 128, 4, "wide", y_tile=8) == \
        JK.vmem_halo_bytes_model(8, 16, 128, 4, "dataflow", y_tile=8)
    with pytest.raises(ValueError, match="16"):
        TK.hbm_bytes_model(8, 16, 10, 4, "wide")
    with pytest.raises(ValueError, match="in-grid"):
        TK.hbm_bytes_model(8, 16, 128, 4, "wide", y_tile=8, grid_tiled=False)
    with pytest.raises(ValueError):
        TK.hbm_bytes_model(8, 16, 128, 4, "nope")


@pytest.mark.parametrize("shape", [(8, 10, 8), (1024, 1024, 64)])
@pytest.mark.parametrize("batch", [1, 3])
def test_guard_bytes_model_equals_jax(shape, batch):
    assert TR.guard_bytes_model(*shape, batch=batch) == \
        JR.guard_bytes_model(*shape, batch=batch)
    assert TR.guard_bytes_model_parts(*shape, batch=batch) == \
        JR.guard_bytes_model_parts(*shape, batch=batch)
    assert sum(TR.guard_bytes_model_parts(*shape, batch=batch).values()) == \
        TR.guard_bytes_model(*shape, batch=batch)
    with pytest.raises(ValueError):
        TR.guard_bytes_model(*shape, batch=0)


# --- roofline -----------------------------------------------------------------

def test_h100_constants_from_the_data_sheet():
    assert TR.HBM_BW == 3.35e12
    assert TR.PEAK_FLOPS_BF16 == 989e12
    assert TR.PEAK_FLOPS_F32 == 67e12
    assert TR.PEAK_FLOPS_BF16_SIMT == 133.8e12
    assert TR.HBM_PER_CHIP == 80 * 10**9
    assert TR.SMEM_PER_BLOCK == 232_448


@pytest.mark.parametrize("flops", [3.2e9, 1.6e10, 6.4e13])
def test_roofline_terms_algebra_equals_jax(flops):
    """The single-device terms equal the reference's on one chip with no
    wire bytes, memory-bound and compute-bound alike. The wire inputs are
    the port's own (NVLink or loopback bytes and rate, and the cross-pod
    bytes and rate, where the reference has ICI and DCN); every other key
    is the reference's, at its value."""
    kw = dict(flops_per_dev=flops, hbm_bytes_per_dev=1.6e9,
              model_flops_global=0.8 * flops, peak_flops=67e12,
              hbm_bw=3.35e12)
    got = TR.RooflineTerms(**kw).as_dict()
    want = JR.RooflineTerms(**kw, ici_wire_bytes=0.0, dcn_wire_bytes=0.0,
                            n_chips=1).as_dict()
    assert set(got) - set(want) == {"wire_bytes", "wire_bw",
                                    "cross_wire_bytes", "cross_wire_bw"}
    assert {k: got[k] for k in got if k in want} == \
        {k: want[k] for k in got if k in want}
    assert TR.RooflineTerms(**kw).bound == ("compute" if flops == 6.4e13
                                           else "memory")


def test_stencil_intensity_and_ridge_equal_jax():
    for T in (1, 2, 4, 8):
        assert TR.stencil_arithmetic_intensity(63, 24, T) == \
            JR.stencil_arithmetic_intensity(63, 24, T)
    assert TR.stencil_ridge_T(63, 24, peak_flops=67e12, hbm_bw=3.35e12) == \
        JR.stencil_ridge_T(63, 24, peak_flops=67e12, hbm_bw=3.35e12)
    # on the card's f32 rate the fused PW stencil needs T = 8 to leave the
    # memory-bound regime (ridge 20 FLOP/B; 63 FLOP per 24 B at T = 1)
    assert TR.stencil_ridge_T(63, 24) == 8
    with pytest.raises(ValueError):
        TR.stencil_arithmetic_intensity(63, 24, 0)
