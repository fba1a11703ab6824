"""The port's bf16 PW path (`repro_torch.kernels.advection` on bf16 fields,
`AdvectionDomain(dtype="bfloat16")`, the bf16 stencil serving tier and
bf16 checkpoint leaves) against the JAX package, on the same numpy inputs.

On the CPU the kernel wrappers run their plain versions, written op for op
in torch bf16 at the reference's rounding points (JAX's promotion: a bf16
op rounds to bf16; a product with an f32 coefficient is an f32 op; the
source is rounded to the field's dtype before the update). Tolerances:

* against JAX's bf16 ops, at most `JAX_ULPS` bf16 ulps: XLA on the CPU may
  keep excess precision between bf16 ops, where the port rounds each one;
  one such op moves one rounding by at most one ulp, and the stencil
  carries a changed input into later steps, so the bound is one ulp a step
  of the longest run here (4 steps);
* against the f32 oracle, the reference's own 0.15 on the sources
  (tests/test_advection_kernels.py:36);
* against the f64 oracle over n steps, 1.1 x n x 2^-8 x max |f|
  (`bf16_bound`): each step's update rounds once to bf16, at most 2^-8 of
  the field's magnitude; the source's own roundings enter scaled by dt, and
  the stencil carries earlier errors by a factor under 1.1 here.
* against the f64 oracle cell by cell, `pw_multistep_bf16_bound`'s bound,
  derived in its docstring from bf16's unit roundoff, at the paper's dt
  and at `RESOLVED_DT`, where most updates do not round away.

The bitwise contracts of the reference's bf16 tests hold within the port:
grid == untiled (the plain version on each block a plan launches,
restitched), batched == sequential, guarded == unguarded, T beyond a pass
as passes, disk rollback == clean."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels.advection import advection as JK
from repro.kernels.advection import ref as JREF
from repro.serving import stencil_engine as JE
from repro.stencil import advection as JSA
from repro.training import checkpoint as JC
from repro_torch.analysis import programs as PR
from repro_torch.analysis import smem as SM
from repro_torch.analysis import trace as TRC
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF
from repro_torch.serving import stencil_engine as TE
from repro_torch.stencil import advection as TSA
from repro_torch.training import checkpoint as TC
from test_torch_fused_plan import blocks_restitched as k1_blocks
from test_torch_rung_plan import blocks_restitched as rung_blocks

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
DT = 0.01
RESOLVED_DT = 0.5     # most updates exceed half a bf16 ulp of their cell
H100_SMS = 132
U = 2.0 ** -8          # bf16's unit roundoff
JAX_ULPS = 4           # one ulp a step of the longest run (4 steps)
F32_SOURCE_TOL = 0.15  # tests/test_advection_kernels.py:36
needs_unblocked = pytest.mark.skipif(
    not hasattr(pl, "Unblocked"), reason="the installed Pallas has no "
    "pl.Unblocked, which the JAX advection kernels need (jax 0.4.x has it)")


# -- helpers ----------------------------------------------------------------

def np_fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def tb(fields):
    """numpy fields -> bf16 tensors on the CPU (rounded to nearest even)."""
    return list(TREF.fields_from_numpy(*fields, dtype=BF16, device="cpu"))


def jb(fields):
    return [jnp.asarray(f, jnp.bfloat16) for f in fields]


def params(Z, coef):
    """The coefficients in f32 (the kernel tests') or bf16 (a bf16
    domain's), both packages' from the same numbers."""
    dt = jnp.float32 if coef == "f32" else jnp.bfloat16
    jp = JREF.default_params(Z, dtype=dt)
    tp = TREF.params_from_numpy(jp, dtype=torch.float32 if coef == "f32"
                                else BF16, device="cpu")
    return jp, tp


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def ulps(a, b) -> int:
    """The largest distance in bf16 ulps between two arrays of bf16 values
    (their order as integers along the number line), printed (`-s`)."""
    ia = f32(a).view(np.int32) >> 16
    ib = f32(b).view(np.int32) >> 16
    oa = np.where(ia < 0, -(ia & 0x7FFF), ia)
    ob = np.where(ib < 0, -(ib & 0x7FFF), ib)
    n = int(np.abs(oa.astype(np.int64) - ob).max())
    print(f"largest difference: {n} bf16 ulps")
    return n


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def jax_kernel_loop(fields, jp, T, xm=None, ym=None):
    """The reference kernel's masked Euler loop in the fields' dtype
    (`_kernel_fused`): ``cen + dt * where(interior, src, 0).astype(cen)``."""
    X, Y, _ = fields[0].shape
    xm = np.ones(X, np.float32) if xm is None else xm
    ym = np.ones(Y, np.float32) if ym is None else ym
    m = (jnp.asarray(xm)[:, None, None] > 0) & (jnp.asarray(ym)[None, :, None]
                                                > 0)
    fs = list(fields)
    for _ in range(T):
        srcs = JREF.pw_advect_ref(*fs, jp)
        fs = [f + DT * jnp.where(m, s, 0.0).astype(f.dtype)
              for f, s in zip(fs, srcs)]
    return fs


def bf16_bound(oracle, n: int) -> float:
    """1.1 x n x 2^-8 x max |f| (the module docstring)."""
    return 1.1 * n * U * max(float(torch.as_tensor(o).abs().max())
                             for o in oracle)


# -- the plain versions against JAX -------------------------------------------

@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 17, 12), (6, 16, 32)])
def test_pw_advect_ref_bf16_equals_jax(shape, coef):
    fields = np_fields(shape, seed=1)
    jp, tp = params(shape[2], coef)
    want = JREF.pw_advect_ref(*jb(fields), jp)
    got = TREF.pw_advect_ref(*tb(fields), tp)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert ulps(g.to(BF16), jnp.asarray(w).astype(jnp.bfloat16)) \
            <= JAX_ULPS


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("shape", [(5, 17, 12), (6, 16, 32)])
def test_fused_plain_bf16_equals_jax_kernel_loop(shape, T, coef):
    fields = np_fields(shape, seed=T)
    jp, tp = params(shape[2], coef)
    X, Y, _ = shape
    xm = np.ones(X, np.float32)
    xm[1] = 0.0
    ym = np.ones(Y, np.float32)
    ym[Y // 2:] = 0.0
    want = jax_kernel_loop(jb(fields), jp, T, xm, ym)
    got = TK.advect_fused(*tb(fields), tp, T=T, dt=DT,
                          x_interior_mask=xm, y_interior_mask=ym)
    for g, w in zip(got, want):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        assert ulps(g, w) <= JAX_ULPS


@pytest.mark.parametrize("variant,fuse_update", [
    ("reference", False), ("reference", True), ("blocked", False),
    ("blocked", True), ("dataflow", False), ("dataflow", True),
    ("wide", False), ("wide", True), ("fused", False)])
def test_bf16_domain_advance_equals_jax_reference_domain(variant,
                                                         fuse_update):
    """Every rung of a bf16 domain (the port's plain versions) against the
    JAX domain's pure-jnp `reference` rung in bf16, 4 Euler substeps: bf16
    coefficients, every op a bf16 op (`fused` advances in the kernel)."""
    X, Y, Z = 6, 16, 32
    tdom = TSA.AdvectionDomain(X, Y, Z, variant=variant, dtype="bfloat16",
                               device="cpu", fuse_update=fuse_update,
                               dt=0.3, fuse_T=2)
    jdom = JSA.AdvectionDomain(X, Y, Z, variant="reference",
                               dtype="bfloat16", fuse_update=fuse_update,
                               dt=0.3)
    got = tdom.advance(*tdom.init(seed=2), 4)
    want = jdom.advance(*jdom.init(seed=2), 4)
    for g, w in zip(got, want):
        assert g.dtype == BF16
        assert ulps(g, w) <= JAX_ULPS


@needs_unblocked
@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_bf16_plain_versions_equal_jax_pallas_kernels(coef):
    """The JAX Pallas kernels in interpret mode on bf16 fields."""
    shape = (5, 17, 16)
    fields = np_fields(shape, seed=3)
    jp, tp = params(shape[2], coef)
    for T in (1, 2, 4):
        got = TK.advect_fused(*tb(fields), tp, T=T, dt=DT)
        want = JK.advect_fused(*jb(fields), jp, T=T, dt=DT, interpret=True)
        assert all(ulps(g, w) <= JAX_ULPS for g, w in zip(got, want))
    for name in ("advect_blocked", "advect_dataflow"):
        for fu in (False, True):
            got = getattr(TK, name)(*tb(fields), tp, fuse_update=fu, dt=DT)
            want = getattr(JK, name)(*jb(fields), jp, fuse_update=fu, dt=DT,
                                     interpret=True)
            assert all(ulps(g, w) <= JAX_ULPS for g, w in zip(got, want))


@pytest.mark.parametrize("variant", ["blocked", "dataflow", "wide"])
def test_bf16_sources_within_the_references_f32_tolerance(variant):
    """tests/test_advection_kernels.py:36 on the port: bf16 sources (f32
    coefficients) within 0.15 of the f32 oracle on the bf16 inputs."""
    shape = (6, 16, 32)
    fields = tb(np_fields(shape, seed=4))
    _, tp = params(32, "f32")
    want = TREF.pw_advect_ref(*(f.float() for f in fields), tp)
    got = getattr(TK, f"advect_{variant}")(*fields, tp)
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    assert all(g.dtype == BF16 for g in got) and err < F32_SOURCE_TOL


@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_bf16_multistep_within_the_f64_oracle_bound(coef):
    shape, n = (8, 16, 16), 16
    fields = tb(np_fields(shape, seed=5))
    _, tp = params(16, coef)
    got = TK.advect_fused(*fields, tp, T=4, dt=DT)
    for _ in range(n // 4 - 1):
        got = TK.advect_fused(*got, tp, T=4, dt=DT)
    oracle = TREF.pw_multistep_ref_f64(*fields, tp, n, DT)
    err = max(float((g.double() - o).abs().max())
              for g, o in zip(got, oracle))
    moved = max(float((f.double() - o).abs().max())
                for f, o in zip(fields, oracle))
    assert 0.0 < err <= bf16_bound(oracle, n) and moved > 0.0


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("dt,n", [(DT, 16), (RESOLVED_DT, 4)])
def test_bf16_multistep_within_the_per_cell_f64_bound(coef, dt, n):
    """Every cell within `pw_multistep_bf16_bound`'s derived bound (its
    docstring), which a no-op (the inputs returned) and a run without the
    source's z terms each break."""
    shape = (8, 16, 16)
    fields = tb(np_fields(shape, seed=5))
    _, tp = params(16, coef)

    def run(p):
        out = fields
        for _ in range(n // 4):
            out = TK.advect_fused(*out, p, T=4, dt=dt)
        return out

    oracle, bounds = TREF.pw_multistep_bf16_bound(*fields, tp, n, dt)
    assert bitwise(oracle, TREF.pw_multistep_ref_f64(*fields, tp, n, dt))

    def over(got):
        return sum(int(((g.double() - o).abs() > b).sum())
                   for g, o, b in zip(got, oracle, bounds))

    no_z = TREF.AdvectParams(tp.tcx, tp.tcy, torch.zeros_like(tp.tzc1),
                             torch.zeros_like(tp.tzc2))
    assert over(run(tp)) == 0
    assert over(fields) > 0 and over(run(no_z)) > 0


# -- bitwise contracts within the port, in bf16 -------------------------------

@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("T,y_tile", [(1, 4), (2, 5), (2, 7), (4, 3)])
def test_k1_grid_tiled_blocks_equal_untiled_bf16(T, y_tile, coef):
    shape = (5, 17, 12)
    X, Y, Z = shape
    u, v, w = tb(np_fields(shape, seed=12))
    _, tp = params(Z, coef)
    xm, ym = torch.ones(X), torch.ones(Y)
    plan = TK.fused_plan_with_chunks(
        TK.fused_launch_plan(X, Y, Z, T, 1, H100_SMS, 1, y_tile=y_tile), X,
        Z, T, CX=2)
    got = k1_blocks(u, v, w, tp, T, DT, xm, ym, plan)
    want = TK._advect_fused_plain(u[None], v[None], w[None], tp, T, DT, xm,
                                  ym)
    assert plan.n_ty > 1 and all(torch.equal(a, b[0])
                                 for a, b in zip(got, want))
    host = TK.advect_fused(u, v, w, tp, T=T, dt=DT, y_tile=y_tile,
                           tiling="host")
    assert bitwise(host, (b[0] for b in want))


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("y_tile", [3, 4, 5])
@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow",
                                  "advect_wide"])
def test_rung_grid_tiled_blocks_equal_untiled_bf16(name, y_tile, fuse, coef):
    shape = (5, 14, 16)
    X, Y, Z = shape
    u, v, w = tb(np_fields(shape, seed=11))
    _, tp = params(Z, coef)
    plan = TK.rung_launch_plan(name, X, Y, Z, H100_SMS, 2, y_tile=y_tile,
                               x_chunk=2, itemsize=2)
    got = rung_blocks(name, u, v, w, tp, fuse, plan)
    want = TK._advect_rung_plain(u, v, w, tp, fuse, 0.01)
    assert plan.n_ty > 1 and bitwise(got, want)
    assert all(g.dtype == BF16 for g in got)
    if name != "advect_wide":
        host = getattr(TK, name)(u, v, w, tp, y_tile=y_tile, tiling="host",
                                 fuse_update=fuse, dt=0.01)
        assert bitwise(host, want)


@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_bf16_batched_equals_sequential(coef):
    B, X, Y, Z, T = 3, 5, 17, 12, 2
    slots = [tb(np_fields((X, Y, Z), seed=20 + b)) for b in range(B)]
    u, v, w = (torch.stack([s[i] for s in slots]) for i in range(3))
    _, base = params(Z, coef)
    scale = torch.tensor([1.0, 1.5, 0.5], dtype=base.tcx.dtype)
    p = TREF.AdvectParams(base.tcx * scale, base.tcy * scale,
                          base.tzc1[None] * scale[:, None], base.tzc2)
    xm, ym = torch.ones(B, X), torch.ones(B, Y)
    xm[1, 2] = 0.0
    ym[0, 5:9] = 0.0
    out = TK.advect_fused_batched(u, v, w, p, T=T, dt=DT, x_interior_mask=xm,
                                  y_interior_mask=ym, y_tile=5)
    for b in range(B):
        pb = TREF.AdvectParams(p.tcx[b], p.tcy[b], p.tzc1[b], p.tzc2)
        seq = TK.advect_fused(u[b], v[b], w[b], pb, T=T, dt=DT,
                              x_interior_mask=xm[b], y_interior_mask=ym[b])
        assert bitwise([o[b] for o in out], seq)


def test_bf16_guarded_equals_unguarded_and_guard_flags():
    shape = (8, 16, 64)
    u, v, w = tb(np_fields(shape, seed=40))
    _, tp = params(64, "bf16")
    plain = TK.advect_fused(u, v, w, tp, T=2, dt=DT)
    gu, gv, gw, flags = TK.advect_fused(u, v, w, tp, T=2, dt=DT, guard=True)
    assert bitwise((gu, gv, gw), plain)
    assert flags.dtype == torch.float32 and bool((flags == 1.0).all())
    bad = [f.clone() for f in (u, v, w)]
    bad[0][2, 3, 5] = float("nan")
    bad[2][5, 0, 0] = float("inf")
    got = TK.finite_guard(*bad)
    want = JK.finite_guard(*(jnp.asarray(f32(f), jnp.bfloat16) for f in bad))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("coef", ["f32", "bf16"])
def test_bf16_deep_t_as_passes_equals_the_plain_loop(coef):
    shape = (5, 17, 12)
    X, Y, Z = shape
    u, v, w = tb(np_fields(shape, seed=9))
    _, tp = params(Z, coef)
    got = TK.advect_fused(u, v, w, tp, T=10, dt=DT, y_tile=5)
    want = TK._advect_fused_plain(u[None], v[None], w[None],
                                  TK._slot_params(tp, 1, Z, "cpu"), 10, DT,
                                  torch.ones(X), torch.ones(Y))
    assert TK.fused_passes(10) == [5, 5]
    assert bitwise(got, (o[0] for o in want))


# -- the domain -----------------------------------------------------------------

def test_bf16_init_and_params_equal_the_references_bitwise():
    tdom = TSA.AdvectionDomain(64, 64, 64, variant="fused", dtype="bfloat16",
                               device="cpu")
    jdom = JSA.AdvectionDomain(64, 64, 64, variant="fused", dtype="bfloat16")
    for g, w in zip(tdom.init(seed=0), jdom.init(seed=0)):
        assert g.dtype == BF16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    for g, w in zip(tdom.params, jdom.params):
        assert g.dtype == BF16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    assert tdom.itemsize == 2
    f32dom = TSA.AdvectionDomain(64, 64, 64, variant="fused", device="cpu")
    assert 2 * tdom.hbm_bytes_per_step() == f32dom.hbm_bytes_per_step()
    # K4 reads 2-byte cells and writes f32 flags (the reference's model
    # prices 4-byte cells whatever the dtype)
    assert tdom.guard_bytes_per_step() == 3 * 64 ** 3 * 2 + 64 * 4


def test_bf16_coefficients_make_a_different_result_than_f32_ones():
    """The reference builds a bf16 domain's coefficients in bf16; with f32
    coefficients the products round elsewhere, so the two differ."""
    dom = TSA.AdvectionDomain(6, 16, 32, variant="fused", dtype="bfloat16",
                              device="cpu", dt=0.3)
    fields = dom.init(seed=1)
    got = dom.advance(*fields, 8)
    f32p = TREF.default_params(32, device="cpu")
    other = TK.advect_fused(*fields, f32p, T=4, dt=0.3)
    other = TK.advect_fused(*other, f32p, T=4, dt=0.3)
    assert not bitwise(got, other)


# -- the serving tier -----------------------------------------------------------

def _jax_batched(u, v, w, p, *, T, dt, y_tile=None, tiling="grid",
                 y_interior_mask=None, x_interior_mask=None, guard=False,
                 interpret=True):
    """`advect_fused_batched` as the reference kernel computes it (the
    masked ring loop in the fields' dtype), for the JAX engine on a Pallas
    without `pl.Unblocked`."""
    del y_tile, tiling, interpret
    B, X, Y, _ = u.shape
    j = jnp.arange(X)
    m = (((j >= 1) & (j <= X - 2))[None, :] & (x_interior_mask > 0)
         )[:, :, None, None] & (y_interior_mask > 0)[:, None, :, None]
    fs = [u, v, w]
    for _ in range(T):
        out = [[], [], []]
        for b in range(B):
            pb = JREF.AdvectParams(*(leaf[b] for leaf in p))
            for i, s in enumerate(JREF.pw_advect_ref(
                    *(f[b] for f in fs), pb)):
                out[i].append(s)
        srcs = [jnp.stack(o) for o in out]
        fs = [f + dt * jnp.where(m, s, 0.0).astype(f.dtype)
              for f, s in zip(fs, srcs)]
    if guard:
        ok = jnp.ones((B, X), jnp.float32)
        for f in fs:
            ok = ok * jnp.all(jnp.isfinite(f), axis=(2, 3)).astype(
                jnp.float32)
        return (*fs, ok)
    return tuple(fs)


SERVE = (8, 10, 16)
SIZES = [(8, 10, 3), (5, 6, 2), (4, 8, 3)]


def _reqs(mod):
    out = []
    for uid, (Xr, Yr, n) in enumerate(SIZES):
        u, v, w = (f.numpy() for f in TSA.stratus_fields(Xr, Yr, SERVE[2],
                                                         seed=uid,
                                                         device="cpu"))
        out.append(mod.StencilRequest(uid=uid, u=u, v=v, w=w, n_steps=n))
    return out


def _tdom():
    return TSA.AdvectionDomain(*SERVE, variant="fused", fuse_T=2, dt=0.005,
                               dtype="bfloat16", device="cpu")


def test_bf16_engine_equals_the_jax_engine(monkeypatch):
    monkeypatch.setattr(JK, "advect_fused_batched", _jax_batched)
    jdom = JSA.AdvectionDomain(*SERVE, variant="fused", fuse_T=2, dt=0.005,
                               dtype="bfloat16")
    want = JE.StencilServingEngine(jdom, batch_size=2).run(_reqs(JE))
    got = TE.StencilServingEngine(_tdom(), batch_size=2).run(_reqs(TE))
    assert sorted(got) == sorted(want)
    for uid, req in got.items():
        assert req.status == want[uid].status == "done"
        assert len(req.states) == len(want[uid].states)
        for g, w in zip(req.out, want[uid].out):
            assert g.dtype == np.float32 and w.dtype == ml_dtypes.bfloat16
            assert ulps(g, w) <= JAX_ULPS


def test_bf16_engine_batched_equals_sequential_and_rolls_back_from_disk(
        tmp_path):
    dom = _tdom()
    clean = TE.StencilServingEngine(dom, batch_size=2).run(_reqs(TE))
    for uid, req in clean.items():
        u, v, w = TREF.fields_from_numpy(req.u, req.v, req.w, dtype=BF16,
                                         device="cpu")
        for state in req.states:
            u, v, w = TK.advect_fused(u, v, w, dom.params, T=2, dt=0.005)
            for s, f in zip(state, (u, v, w)):
                np.testing.assert_array_equal(s, f.float().numpy())
    eng = TE.StencilServingEngine(dom, batch_size=2,
                                  snapshot_dir=tmp_path / "snaps")
    faulted = eng.run(_reqs(TE), fault_plan="halo_corruption@1:slot=0")
    assert eng.health()["rollbacks"] == 1
    assert list((tmp_path / "snaps").glob("step_*"))
    for uid, req in clean.items():
        assert faulted[uid].status == "done"
        for g, w in zip(faulted[uid].out, req.out):
            np.testing.assert_array_equal(g, w)


def test_bf16_engine_prime_time_output_and_request_dtypes():
    dom = _tdom()
    u, v, w = (f.numpy() for f in TSA.stratus_fields(8, 10, 16, seed=3,
                                                     device="cpu"))
    req = TE.StencilRequest(uid=0, u=u, v=v, w=w, n_steps=0)
    done = TE.StencilServingEngine(dom, batch_size=1).run([req])
    want = TREF.fields_from_numpy(u, v, w, dtype=BF16, device="cpu")
    for g, f in zip(done[0].out, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, f.float().numpy())
    # bf16 tensors and ml_dtypes arrays come in bit for bit
    reqs = [TE.StencilRequest(uid=1, u=want[0], v=want[1], w=want[2],
                              n_steps=1),
            TE.StencilRequest(uid=2, u=np.asarray(want[0].float().numpy(),
                                                  ml_dtypes.bfloat16),
                              v=np.asarray(want[1].float().numpy(),
                                           ml_dtypes.bfloat16),
                              w=np.asarray(want[2].float().numpy(),
                                           ml_dtypes.bfloat16), n_steps=1)]
    got = TE.StencilServingEngine(dom, batch_size=2).run(reqs)
    for a, b in zip(got[1].out, got[2].out):
        np.testing.assert_array_equal(a, b)


# -- checkpoints -----------------------------------------------------------------

def test_a_bf16_leaf_crosses_between_the_packages_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(a.view(np.int16).copy()).view(BF16)
    # the reference writes, the port restores into a bf16 tensor
    JC.save(tmp_path / "j", {"x": jnp.asarray(a), "y": np.ones(2)}, 1)
    got, _ = TC.restore(tmp_path / "j", {"x": torch.zeros(3, 5, dtype=BF16),
                                         "y": np.zeros(2)})
    assert got["x"].dtype == BF16 and torch.equal(
        got["x"].view(torch.int16), t.view(torch.int16))
    # the port writes the reference's bytes, which it restores as <V2
    TC.save(tmp_path / "t", {"x": t, "y": np.ones(2)}, 1)
    back, _ = JC.restore(tmp_path / "t", {"x": jnp.zeros((3, 5)),
                                          "y": np.zeros(2)})
    assert back["x"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(back["x"].view(np.int16),
                                  a.view(np.int16))
    jman = (tmp_path / "j" / "step_000000001" / "manifest.json").read_text()
    tman = (tmp_path / "t" / "step_000000001" / "manifest.json").read_text()
    assert '"x": "bfloat16"' in jman and '"x": "bfloat16"' in tman
    # a raw <V2 leaf without a bf16 `like` stays the reference's raw bytes
    raw, _ = TC.restore(tmp_path / "t", {"x": np.zeros((3, 5)),
                                         "y": np.zeros(2)})
    assert raw["x"].dtype == np.dtype("V2")


def test_save_of_a_bf16_tensor_no_longer_raises(tmp_path):
    """The fault: `_to_host` called `.numpy()` on a bf16 tensor, which
    raises TypeError."""
    with pytest.raises(TypeError):
        torch.zeros(2, dtype=BF16).numpy()
    t = torch.arange(6, dtype=torch.float32).to(BF16)
    TC.save(tmp_path, {"p": [t, t.float()]}, 3)
    got, step = TC.restore(tmp_path, {"p": [torch.zeros(6, dtype=BF16),
                                            np.zeros(6, np.float32)]})
    assert step == 3 and torch.equal(got["p"][0], t)
    np.testing.assert_array_equal(got["p"][1], t.float().numpy())


# -- the port alone -------------------------------------------------------------

ENGINE_ALONE = r"""
import importlib.abc, sys, tempfile
from pathlib import Path

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
from repro_torch.serving.stencil_engine import (StencilRequest,
                                                StencilServingEngine)
from repro_torch.stencil.advection import AdvectionDomain, stratus_fields

dom = AdvectionDomain(8, 10, 16, variant="fused", fuse_T=2, dt=0.005,
                      dtype="bfloat16", device="cpu")
reqs = [StencilRequest(uid=i, u=u, v=v, w=w, n_steps=2)
        for i, (u, v, w) in enumerate(
            [f.numpy() for f in stratus_fields(8, 10, 16, seed=s,
                                               device="cpu")]
            for s in range(3))]
with tempfile.TemporaryDirectory() as d:
    eng = StencilServingEngine(dom, batch_size=2, snapshot_dir=d)
    done = eng.run(reqs, fault_plan="halo_corruption@1:slot=0")
    assert list(Path(d).glob("step_*"))
assert all(r.status == "done" for r in done.values())
assert all(a.dtype == np.float32 for r in done.values() for a in r.out)
assert eng.health()["rollbacks"] == 1
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro",
                                                     "ml_dtypes")]
assert not bad, bad
print("ok", len(done))
"""


def test_bf16_engine_runs_without_jax_or_ml_dtypes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", ENGINE_ALONE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", "3"]


# -- refusals, the models and the analyzer at itemsize 2 ----------------------

def test_k6_and_k7_refuse_bf16_naming_the_next_slice():
    from repro_torch.stencil import spec as SP
    from repro_torch.launch import mesh as TM
    u, v, w = (torch.zeros(4, 6, 8, dtype=BF16) for _ in range(3))
    with pytest.raises(NotImplementedError, match="next slice"):
        TK.stencil_fused([u, v, w], TREF.default_params(8, device="cpu"),
                         SP.pw_advection_spec("euler"), T=1)
    mesh = TM.make_stencil_mesh(1, 2, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="next slice"):
        TK._check_band_fields([(u, v, w), (u, v, w)], mesh)


def test_bf16_refusals_of_the_ladder():
    fields = tb(np_fields((5, 9, 12)))
    _, tp = params(12, "bf16")
    with pytest.raises(ValueError, match=r"Z % 8 == 0"):
        TK.advect_wide(*fields, tp)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TK.advect_fused(*(f.half() for f in fields), tp)
    with pytest.raises(TypeError, match="u torch.bfloat16"):
        TK.advect_fused(fields[0], fields[1].float(), fields[2], tp)


@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow",
                                  "advect_wide"])
def test_rung_plans_take_the_itemsize(name):
    """A bf16 stage holds 2-byte cells: half the bytes at the same tile,
    so the rung's own tile is taller; `analysis.smem` plans what the
    launch asks for."""
    f32 = TK.rung_launch_plan(name, 1024, 1024, 64, H100_SMS, 2)
    b16 = TK.rung_launch_plan(name, 1024, 1024, 64, H100_SMS, 2, itemsize=2)
    assert b16.TY >= f32.TY and b16.shared_bytes == \
        3 * b16.planes * b16.S * 64 * 2
    same_tile = TK.rung_launch_plan(name, 1024, 1024, 64, H100_SMS, 2,
                                    y_tile=f32.TY, itemsize=2)
    assert same_tile.shared_bytes * 2 == f32.shared_bytes
    plan = SM.rung_plan(name, 1024, 1024, 64, itemsize=2)
    assert plan.total() == b16.shared_bytes
    assert TK.hbm_bytes_model(1024, 1024, 64, 2, "dataflow") * 2 == \
        TK.hbm_bytes_model(1024, 1024, 64, 4, "dataflow")


def test_bf16_ops_fake_implementations_keep_the_dtypes():
    with TRC.fake_mode():
        fn, args = PR.advance_program(8, 16, 32, dtype=BF16).build("cuda")
        out, flags = fn(*args)
    assert all(o.dtype == BF16 for o in out) and flags.dtype == torch.float32


def test_bf16_paper_size_models():
    """Phase 32's claims at the 67M grid: half f32's bytes."""
    prog = PR.advance_program(1024, 1024, 64, dtype=BF16)
    f32p = PR.advance_program(1024, 1024, 64)
    assert prog.claims["pallas_hbm"] == 3_221_225_472
    assert f32p.claims["pallas_hbm"] == 6_442_450_944
    assert prog.claims["guard_field_reads"] == 402_653_184
    assert prog.claims["guard_flag_words"] == 4_096


# -- the f32 paths are unchanged -------------------------------------------------

F32_PINS = {   # sha256[:16] of the outputs' bytes, computed before bf16
    "fused_T3": "91880360687b28a6", "rung_src": "4e705f2be6e77101",
    "rung_fuse": "a4163376c38049e3", "guard": "f603f94b1d517d51",
    "step_ref": "774c60785107166b", "init": "0e7b2670793a9d0e",
    "ref_adv2": "a98e9be1ce77e668", "fused_adv4": "cfe7194d269cce54"}


def _digest(ts) -> str:
    import hashlib
    m = hashlib.sha256()
    for t in ts:
        m.update(t.contiguous().numpy().tobytes())
    return m.hexdigest()[:16]


def test_f32_plain_versions_are_bitwise_what_they_were():
    rng = np.random.default_rng(7)
    shape = (5, 17, 12)
    u, v, w = TREF.fields_from_numpy(*(rng.normal(size=shape)
                                       for _ in range(3)), device="cpu")
    p = TREF.default_params(12, device="cpu")
    xm, ym = torch.ones(5), torch.ones(17)
    ym[3] = 0
    got = {
        "fused_T3": _digest(TK._advect_fused_plain(
            u[None], v[None], w[None], p, 3, 0.01, xm, ym)),
        "rung_src": _digest(TK._advect_rung_plain(u, v, w, p, False, 0.01)),
        "rung_fuse": _digest(TK._advect_rung_plain(u, v, w, p, True, 0.01)),
        "guard": _digest([TK._finite_guard_plain(u, v, w)]),
        "step_ref": _digest(TREF.pw_step_ref(u, v, w, p, 0.37))}
    d = TSA.AdvectionDomain(6, 16, 32, variant="reference", device="cpu",
                            dt=0.3)
    f = d.init(seed=3)
    got["init"] = _digest(f)
    got["ref_adv2"] = _digest(d.advance(*f, 2))
    d2 = TSA.AdvectionDomain(6, 16, 32, variant="fused", device="cpu",
                             dt=0.3, fuse_T=2)
    got["fused_adv4"] = _digest(d2.advance(*f, 4))
    assert got == F32_PINS
