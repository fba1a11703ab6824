"""K6 and K7 in bf16 (`stencil_fused[_batched]` and `halo_band_exchange_dma`
on bf16 fields), and the bf16 distributed paths on both engines, against
the JAX package on the same numpy inputs and within the port.

On the CPU the kernel wrappers run their plain versions, op for op in torch
bf16 at the reference's rounding points: the coefficients reach the source
callbacks dimensioned (`spec.CoefVector`), so a product of an f32
coefficient and a bf16 field is an f32 op, as in JAX; a Python scalar is
weak; the source is rounded to the field's dtype before the update, whose
dt is rounded to bf16 (`ref.step_dt`). Tolerances:

* against JAX's bf16 spec loop, and JAX's distributed step with bf16
  coefficients: bitwise (the promotion matches op for op, and this jax's
  CPU backend rounds each bf16 op as the port does);
* against JAX's distributed step with f32 coefficients, where the
  reference's local step promotes the fields to f32 after its first
  substep: `F32_TOL` = 1e-5, test_torch_distributed.py's f32 tolerance
  (XLA fuses the jitted step and rounds its f32 ops in another order: the
  reference's distributed step itself lies about 2e-6 from its global
  oracle there);
* against the f64 oracle: the reference's TOL_REL["bfloat16"] = 0.02 of
  the field scale (tests/test_stencil_spec.py:35);
* the bf16 distributed step against the global oracle: the reference's 0.1
  (tests/test_distributed_2d.py:64);
* within the port (remote_dma == collective, a run == its steps, PW spec
  == K1, batched == sequential, checkpointed == clean): bitwise."""
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subproc import run_ok
from repro.kernels.advection import ref as JREF
from repro.stencil import spec as JSP
from repro_torch.analysis import programs as PR
from repro_torch.core import roofline as TR
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF
from repro_torch.launch import mesh as TM
from repro_torch.stencil import advection as TSA
from repro_torch.stencil import distributed as TD
from repro_torch.stencil import spec as TSP

BF16 = torch.bfloat16
SHAPE = (8, 10, 8)
DT = 0.1            # at unit spacings most updates exceed half a bf16 ulp
TOL_REL_BF16 = 0.02     # the reference's TOL_REL["bfloat16"]
DIST_TOL = 0.1          # the reference's bf16 2D step tolerance
F32_TOL = 1e-5          # test_torch_distributed.py's, absolute
KEYS = [(op, integ) for op in ("pw", "tracer", "diffusion")
        for integ in ("euler", "rk2")]
N_FIELDS = {"pw": 3, "tracer": 4, "diffusion": 1}


def masks(shape):
    X, Y, _ = shape
    return ((np.arange(X) % 5 != 0).astype(np.float32),
            (np.arange(Y) % 4 != 0).astype(np.float32))


def np_fields(op, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for _ in range(N_FIELDS[op])]


def unit_params(op, Z, coef):
    """(port params, JAX params) at unit spacings, both from the same f32
    numbers: f32, or bf16 rounded from them alike."""
    if op == "diffusion":
        p64 = JSP.default_diffusion_params(Z, dx=1.0, dy=1.0, dz=1.0,
                                           nu=0.1)
        leaves = [np.asarray(leaf, np.float32) for leaf in p64]
        jp = type(p64)(*(jnp.asarray(a, jnp.float32 if coef == "f32"
                                     else jnp.bfloat16) for a in leaves))
        tp = TSP.DiffusionParams(*(torch.tensor(a).to(
            torch.float32 if coef == "f32" else BF16) for a in leaves))
        return tp, jp
    jp = JREF.default_params(Z, dx=1.0, dy=1.0, dz=1.0,
                             dtype=jnp.float32 if coef == "f32"
                             else jnp.bfloat16)
    return TREF.params_from_numpy(jp, dtype=torch.float32 if coef == "f32"
                                  else BF16, device="cpu"), jp


def specs(op, integ):
    port = {"pw": TSP.pw_advection_spec, "tracer": TSP.tracer_advection_spec,
            "diffusion": TSP.diffusion_spec}[op](integ)
    ref = {"pw": JSP.pw_advection_spec, "tracer": JSP.tracer_advection_spec,
           "diffusion": JSP.diffusion_spec}[op](integ)
    return port, ref


def jax_bf16_loop(fields, jp, js, T, dt, xm, ym):
    """The reference kernel's ring in the fields' dtype, as a masked loop
    (`_kernel_stencil_fused`: `base + step_dt * where(interior, S,
    0).astype(base.dtype)`, step_dt weak), on JAX's spec sources."""
    X, Y, _ = fields[0].shape
    r = js.radius
    j = np.arange(X)
    x_ok = (j >= r) & (j <= X - 1 - r) & (xm > 0)
    m = jnp.asarray(x_ok[:, None, None] & (ym > 0)[None, :, None])

    def update(f, s, k):
        return f + k * jnp.where(m, s, 0.0).astype(f.dtype)

    fs = tuple(fields)
    for _ in range(T):
        s0 = JSP.spec_sources(fs, jp, js)
        if js.integrator == "euler":
            fs = tuple(update(f, s, dt) for f, s in zip(fs, s0))
        else:
            g = tuple(update(f, s, 0.5 * dt) for f, s in zip(fs, s0))
            fs = tuple(update(f, s, dt)
                       for f, s in zip(fs, JSP.spec_sources(g, jp, js)))
    return fs


def as_np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def bitwise(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# --- K6 bf16's plain version against the reference ---------------------------

@pytest.mark.parametrize("op,integ", KEYS)
@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 3])
def test_k6_bf16_plain_equals_jax_bf16_spec_loop(op, integ, coef, T):
    """K6's bf16 plain version == the reference ring's bf16 masked loop on
    bf16 jnp arrays, bitwise, with f32 and bf16 coefficients; the fields
    move, so a no-op update would fail it."""
    ts, js = specs(op, integ)
    tp, jp = unit_params(op, SHAPE[2], coef)
    f = np_fields(op, seed=T)
    xm, ym = masks(SHAPE)
    got = TK.stencil_fused([torch.tensor(a).to(BF16) for a in f], tp, ts,
                           T=T, dt=DT, x_interior_mask=xm,
                           y_interior_mask=ym)
    want = jax_bf16_loop([jnp.asarray(a, jnp.bfloat16) for a in f], jp, js,
                         T, DT, xm, ym)
    assert all(g.dtype == BF16 for g in got)
    assert all(str(w.dtype) == "bfloat16" for w in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(as_np(g), as_np(w))
    assert any(not torch.equal(g, torch.tensor(a).to(BF16))
               for g, a in zip(got, f))


@pytest.mark.parametrize("op,integ", KEYS)
def test_k6_bf16_within_the_reference_tolerance_of_f64(op, integ):
    """On the reference's operators (its seeded fields in bf16, its
    coefficients and dt, T = 2), K6 bf16 lies within 0.02 of the f64
    oracle's field scale, the reference's gate; at unit spacings too."""
    from test_torch_spec import operator
    key = op if integ == "euler" else f"{op}_rk2"
    ts, _, tp, _, fields, dt = operator(key)
    f16 = [torch.tensor(a).to(BF16) for a in fields]
    for params, step in ((tp, dt), (unit_params(op, SHAPE[2], "f32")[0],
                                    DT)):
        out = TK.stencil_fused(f16, params, ts, T=2, dt=step)
        oracle = TSP.spec_multistep_ref_f64(f16, params, ts, 2, step)
        scale = max(1.0, max(float(o.abs().max()) for o in oracle))
        err = max(float((a.double() - b).abs().max())
                  for a, b in zip(out, oracle))
        assert err <= TOL_REL_BF16 * scale, (err, scale)


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("y_tile", [None, 3])
def test_pw_spec_bf16_equals_k1_bf16(coef, y_tile):
    tp, _ = unit_params("pw", SHAPE[2], coef)
    f16 = [torch.tensor(a).to(BF16) for a in np_fields("pw", seed=5)]
    xm, ym = masks(SHAPE)
    kw = dict(T=3, dt=DT, y_tile=y_tile, x_interior_mask=xm,
              y_interior_mask=ym)
    got = TK.stencil_fused(f16, tp, TSP.pw_advection_spec(), **kw)
    assert bitwise(got, TK.advect_fused(*f16, tp, **kw))


@pytest.mark.parametrize("op,integ", KEYS)
def test_k6_bf16_batched_equals_sequential(op, integ):
    ts, _ = specs(op, integ)
    tp, _ = unit_params(op, SHAPE[2], "bf16")
    B = 3
    per = [np_fields(op, seed=10 + b) for b in range(B)]
    fields = [torch.stack([torch.tensor(per[b][i]).to(BF16)
                           for b in range(B)]) for i in range(ts.n_fields)]
    xm = torch.ones(B, SHAPE[0])
    ym = torch.ones(B, SHAPE[1])
    xm[1, 3] = 0.0
    ym[2, 4:7] = 0.0
    out = TK.stencil_fused_batched(fields, tp, ts, T=2, dt=DT,
                                   x_interior_mask=xm, y_interior_mask=ym)
    for b in range(B):
        one = TK.stencil_fused([f[b] for f in fields], tp, ts, T=2, dt=DT,
                               x_interior_mask=xm[b], y_interior_mask=ym[b])
        assert bitwise([o[b] for o in out], one)


def test_k6_param_vectors_keep_bf16_only_for_bf16_fields():
    ts = TSP.pw_advection_spec()
    tp, _ = unit_params("pw", 8, "bf16")
    assert all(p.dtype == BF16 for p in
               TK._spec_param_vectors(ts, tp, "cpu", BF16))
    assert all(p.dtype == torch.float32 for p in
               TK._spec_param_vectors(ts, tp, "cpu", torch.float32))
    tf, _ = unit_params("pw", 8, "f32")
    assert all(p.dtype == torch.float32 for p in
               TK._spec_param_vectors(ts, tf, "cpu", BF16))
    with pytest.raises(TypeError, match="is torch.float32"):
        TK.stencil_fused([torch.zeros(4, 5, 8, dtype=BF16),
                          torch.zeros(4, 5, 8), torch.zeros(4, 5, 8,
                                                            dtype=BF16)],
                         tf, ts, T=1)


# --- K7 in bf16 --------------------------------------------------------------

def loopback(nx, ny):
    return TM.make_stencil_mesh(nx, ny, devices=["cpu"] * (nx * ny))


def test_k7_bf16_buffers_bands_and_movement():
    """K7's plain version on bf16 shards: buffers and bands in bf16, the
    bands == the collective engine's, and the movement priced at 2 bytes
    a cell."""
    mesh = loopback(2, 2)
    rng = np.random.default_rng(2)
    shape = (4, 6, 8)
    shards = [tuple(torch.tensor(rng.normal(size=shape),
                                 dtype=torch.float32).to(BF16)
                    for _ in range(3)) for _ in range(4)]
    slabs = TK.BandSlabs(mesh, shape, 2, 1, dtype=BF16)
    bands = TK.halo_band_exchange_dma(shards, mesh=mesh, axis="y", depth=2,
                                      dim=1, slabs=slabs)
    assert all(b.dtype == BF16 for b in slabs.buffers.bufs)
    for f in range(3):
        want = TD._exchange_halos(mesh, [s[f] for s in shards], "y", 2, 1)
        for s in range(4):
            assert torch.equal(bands[s][f][0], want[s][0])
            assert torch.equal(bands[s][f][1], want[s][1])
    table = slabs.table("y", 0, shards)
    moved = TK.band_movement(table.handle)
    f32 = TK.BandSlabs(mesh, shape, 2, 1)
    moved32 = TK.band_movement(f32.table("y", 0, [tuple(t.float() for t in s)
                                                  for s in shards]).handle)
    assert [b for _, b in moved["messages"]] == \
        [b // 2 for _, b in moved32["messages"]]
    assert moved["own"][0][1] * 2 == moved32["own"][0][1]
    with pytest.raises(ValueError, match="fields of torch.bfloat16"):
        TK.halo_band_exchange_dma([tuple(t.float() for t in s)
                                   for s in shards], mesh=mesh, axis="y",
                                  depth=2, dim=1, slabs=slabs)


# --- the bf16 distributed paths ---------------------------------------------

GRID = (8, 12, 8)
SEED = 3
T_STEP = 2
DIST_DT = 0.01
ENGINES = ("collective", "remote_dma")

JAX_CHILD = textwrap.dedent("""
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_stencil_mesh
    from repro.stencil import spec as SP
    from repro.stencil import distributed as D
    from repro.stencil.advection import stratus_fields
    from repro.kernels.advection.ref import default_params

    X, Y, Z = GRID
    u, v, w = stratus_fields(X, Y, Z, seed=SEED, dtype=jnp.bfloat16)
    q = SP.tracer_field(X, Y, Z, dtype=jnp.bfloat16)
    res = {}
    mesh = make_stencil_mesh(2, 2)
    for coef, cd in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        p = default_params(Z, dtype=cd)
        for ex in ENGINES:
            fn = D.make_distributed_step(
                mesh, p, axis="y", x_axis="x", T=T_STEP, dt=DIST_DT,
                local_kernel="reference", exchange=ex, interpret=True)
            for f, o in zip("uvw", fn(u, v, w)):
                res[f"pw/{coef}/{ex}/{f}"] = np.asarray(o, np.float32)
                res[f"pw/{coef}/{ex}/{f}/dtype"] = np.asarray(str(o.dtype))
            fn = D.make_distributed_step(
                mesh, p, axis="y", x_axis="x", T=T_STEP, dt=DIST_DT,
                exchange=ex, spec=SP.tracer_advection_spec(), spec_params=p)
            for i, o in enumerate(fn(u, v, w, q)):
                res[f"tracer/{coef}/{ex}/{i}"] = np.asarray(o, np.float32)
    np.savez(OUT, **res)
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_bf16_distributed") / "out.npz"
    consts = (f"GRID = {GRID!r}\nSEED = {SEED}\nT_STEP = {T_STEP}\n"
              f"DIST_DT = {DIST_DT}\nENGINES = {ENGINES!r}\n"
              f"OUT = {str(out)!r}\n")
    run_ok(consts + JAX_CHILD, timeout=300)
    with np.load(out) as r:
        return {k: r[k] for k in r.files}


def bf16_inputs(coef):
    X, Y, Z = GRID
    u, v, w = TSA.stratus_fields(X, Y, Z, seed=SEED, dtype=BF16,
                                 device="cpu")
    q = TSP.tracer_field(X, Y, Z, dtype=BF16, device="cpu")
    p = TREF.default_params(Z, dtype=torch.float32 if coef == "f32" else BF16,
                            device="cpu")
    return (u, v, w), q, p


def assert_like_jax(got, want, coef):
    """Bitwise with bf16 coefficients; within `F32_TOL` with f32 ones."""
    if coef == "bf16":
        np.testing.assert_array_equal(as_np(got), want)
    else:
        assert float(np.abs(as_np(got) - want).max()) <= F32_TOL


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("exchange", ENGINES)
def test_bf16_pw_step_equals_jax_reference_step(jax_bf16, coef, exchange):
    """The bf16 PW step on CPU shards with `local_kernel="reference"`, each
    engine, == JAX's `make_distributed_step(local_kernel="reference")` on
    bf16 fields, dtype included (f32 coefficients promote the reference's
    sources, and so its result, to f32); within 0.1 of the port's global
    oracle."""
    mesh = loopback(2, 2)
    (u, v, w), _, p = bf16_inputs(coef)
    step = TD.make_distributed_step(mesh, p, T=T_STEP, dt=DIST_DT,
                                    local_kernel="reference",
                                    exchange=exchange)
    out = TD.gather(mesh, step(TD.shard(mesh, u, v, w)))
    for f, o in zip("uvw", out):
        assert str(o.dtype).split(".")[-1] == \
            str(jax_bf16[f"pw/{coef}/{exchange}/{f}/dtype"])
        assert_like_jax(o, jax_bf16[f"pw/{coef}/{exchange}/{f}"], coef)
    ref = TD.reference_global_step(u, v, w, p, T=T_STEP, dt=DIST_DT)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(out, ref))
    assert err < DIST_TOL


@pytest.mark.parametrize("coef", ["f32", "bf16"])
@pytest.mark.parametrize("exchange", ENGINES)
def test_bf16_spec_step_equals_jax_reference_step(jax_bf16, coef, exchange):
    """The bf16 `spec=` step (tracer) on CPU shards, each engine: with
    `local_kernel="reference"` == JAX's spec step (its reference local
    kernel) on bf16 fields; with `local_kernel="fused"` (K6 bf16's plain
    version, which keeps the fields bf16) within 0.1 of the global spec
    oracle, and == the reference local kernel bitwise where the
    coefficients are bf16 (nothing promotes to f32 there)."""
    mesh = loopback(2, 2)
    (u, v, w), q, p = bf16_inputs(coef)
    spec = TSP.tracer_advection_spec()
    outs = {}
    for lk in ("reference", "fused"):
        step = TD.make_distributed_step(mesh, p, T=T_STEP, dt=DIST_DT,
                                        local_kernel=lk, exchange=exchange,
                                        spec=spec, spec_params=p)
        outs[lk] = TD.gather(mesh, step(TD.shard(mesh, u, v, w, q)))
    for i, o in enumerate(outs["reference"]):
        assert_like_jax(o, jax_bf16[f"tracer/{coef}/{exchange}/{i}"], coef)
    assert all(o.dtype == BF16 for o in outs["fused"])
    ref = TD.reference_global_spec_step((u, v, w, q), p, spec, T=T_STEP,
                                        dt=DIST_DT)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(outs["fused"], ref))
    assert err < DIST_TOL
    if coef == "bf16":
        assert bitwise(outs["fused"], outs["reference"])


@pytest.mark.parametrize("local_kernel", ["fused", "reference"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("nx,ny,T", [(2, 2, 2), (1, 4, 4), (4, 1, 3)])
def test_bf16_remote_dma_equals_collective_and_run_equals_steps(
        local_kernel, overlap, nx, ny, T):
    """Within the port, on bf16 shards: remote_dma (K7's plain version into
    bf16 extended buffers) == collective, bitwise, and a 3-block run ==
    three steps at block indices 0-2; the fused run == the single-domain
    K1 bf16 advance."""
    mesh = loopback(nx, ny)
    (u, v, w), _, p = bf16_inputs("bf16")
    kw = dict(T=T, dt=DIST_DT, local_kernel=local_kernel, overlap=overlap)
    outs = {}
    for ex in ENGINES:
        run = TD.make_distributed_run(mesh, p, n_blocks=3, exchange=ex, **kw)
        outs[ex] = TD.gather(mesh, run(TD.shard(mesh, u, v, w)))
        shards = TD.shard(mesh, u, v, w)
        for k in range(3):
            shards = TD.make_distributed_step(mesh, p, exchange=ex,
                                              dma_block_index=k,
                                              **kw)(shards)
        assert bitwise(outs[ex], TD.gather(mesh, shards))
    assert bitwise(outs["remote_dma"], outs["collective"])
    if local_kernel == "fused":
        assert all(o.dtype == BF16 for o in outs["collective"])
        single = TK.advect_fused(u, v, w, p, T=3 * T, dt=DIST_DT)
        assert bitwise(outs["collective"], single)


@pytest.mark.parametrize("exchange", ENGINES)
def test_bf16_checkpointed_run_and_resume_equal_the_clean_run(tmp_path,
                                                              exchange):
    mesh = loopback(2, 2)
    (u, v, w), _, p = bf16_inputs("bf16")
    kw = dict(T=2, dt=DIST_DT, local_kernel="fused", exchange=exchange)
    clean = TD.gather(mesh, TD.make_distributed_run(mesh, p, n_blocks=4,
                                                    **kw)(
        TD.shard(mesh, u, v, w)))
    saved = TD.make_distributed_run(mesh, p, n_blocks=4, checkpoint_every=2,
                                    checkpoint_dir=str(tmp_path / "a"), **kw)
    assert bitwise(TD.gather(mesh, saved(TD.shard(mesh, u, v, w))), clean)
    part = TD.make_distributed_run(mesh, p, n_blocks=3, checkpoint_every=2,
                                   checkpoint_dir=str(tmp_path / "b"), **kw)
    part(TD.shard(mesh, u, v, w))
    res = TD.resume_distributed_run(mesh, p, TD.shard(mesh, u, v, w),
                                    n_blocks=4,
                                    checkpoint_dir=str(tmp_path / "b"), **kw)
    assert all(t.dtype == BF16 for trio in res for t in trio)
    assert bitwise(TD.gather(mesh, res), clean)


# --- the analyzer at itemsize 2 ---------------------------------------------

def test_bf16_programs_price_two_bytes_a_cell():
    """The bf16 distributed block (K7 + K1 bf16) and the K6 bf16 pass are
    priced at itemsize 2: half their f32 programs' bytes, each category
    the roofline models at itemsize 2."""
    X, Y, Z = 16, 16, 32
    d16 = PR.distributed_program(X, Y, Z, exchange="remote_dma",
                                 dtype=BF16)
    d32 = PR.distributed_program(X, Y, Z, exchange="remote_dma")
    kw = dict(nx=2, ny=2, T=4, n_fields=3, depth=4)
    assert d16.claims["ppermute_wire"] == \
        TR.halo_wire_bytes_model(X, Y, Z, 2, **kw)
    assert d16.claims["pallas_hbm"] * 2 == d32.claims["pallas_hbm"]
    assert d16.name == "distributed_remote_dma_bf16"
    s16 = PR.spec_path_program(X, Y, Z, dtype=BF16)
    s32 = PR.spec_path_program(X, Y, Z)
    assert s16.claims["pallas_hbm"] * 2 == s32.claims["pallas_hbm"]
    names = {p.name for p in PR.programs(small=True)}
    assert {"distributed_remote_dma_bf16", "spec_path_bf16"} <= names
