"""The port's spec-driven distributed step and run (`make_distributed_step`
and `make_distributed_run` with `spec=`), `reference_global_spec_step` and
the legacy `make_distributed_advect`, against the JAX reference on CPU
loopback meshes (every shard on the CPU, where K6 and K7 run their plain
versions).

JAX's spec step runs on 4 forced host devices in one child interpreter
(`tests/_subproc.py`'s env), with `local_kernel="reference"` and both
engines (`remote_dma` in its interpret emulation), and writes its outputs
to an npz the port's cases read. The reference's own gate for this path is
`tests/test_stencil_spec.py::test_distributed_spec_path_bitwise_and_oracle`;
its cases run here against the port."""
import textwrap

import numpy as np
import pytest
import torch

from _subproc import run_ok
from repro_torch.core import roofline as TR
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection.ref import default_params
from repro_torch.launch import mesh as TM
from repro_torch.stencil import advection as TSA
from repro_torch.stencil import distributed as TD
from repro_torch.stencil import spec as TSP

DT = 0.01
DIFF_DT = 1e-3
GRID = (8, 12, 8)
SEED = 3
TOL = 1e-5              # test_torch_distributed.py's, absolute
TOL_REL_F32 = 2e-5      # diffusion's phi is ~300: the reference's f32
#                         relative tolerance, times the largest |phi|
ENGINES = ("collective", "remote_dma")
# (operator, integrator, T, (nx, ny)): depth spec.halo(T) from 1 to 4,
# past the local extent on (1, 4) (Yl = 3) and (4, 1) (Xl = 2)
SPEC_CASES = (("pw", "euler", 2, (2, 2)), ("tracer", "euler", 2, (2, 2)),
              ("tracer", "rk2", 1, (1, 4)), ("diffusion", "rk2", 2, (2, 2)),
              ("diffusion", "euler", 3, (4, 1)))
ADVECT_NY = (1, 2, 4)

JAX_CHILD = textwrap.dedent("""
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.launch.mesh import make_stencil_mesh, compat_make_mesh
    from repro.stencil import spec as SP
    from repro.stencil import distributed as D
    from repro.stencil.advection import stratus_fields
    from repro.kernels.advection.ref import default_params

    X, Y, Z = GRID
    p = default_params(Z)
    u, v, w = stratus_fields(X, Y, Z, seed=SEED)
    ops = {"pw": ((u, v, w), p, SP.pw_advection_spec, DT),
           "tracer": ((u, v, w, SP.tracer_field(X, Y, Z)), p,
                      SP.tracer_advection_spec, DT),
           "diffusion": ((SP.diffusion_field(X, Y, Z),),
                         SP.default_diffusion_params(Z), SP.diffusion_spec,
                         DIFF_DT)}
    res = {}
    for op, integ, T, (nx, ny) in SPEC_CASES:
        fields, sp, make, dt = ops[op]
        spec = make(integ)
        mesh = make_stencil_mesh(nx, ny)
        for ex in ENGINES:
            for ov in (False, True):
                fn = D.make_distributed_step(
                    mesh, p, axis="y", x_axis="x", T=T, dt=dt,
                    overlap=ov, exchange=ex, spec=spec, spec_params=sp)
                for i, o in enumerate(fn(*fields)):
                    res[f"{op}/{integ}/{T}/{ex}/{int(ov)}/{i}"] = \\
                        np.asarray(o)
        ref = D.reference_global_spec_step(fields, sp, spec, T=T, dt=dt)
        for i, o in enumerate(ref):
            res[f"{op}/{integ}/{T}/global/{i}"] = np.asarray(o)
    mesh = make_stencil_mesh(2, 2)
    tfields, _, _, _ = ops["tracer"]
    for ex in ENGINES:
        run = D.make_distributed_run(
            mesh, p, n_blocks=3, axis="y", x_axis="x", T=1, dt=DT,
            exchange=ex, spec=SP.tracer_advection_spec(), spec_params=p)
        for i, o in enumerate(run(*tfields)):
            res[f"run/{ex}/{i}"] = np.asarray(o)
    for ny in ADVECT_NY:
        m1 = compat_make_mesh((ny,), ("data",))
        out = D.make_distributed_advect(m1, p, axis="data")(u, v, w)
        for f, o in zip("uvw", out):
            res[f"advect/{ny}/{f}"] = np.asarray(o)
    np.savez(OUT, **res)
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_distributed_spec") / "out.npz"
    consts = (f"GRID = {GRID!r}\nSEED = {SEED}\nDT = {DT}\n"
              f"DIFF_DT = {DIFF_DT}\nSPEC_CASES = {SPEC_CASES!r}\n"
              f"ENGINES = {ENGINES!r}\nADVECT_NY = {ADVECT_NY!r}\n"
              f"OUT = {str(out)!r}\n")
    run_ok(consts + JAX_CHILD, timeout=300)
    with np.load(out) as r:
        return {k: r[k] for k in r.files}


def loopback(nx, ny):
    return TM.make_stencil_mesh(nx, ny, devices=["cpu"] * (nx * ny))


def operator(op, integrator="euler"):
    """(fields, spec params, spec, dt) of one shipped operator on GRID."""
    X, Y, Z = GRID
    p = default_params(Z, device="cpu")
    u, v, w = TSA.stratus_fields(X, Y, Z, seed=SEED, device="cpu")
    if op == "pw":
        return (u, v, w), p, TSP.pw_advection_spec(integrator), DT
    if op == "tracer":
        q = TSP.tracer_field(X, Y, Z, device="cpu")
        return (u, v, w, q), p, TSP.tracer_advection_spec(integrator), DT
    phi = TSP.diffusion_field(X, Y, Z, device="cpu")
    dp = TSP.default_diffusion_params(Z, device="cpu")
    return (phi,), dp, TSP.diffusion_spec(integrator), DIFF_DT


def spec_step(mesh, fields, spec, sp, T, dt, **kw):
    p = default_params(GRID[2], device="cpu")
    step = TD.make_distributed_step(mesh, p, T=T, dt=dt, spec=spec,
                                    spec_params=sp, **kw)
    out = step(TD.shard(mesh, *fields))
    if kw.get("verify_integrity"):
        return TD.gather(mesh, out[0]), out[1]
    return TD.gather(mesh, out)


def same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def tol_for(op, want) -> float:
    if op == "diffusion":
        return TOL_REL_F32 * max(float(np.max(np.abs(np.asarray(x))))
                                 for x in want)
    return TOL


# --- the reference's gate, on the port ---------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("local_kernel", ["reference", "fused"])
@pytest.mark.parametrize("T", [1, 2])
def test_pw_spec_equals_legacy_bitwise(T, local_kernel, engine):
    fields, p, spec, _ = operator("pw")
    mesh = loopback(2, 2)
    legacy = TD.gather(mesh, TD.make_distributed_step(
        mesh, p, T=T, dt=DT, local_kernel=local_kernel,
        exchange=engine)(TD.shard(mesh, *fields)))
    got = spec_step(mesh, fields, spec, p, T, DT, local_kernel=local_kernel,
                    exchange=engine)
    assert same(got, legacy)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_tracer_fused_equals_reference_bitwise(integrator, overlap, engine):
    fields, p, spec, _ = operator("tracer", integrator)
    mesh = loopback(2, 2)
    kw = dict(overlap=overlap, exchange=engine)
    ref = spec_step(mesh, fields, spec, p, 2, DT, **kw)
    fused = spec_step(mesh, fields, spec, p, 2, DT, local_kernel="fused",
                      y_tile=4, **kw)
    assert same(fused, ref)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("local_kernel", ["reference", "fused"])
def test_spec_run_equals_sequential_steps(local_kernel, engine):
    fields, p, spec, _ = operator("tracer")
    mesh = loopback(2, 2)
    kw = dict(T=2, dt=DT, spec=spec, spec_params=p, exchange=engine,
              local_kernel=local_kernel)
    steps = [TD.make_distributed_step(mesh, p, dma_block_index=k, **kw)
             for k in range(3)]
    seq = TD.shard(mesh, *fields)
    for st in steps:
        seq = st(seq)
    run = TD.make_distributed_run(mesh, p, n_blocks=3, **kw)
    assert same(TD.gather(mesh, run(TD.shard(mesh, *fields))),
                TD.gather(mesh, seq))


@pytest.mark.parametrize("nx, ny", [(1, 4), (2, 2), (4, 1)])
@pytest.mark.parametrize("local_kernel", ["reference", "fused"])
def test_rk2_diffusion_within_the_global_oracle(local_kernel, nx, ny):
    fields, dp, spec, dt = operator("diffusion", "rk2")
    got = spec_step(loopback(nx, ny), fields, spec, dp, 2, dt,
                    local_kernel=local_kernel)
    ref = TD.reference_global_spec_step(fields, dp, spec, T=2, dt=dt)
    assert max_diff(got, ref) < 1e-5


def test_reference_global_spec_step_is_spec_multistep():
    fields, p, spec, _ = operator("tracer", "rk2")
    assert same(TD.reference_global_spec_step(fields, p, spec, T=3, dt=DT),
                TSP.spec_multistep(fields, p, spec, 3, DT))


# --- values against JAX ------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=[f"{o}-{i}-T{t}-{m[0]}x{m[1]}"
                              for o, i, t, m in SPEC_CASES])
def test_spec_step_equals_jax(jax_runs, case, engine, overlap):
    op, integ, T, (nx, ny) = case
    fields, sp, spec, dt = operator(op, integ)
    want = [jax_runs[f"{op}/{integ}/{T}/{engine}/{int(overlap)}/{i}"]
            for i in range(spec.n_fields)]
    for lk in ("reference", "fused"):
        got = spec_step(loopback(nx, ny), fields, spec, sp, T, dt,
                        local_kernel=lk, exchange=engine, overlap=overlap)
        assert max_diff(got, want) <= tol_for(op, want), (lk, op)


@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=[f"{o}-{i}-T{t}" for o, i, t, _ in SPEC_CASES])
def test_reference_global_spec_step_equals_jax(jax_runs, case):
    op, integ, T, _ = case
    fields, sp, spec, dt = operator(op, integ)
    want = [jax_runs[f"{op}/{integ}/{T}/global/{i}"]
            for i in range(spec.n_fields)]
    got = TD.reference_global_spec_step(fields, sp, spec, T=T, dt=dt)
    assert max_diff(got, want) <= tol_for(op, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_spec_run_equals_jax(jax_runs, engine):
    fields, p, spec, _ = operator("tracer")
    mesh = loopback(2, 2)
    run = TD.make_distributed_run(mesh, p, n_blocks=3, T=1, dt=DT,
                                  exchange=engine, spec=spec, spec_params=p)
    got = TD.gather(mesh, run(TD.shard(mesh, *fields)))
    want = [jax_runs[f"run/{engine}/{i}"] for i in range(spec.n_fields)]
    assert max_diff(got, want) <= TOL


@pytest.mark.parametrize("ny", ADVECT_NY)
def test_make_distributed_advect_equals_jax(jax_runs, ny):
    fields, p, _, _ = operator("pw")
    mesh = loopback(1, ny)
    adv = TD.make_distributed_advect(mesh, p)
    got = TD.gather(mesh, adv(TD.shard(mesh, *fields)))
    want = [jax_runs[f"advect/{ny}/{f}"] for f in "uvw"]
    assert max_diff(got, want) <= TOL
    # the exchange rebuilds the cut rows: == the global sources, bitwise
    assert same(got, TD.reference_global(*fields, p))


# --- the bytes each spec exchange sends, counted == modelled ----------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=[f"{o}-{i}-T{t}-{m[0]}x{m[1]}"
                              for o, i, t, m in SPEC_CASES])
def test_spec_wire_and_integrity_bytes_equal_models(case, engine):
    op, integ, T, (nx, ny) = case
    fields, sp, spec, dt = operator(op, integ)
    mesh = loopback(nx, ny)
    X, Y, Z = GRID
    p = default_params(Z, device="cpu")
    kw = dict(T=T, dt=dt, spec=spec, spec_params=sp, exchange=engine)
    step0 = TD.make_distributed_step(mesh, p, **kw)
    stepv = TD.make_distributed_step(mesh, p, verify_integrity=True, **kw)
    shards = TD.shard(mesh, *fields)
    D = spec.halo(T)
    wire = TR.halo_wire_bytes_model(X, Y, Z, 4, nx=nx, ny=ny, T=T,
                                    n_fields=spec.n_fields, depth=D)
    words = TR.integrity_bytes_model(X, Y, Z, nx=nx, ny=ny, T=T,
                                     n_fields=spec.n_fields, depth=D)
    assert TD.count_exchange_wire_bytes(step0, shards) == wire > 0
    assert TD.count_exchange_wire_bytes(stepv, shards) == wire
    assert TD.count_integrity_bytes(stepv, shards) == words > 0
    assert TD.count_integrity_bytes(step0, shards) == 0
    run = TD.make_distributed_run(mesh, p, n_blocks=3,
                                  verify_integrity=True, **kw)
    assert TD.count_exchange_wire_bytes(run, shards) == wire
    assert TD.count_integrity_bytes(run, shards) == words


@pytest.mark.parametrize("engine", ENGINES)
def test_spec_verified_step_bitwise_and_corruption_flagged(engine):
    fields, p, spec, _ = operator("tracer")
    mesh = loopback(2, 2)
    kw = dict(exchange=engine)
    plain = spec_step(mesh, fields, spec, p, 1, DT, **kw)
    got, flags = spec_step(mesh, fields, spec, p, 1, DT,
                           verify_integrity=True, **kw)
    assert same(got, plain)
    assert flags.shape == (2, 2) and int(flags.sum()) == 0
    TD.check_integrity(flags)
    # damage on the LAST (tracer) field is caught
    _, bad = spec_step(mesh, fields, spec, p, 1, DT, verify_integrity=True,
                       corrupt_halo=(spec.n_fields - 1, 1, float("nan")),
                       **kw)
    assert int(bad.sum()) > 0
    with pytest.raises(TD.HaloCorrupted, match="checksum"):
        TD.check_integrity(bad)
    # the verified run sums the flags and keeps the bits
    run0 = TD.make_distributed_run(mesh, p, n_blocks=3, T=1, dt=DT,
                                   spec=spec, spec_params=p, **kw)
    runv = TD.make_distributed_run(mesh, p, n_blocks=3, T=1, dt=DT,
                                   spec=spec, spec_params=p,
                                   verify_integrity=True, **kw)
    out, fl = runv(TD.shard(mesh, *fields))
    assert same(TD.gather(mesh, out),
                TD.gather(mesh, run0(TD.shard(mesh, *fields))))
    assert int(fl.sum()) == 0


# --- K7's plain version at a spec's field count ------------------------------

def test_band_exchange_plain_takes_any_field_count():
    mesh = loopback(2, 2)
    rng = np.random.default_rng(0)
    shards = [tuple(torch.tensor(rng.normal(size=(4, 6, 8)),
                                 dtype=torch.float32) for _ in range(5))
              for _ in range(4)]
    bands = TK.halo_band_exchange_dma(shards, mesh=mesh, axis="y", depth=2,
                                      dim=1)
    assert len(bands) == 4 and all(len(b) == 5 for b in bands)
    for f in range(5):
        want = TD._exchange_halos(mesh, [s[f] for s in shards], "y", 2, 1)
        for s in range(4):
            assert torch.equal(bands[s][f][0], want[s][0])
            assert torch.equal(bands[s][f][1], want[s][1])
    slabs = TK.BandSlabs(mesh, (4, 6, 8), 2, 1, n_fields=5)
    assert slabs.buffers.bufs[0].shape == (5, 2, 4, 10, 8)
    assert slabs.matches(mesh, (4, 6, 8), 2, 1, 5)
    assert not slabs.matches(mesh, (4, 6, 8), 2, 1)
    with pytest.raises(ValueError, match="5 fields"):
        TK.halo_band_exchange_dma([s[:3] for s in shards], mesh=mesh,
                                  axis="y", depth=2, dim=1, slabs=slabs)
    assert len(TK.band_messages(mesh, "y", 6, 2, n_fields=5)) == \
        4 * 5 * 2 * len(TK._band_schedule(6, 2))
    with pytest.raises(ValueError, match="shard 1 holds 4 fields"):
        TK.halo_band_exchange_dma([shards[0]] + [s[:4] for s in shards[1:]],
                                  mesh=mesh, axis="y", depth=2, dim=1)


# --- refusals ----------------------------------------------------------------

def test_spec_refusals():
    fields, p, spec, _ = operator("tracer")
    mesh = loopback(1, 4)
    with pytest.raises(ValueError, match="spec must be a StencilSpec"):
        TD.make_distributed_step(mesh, p, spec=object(), spec_params=p)
    with pytest.raises(ValueError, match="spec must be a StencilSpec"):
        TD.make_distributed_run(mesh, p, n_blocks=2, spec=object())
    with pytest.raises(ValueError, match="checkpointing is not wired to "
                                         "the spec-driven run"):
        TD.make_distributed_run(mesh, p, n_blocks=2, spec=spec,
                                spec_params=p, checkpoint_every=1,
                                checkpoint_dir="unused")
    with pytest.raises(ValueError, match="field index must be 0..3"):
        TD.make_distributed_step(mesh, p, spec=spec, spec_params=p,
                                 corrupt_halo=(4, 1, 0.0))
    TD.make_distributed_step(mesh, p, spec=spec, spec_params=p,
                             corrupt_halo=(3, 1, 0.0))
    rk2 = TSP.tracer_advection_spec("rk2")
    step = TD.make_distributed_step(mesh, p, T=6, spec=rk2, spec_params=p)
    with pytest.raises(ValueError, match=r"spec.halo\(T\)=12 exceeds the "
                                         r"decomposable global Y extent "
                                         r"\(12 rows, interior 10\)"):
        step(TD.shard(mesh, *fields))
    with pytest.raises(ValueError, match="shards hold 3 fields, the step 4"):
        TD.make_distributed_step(mesh, p, spec=spec, spec_params=p)(
            TD.shard(mesh, *fields[:3]))


def test_spec_remote_dma_refused_on_a_cuda_mesh_before_any_launch():
    """The refusal is made at build time from the mesh's device type, so a
    mesh naming cuda:0 shows it here without a card."""
    _, p, spec, _ = operator("tracer")
    cuda = TM.make_stencil_mesh(2, 2, devices=["cuda:0"] * 4)
    before = dict(TK.LAUNCHES)
    for make in (TD.make_distributed_step,
                 lambda m, q, **kw: TD.make_distributed_run(
                     m, q, n_blocks=2, **kw)):
        with pytest.raises(RuntimeError, match="spec-driven steps have no "
                                               "band exchange kernel"):
            make(cuda, p, spec=spec, spec_params=p, exchange="remote_dma")
    assert TK.LAUNCHES == before
    TD.make_distributed_step(cuda, p, spec=spec, spec_params=p,
                             exchange="collective")


def test_make_distributed_advect_refusals():
    _, p, _, _ = operator("pw")
    with pytest.raises(ValueError, match=r"takes a \(1, ny\) mesh"):
        TD.make_distributed_advect(loopback(2, 2), p)
    fields, _, _, _ = operator("pw")
    mesh = loopback(1, 4)
    with pytest.raises(ValueError, match="3 shards given"):
        TD.make_distributed_advect(mesh, p)(TD.shard(mesh, *fields)[:3])
