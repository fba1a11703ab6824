"""The port's distributed stencil path (`repro_torch.launch.mesh`,
`repro_torch.stencil.distributed`, K7's wrapper and plain version, the mesh
models of `core.roofline` and `AdvectionDomain`'s mesh accounting) against
the JAX reference, on CPU loopback meshes (every shard on the CPU).

JAX's `make_distributed_step` runs on 4 forced host devices in one child
interpreter (`tests/_subproc.py`'s env), with `local_kernel="reference"`
and both engines (`remote_dma` in its interpret emulation); it writes its
outputs to an npz the port's cases read."""
import dataclasses
import itertools
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subproc import run_ok
from repro.core import roofline as JR
from repro.kernels.advection import advection as JK
from repro.launch import mesh as JM
from repro.stencil import advection as JSA
from repro.stencil import distributed as JD
from repro_torch.core import roofline as TR
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection.ref import default_params
from repro_torch.launch import mesh as TM
from repro_torch.stencil import advection as TSA
from repro_torch.stencil import distributed as TD
from repro_torch.stencil import spec as TSP

DT = 0.01
GRID = (8, 12, 8)
SEED = 3
TOL = 1e-5
# (nx, ny, T): (1, 4) has T = 4 > Yl = 3 (two hops), (4, 1) T = 3 > Xl = 2
MESHES = ((2, 2, 2), (1, 4, 4), (4, 1, 3))
ENGINES = ("collective", "remote_dma")
CORRUPT = (1, 1, 7.0)

JAX_CHILD = textwrap.dedent("""
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.stencil.distributed import make_distributed_step
    from repro.stencil.advection import stratus_fields
    from repro.kernels.advection.ref import default_params
    from repro.launch.mesh import make_stencil_mesh

    X, Y, Z = GRID
    u, v, w = stratus_fields(X, Y, Z, seed=SEED)
    p = default_params(Z)
    res = {"u": np.asarray(u), "v": np.asarray(v), "w": np.asarray(w)}

    def put(mesh):
        sh = NamedSharding(mesh, P("x", "y", None))
        return [jax.device_put(t, sh) for t in (u, v, w)]

    for nx, ny, T in MESHES:
        mesh = make_stencil_mesh(nx, ny)
        for ex in ENGINES:
            for ov in (False, True):
                fn = make_distributed_step(
                    mesh, p, axis="y", x_axis="x", T=T, dt=DT,
                    local_kernel="reference", overlap=ov, exchange=ex,
                    interpret=True)
                for f, o in zip("uvw", fn(*put(mesh))):
                    res[f"{nx}x{ny}/{ex}/{int(ov)}/{f}"] = np.asarray(o)
    mesh = make_stencil_mesh(2, 2)
    for ex in ENGINES:
        fn = make_distributed_step(
            mesh, p, axis="y", x_axis="x", T=2, dt=DT, exchange=ex,
            interpret=True, verify_integrity=True, corrupt_halo=CORRUPT)
        out = fn(*put(mesh))
        res[f"corrupt/{ex}/flags"] = np.asarray(out[3])
        for f, o in zip("uvw", out[:3]):
            res[f"corrupt/{ex}/{f}"] = np.asarray(o)
    np.savez(OUT, **res)
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_distributed") / "out.npz"
    consts = (f"GRID = {GRID!r}\nSEED = {SEED}\nDT = {DT}\n"
              f"MESHES = {MESHES!r}\nENGINES = {ENGINES!r}\n"
              f"CORRUPT = {CORRUPT!r}\nOUT = {str(out)!r}\n")
    run_ok(consts + JAX_CHILD, timeout=300)
    with np.load(out) as r:
        return {k: r[k] for k in r.files}


def loopback(nx, ny):
    return TM.make_stencil_mesh(nx, ny, devices=["cpu"] * (nx * ny))


def inputs():
    u, v, w = TSA.stratus_fields(*GRID, seed=SEED, device="cpu")
    return u, v, w, default_params(GRID[2], device="cpu")


def run_step(nx, ny, T, *, fields=None, **kw):
    u, v, w, p = inputs() if fields is None else fields
    mesh = loopback(nx, ny)
    step = TD.make_distributed_step(mesh, p, T=T, dt=DT, **kw)
    out = step(TD.shard(mesh, u, v, w))
    if kw.get("verify_integrity"):
        return TD.gather(mesh, out[0]), out[1]
    return TD.gather(mesh, out)


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --- the wire format and ring math, pinned to the reference ----------------

@pytest.mark.parametrize("L", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("depth", [1, 2, 4, 7, 9])
def test_band_schedule_equals_jax(L, depth):
    assert TK._band_schedule(L, depth) == JK._band_schedule(L, depth)
    assert TD._band_schedule is TK._band_schedule


def special_f32(shape, seed):
    """Random f32 with NaN (two payloads), +-inf and -0 bit patterns."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape).astype(np.float32).ravel()
    bits = a.view(np.uint32)
    bits[:6] = [0x7FC00000, 0xFFC00123, 0x7F800000, 0xFF800000,
                0x80000000, 0x00000001]
    return a.reshape(shape)


@pytest.mark.parametrize("shape,seed", [((2, 6, 8), 0), ((8, 3, 5), 1),
                                        ((1, 1, 7), 2), ((4, 12, 64), 3)])
def test_band_checksum_equals_jax(shape, seed):
    a = special_f32(shape, seed)
    got = TK.band_checksum(torch.from_numpy(a))
    want = JK.band_checksum(jnp.asarray(a))
    assert got.shape == (1,) and got.dtype == torch.int64
    assert int(got[0]) == int(np.asarray(want)[0])
    # order-independent: a permuted band sums to the same word
    perm = np.random.default_rng(seed).permutation(a.size)
    assert torch.equal(TK.band_checksum(torch.from_numpy(a.ravel()[perm])),
                       got)


def test_band_checksum_refuses_other_widths():
    for dtype in (torch.float64, torch.float16, torch.bfloat16):
        with pytest.raises(TypeError, match="32-bit words"):
            TK.band_checksum(torch.zeros(4, dtype=dtype))
    assert TK.band_checksum(torch.zeros(3, dtype=torch.int32)).tolist() == [0]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ring_neighbor_equals_jax(n):
    for idx, delta in itertools.product(range(n), range(-2 * n, 2 * n + 1)):
        assert TM.ring_neighbor(idx, n, delta) == \
            JM.ring_neighbor(idx, n, delta)
    axes = ("x", "y")
    for c, axis, delta in itertools.product(
            itertools.product(range(n), range(3)), axes, (-2, -1, 1, 2)):
        assert TM.dma_neighbor_coords(axes, c, axis, delta, n) == \
            JM.dma_neighbor_coords(axes, c, axis, delta, n)


def test_ring_errors_equal_jax():
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="axis size"):
            mod.ring_neighbor(0, 0, 1)
        with pytest.raises(ValueError, match="not in mesh axes"):
            mod.dma_neighbor_coords(("x", "y"), (0, 0), "z", 1, 2)


@pytest.mark.parametrize("shape", [(512, 512, 64), (520, 512, 64),
                                   (8, 3, 5)])
@pytest.mark.parametrize("depth", [1, 4, 7])
@pytest.mark.parametrize("dim", [0, 1])
def test_dma_slab_bytes_equals_jax(shape, depth, dim):
    assert TK.dma_slab_bytes(shape, depth, dim) == \
        JK.dma_slab_bytes(shape, depth, dim)


# --- the mesh ---------------------------------------------------------------

def test_loopback_mesh_layout():
    mesh = loopback(2, 3)
    assert mesh.shape == (2, 3) and mesh.axis_names == ("x", "y")
    assert mesh.devices == (torch.device("cpu"),) * 6
    assert not mesh.is_cuda
    assert [mesh.coords(s) for s in range(6)] == \
        [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert all(mesh.index(mesh.coords(s)) == s for s in range(6))
    assert mesh.axis_size("x") == 2 and mesh.axis_size("y") == 3


def test_mesh_refusals():
    # distinct cards are the default; this process sees none
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs 64 devices, {avail} "
                                         "available"):
        TM.make_stencil_mesh(8, 8)
    with pytest.raises(ValueError, match="needs 64 devices"):
        TM.resize_stencil_mesh(8, 8)
    for fn in (TM.make_stencil_mesh, TM.resize_stencil_mesh):
        with pytest.raises(ValueError, match="mesh shape must be >= 1"):
            fn(0, 2, devices=[])
    with pytest.raises(ValueError, match="loopback"):
        TM.make_stencil_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        TM.make_stencil_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not in mesh axes"):
        loopback(2, 2).axis_size("z")


# --- the mesh models, pinned to the reference -------------------------------

MODEL_CASES = [(1024, 1024, 64, 2, 2, 4), (1024, 1024, 64, 1, 4, 4),
               (8, 12, 8, 4, 1, 3), (8, 12, 8, 1, 4, 4), (16, 16, 8, 1, 1, 2),
               (4096, 1024, 64, 4, 1, 8)]


@pytest.mark.parametrize("X,Y,Z,nx,ny,T", MODEL_CASES)
def test_mesh_models_equal_jax(X, Y, Z, nx, ny, T):
    kw = dict(nx=nx, ny=ny, T=T)
    assert TR.halo_wire_bytes_model(X, Y, Z, 4, **kw) == \
        JR.halo_wire_bytes_model(X, Y, Z, 4, **kw)
    assert TR.halo_wire_bytes_model(X, Y, Z, 4, n_fields=1, depth=2 * T,
                                    **kw) == \
        JR.halo_wire_bytes_model(X, Y, Z, 4, n_fields=1, depth=2 * T, **kw)
    assert TR.integrity_bytes_model(X, Y, Z, **kw) == \
        JR.integrity_bytes_model(X, Y, Z, **kw)
    assert TD.remote_dma_schedule_wire_bytes(X // nx, Y // ny, Z, 4, **kw) \
        == JD.remote_dma_schedule_wire_bytes(X // nx, Y // ny, Z, 4, **kw) \
        == TR.halo_wire_bytes_model(X, Y, Z, 4, **kw)
    frac = TR.interior_compute_fraction(X // nx, Y // ny, T, nx=nx, ny=ny)
    assert frac == JR.interior_compute_fraction(X // nx, Y // ny, T, nx=nx,
                                                ny=ny)
    for ov, ex, K in itertools.product((False, True), ENGINES, (1, 2, 8)):
        assert TR.overlap_efficiency_model(
            overlap=ov, exchange=ex, interior_fraction=frac) == \
            JR.overlap_efficiency_model(overlap=ov, exchange=ex,
                                        interior_fraction=frac)
        assert TR.pipeline_efficiency_model(
            n_blocks=K, overlap=ov, exchange=ex, interior_fraction=frac) == \
            JR.pipeline_efficiency_model(n_blocks=K, overlap=ov, exchange=ex,
                                         interior_fraction=frac)
    assert TR.XLA_OVERLAP_DISCOUNT == JR.XLA_OVERLAP_DISCOUNT


def test_path_wire_bytes_are_the_issued_figure():
    """Per shard and block at (2, 2), T = 4 on the 67M grid."""
    assert TD.remote_dma_schedule_wire_bytes(512, 512, 64, 4, nx=2, ny=2,
                                             T=4) == 6_340_608


def test_mesh_model_errors_equal_jax():
    for mod in (TR, JR):
        with pytest.raises(ValueError, match="mesh shape"):
            mod.halo_wire_bytes_model(8, 8, 8, 4, nx=0)
        with pytest.raises(ValueError, match="not divisible"):
            mod.integrity_bytes_model(8, 9, 8, ny=2)
        with pytest.raises(ValueError, match="T must be"):
            mod.integrity_bytes_model(8, 8, 8, T=0)
        with pytest.raises(ValueError, match="shard extents"):
            mod.interior_compute_fraction(0, 4, 1)
        with pytest.raises(ValueError, match="unknown exchange"):
            mod.overlap_efficiency_model(overlap=True, exchange="nccl")
        with pytest.raises(ValueError, match="interior_fraction"):
            mod.overlap_efficiency_model(overlap=True, interior_fraction=2.0)
        with pytest.raises(ValueError, match="n_blocks"):
            mod.pipeline_efficiency_model(n_blocks=0, overlap=True)


MESH_DOMAINS = [dict(mesh_nx=2, mesh_ny=2), dict(mesh_nx=1, mesh_ny=4),
                dict(mesh_nx=4, mesh_ny=1, overlap=True),
                dict(mesh_nx=2, mesh_ny=2, overlap=True,
                     exchange="remote_dma"),
                dict(mesh_nx=2, mesh_ny=2, overlap=True,
                     exchange="remote_dma", n_blocks=4),
                dict(mesh_nx=2, mesh_ny=4, overlap=True, n_blocks=3),
                dict()]


@pytest.mark.parametrize("kw", MESH_DOMAINS)
def test_domain_mesh_accounting_equals_jax(kw):
    # Z = 128: the reference pads each Z row to its TPU's 128 lanes, the
    # port to 16 bytes; the two byte models agree where Z is lane-aligned
    X, Y, Z = 1024, 1024, 128
    t = TSA.AdvectionDomain(X, Y, Z, variant="fused", device="cpu", **kw)
    j = JSA.AdvectionDomain(X, Y, Z, variant="fused", **kw)
    assert t.shard_shape() == j.shard_shape()
    assert t.halo_wire_bytes_per_step() == j.halo_wire_bytes_per_step()
    assert t.hbm_bytes_per_shard_step() == j.hbm_bytes_per_shard_step()
    assert t.overlap_efficiency() == j.overlap_efficiency()
    assert t.pipeline_efficiency() == j.pipeline_efficiency()
    jt = j.roofline_terms()
    for loopback_mesh in (False, True):
        tt = t.roofline_terms(loopback=loopback_mesh)
        assert tt.wire_bytes == jt.ici_wire_bytes
        assert tt.n_chips == jt.n_chips
        assert tt.overlap_efficiency == jt.overlap_efficiency
        assert tt.flops_per_dev == jt.flops_per_dev
        assert tt.hbm_bytes_per_dev == jt.hbm_bytes_per_dev
        bw = TR.HBM_BW / 2 if loopback_mesh else 450e9
        assert tt.collective_s == tt.wire_bytes / bw
        hideable = min(tt.collective_s, max(tt.compute_s, tt.memory_s))
        assert tt.collective_hidden_s == tt.overlap_efficiency * hideable
        assert tt.collective_exposed_s == \
            tt.collective_s - tt.collective_hidden_s
        assert tt.step_time_s == max(tt.compute_s, tt.memory_s,
                                     tt.collective_s)


def test_domain_mesh_validation_equals_jax():
    for mod, kw in ((TSA, dict(device="cpu")), (JSA, {})):
        with pytest.raises(ValueError, match="exchange must be"):
            mod.AdvectionDomain(8, 8, 8, exchange="nccl", **kw)
        with pytest.raises(ValueError, match="n_blocks must be"):
            mod.AdvectionDomain(8, 8, 8, n_blocks=0, **kw)
        with pytest.raises(ValueError, match="not divisible by mesh"):
            mod.AdvectionDomain(8, 9, 8, mesh_ny=2, **kw).shard_shape()
    d = TSA.AdvectionDomain(8, 8, 8, device="cpu", mesh_nx=2)
    assert dataclasses.replace(d, mesh_nx=1).overlap_efficiency() == 0.0


def test_collective_term_rates_from_the_data_sheet():
    assert TR.NVLINK_BW == 450e9
    assert TR.LOOPBACK_BW == TR.HBM_BW / 2
    with pytest.raises(ValueError, match="overlap_efficiency"):
        TR.RooflineTerms(1.0, 1.0, overlap_efficiency=1.5)


# --- the distributed step against JAX and the oracle ------------------------

STEP_CASES = [(m, ex, ov) for m in MESHES for ex in ENGINES
              for ov in (False, True)]


@pytest.mark.parametrize("mesh_case,exchange,overlap", STEP_CASES)
def test_step_matches_jax_distributed_step(jax_runs, mesh_case, exchange,
                                           overlap):
    nx, ny, T = mesh_case
    fields = tuple(torch.from_numpy(jax_runs[f]) for f in "uvw") + (
        default_params(GRID[2], device="cpu"),)
    got = run_step(nx, ny, T, fields=fields, exchange=exchange,
                   overlap=overlap)
    want = [jax_runs[f"{nx}x{ny}/{exchange}/{int(overlap)}/{f}"]
            for f in "uvw"]
    assert max_diff(got, want) < TOL


@pytest.mark.parametrize("mesh_case,exchange,overlap", STEP_CASES)
def test_step_matches_global_oracle(mesh_case, exchange, overlap):
    nx, ny, T = mesh_case
    u, v, w, p = inputs()
    want = TD.reference_global_step(u, v, w, p, T=T, dt=DT)
    got = run_step(nx, ny, T, exchange=exchange, overlap=overlap)
    assert max_diff(got, want) < TOL
    moved = max_diff(want, (u, v, w))
    assert moved > 100 * TOL


def test_reference_global_equals_the_oracle():
    u, v, w, p = inputs()
    from repro_torch.kernels.advection.ref import pw_advect_ref
    assert same(TD.reference_global(u, v, w, p), pw_advect_ref(u, v, w, p))


@pytest.mark.parametrize("mesh_case", MESHES)
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("y_tile", [None, 5])
def test_fused_local_kernel_equals_reference(mesh_case, overlap, y_tile):
    nx, ny, T = mesh_case
    ref = run_step(nx, ny, T, overlap=overlap)
    fused = run_step(nx, ny, T, overlap=overlap, local_kernel="fused",
                     y_tile=y_tile)
    assert same(fused, ref)


# --- internal bitwise contracts ---------------------------------------------

@pytest.mark.parametrize("mesh_case", MESHES + ((2, 1, 2), (1, 2, 6)))
@pytest.mark.parametrize("local_kernel", ["reference", "fused"])
def test_remote_dma_equals_collective_bitwise(mesh_case, local_kernel):
    nx, ny, T = mesh_case
    runs = [run_step(nx, ny, T, exchange=ex, overlap=True,
                     local_kernel=local_kernel) for ex in ENGINES]
    assert same(*runs)


@pytest.mark.parametrize("exchange", ENGINES)
def test_verified_equals_unchecked_bitwise(exchange):
    plain = run_step(2, 2, 2, exchange=exchange, overlap=True)
    verified, flags = run_step(2, 2, 2, exchange=exchange, overlap=True,
                               verify_integrity=True)
    assert same(plain, verified)
    assert flags.shape == (2, 2) and flags.tolist() == [[0, 0], [0, 0]]
    TD.check_integrity(flags)


@pytest.mark.parametrize("mesh_case", MESHES)
def test_parity_does_not_change_the_step(mesh_case):
    nx, ny, T = mesh_case
    even, odd = (run_step(nx, ny, T, exchange="remote_dma",
                          dma_block_index=k) for k in (0, 1))
    assert same(even, odd)


@pytest.mark.parametrize("mesh_case", MESHES)
@pytest.mark.parametrize("exchange", ENGINES)
def test_run_equals_sequential_steps(mesh_case, exchange):
    nx, ny, T = mesh_case
    u, v, w, p = inputs()
    mesh = loopback(nx, ny)
    K = 3
    kw = dict(T=T, dt=DT, exchange=exchange, overlap=True,
              local_kernel="fused")
    run = TD.make_distributed_run(mesh, p, n_blocks=K, **kw)
    got = TD.gather(mesh, run(TD.shard(mesh, u, v, w)))
    shards = TD.shard(mesh, u, v, w)
    for k in range(K):
        shards = TD.make_distributed_step(mesh, p, dma_block_index=k,
                                          **kw)(shards)
    assert same(got, TD.gather(mesh, shards))
    oracle = TD.reference_global_step(u, v, w, p, T=K * T, dt=DT)
    assert max_diff(got, oracle) < TOL


def test_verified_run_accumulates_over_blocks():
    u, v, w, p = inputs()
    mesh = loopback(2, 2)
    run = TD.make_distributed_run(mesh, p, n_blocks=2, T=2, dt=DT,
                                  verify_integrity=True)
    out, flags = run(TD.shard(mesh, u, v, w))
    plain = TD.make_distributed_run(mesh, p, n_blocks=2, T=2, dt=DT)
    assert same(TD.gather(mesh, out),
                TD.gather(mesh, plain(TD.shard(mesh, u, v, w))))
    assert flags.tolist() == [[0, 0], [0, 0]]


@pytest.mark.parametrize("exchange", ENGINES)
def test_2x2_corners_ride_phase_2(exchange):
    """The cells within T of both interior cuts depend on the diagonal
    shard; they come out right only if phase 2 sends the x-extended slab,
    and the counted bytes include the 2T extra columns of its rows."""
    X, Y, Z, T = 8, 8, 12, 2
    u, v, w = TSA.stratus_fields(X, Y, Z, seed=5, device="cpu")
    p = default_params(Z, device="cpu")
    mesh = loopback(2, 2)
    step = TD.make_distributed_step(mesh, p, T=T, dt=DT, exchange=exchange,
                                    local_kernel="fused", overlap=True)
    shards = TD.shard(mesh, u, v, w)
    out = TD.gather(mesh, step(shards))
    ref = TD.reference_global_step(u, v, w, p, T=T, dt=DT)
    win = (slice(X // 2 - T, X // 2 + T), slice(Y // 2 - T, Y // 2 + T))
    assert max_diff([o[win] for o in out], [r[win] for r in ref]) < TOL
    got = TD.count_exchange_wire_bytes(step, shards)
    assert got == TR.halo_wire_bytes_model(X, Y, Z, 4, nx=2, ny=2, T=T)
    no_corner = 3 * 4 * (2 * T * (Y // 2) * Z + 2 * T * (X // 2) * Z)
    assert got == no_corner + 3 * 4 * 2 * T * 2 * T * Z


# --- integrity --------------------------------------------------------------

@pytest.mark.parametrize("exchange", ENGINES)
def test_corrupt_halo_is_flagged_like_jax(jax_runs, exchange):
    fields = tuple(torch.from_numpy(jax_runs[f]) for f in "uvw") + (
        default_params(GRID[2], device="cpu"),)
    out, flags = run_step(2, 2, 2, fields=fields, exchange=exchange,
                          verify_integrity=True, corrupt_halo=CORRUPT)
    want = jax_runs[f"corrupt/{exchange}/flags"]
    assert flags.tolist() == want.tolist() and int(flags.sum()) == 4
    with pytest.raises(TD.HaloCorrupted, match="4 halo band checksum"):
        TD.check_integrity(flags)
    # the damage reached the fields, as in the reference
    assert max_diff(out, [jax_runs[f"corrupt/{exchange}/{f}"]
                          for f in "uvw"]) < TOL
    assert max_diff(out, run_step(2, 2, 2, fields=fields,
                                  exchange=exchange)) > 0.0


@pytest.mark.parametrize("exchange", ENGINES)
def test_corrupt_halo_unverified_changes_the_fields_only(exchange):
    damaged = run_step(2, 2, 2, exchange=exchange, corrupt_halo=CORRUPT)
    clean = run_step(2, 2, 2, exchange=exchange)
    assert not same(damaged, clean)


def test_check_integrity_passes_zero_flags():
    TD.check_integrity(torch.zeros((2, 2), dtype=torch.int64))
    TD.check_integrity(np.zeros(4, np.uint32))
    with pytest.raises(TD.HaloCorrupted):
        TD.check_integrity(np.array([0, 3], np.uint32))


# --- counted bytes == the models, exactly -----------------------------------

BYTE_CASES = [(2, 2, 2), (1, 4, 4), (4, 1, 3), (2, 2, 5), (1, 2, 7),
              (2, 1, 1)]


@pytest.mark.parametrize("mesh_case", BYTE_CASES)
@pytest.mark.parametrize("exchange", ENGINES)
def test_counted_bytes_equal_the_models(mesh_case, exchange):
    nx, ny, T = mesh_case
    X, Y, Z = GRID
    u, v, w, p = inputs()
    mesh = loopback(nx, ny)
    shards = TD.shard(mesh, u, v, w)
    model = TR.halo_wire_bytes_model(X, Y, Z, 4, nx=nx, ny=ny, T=T)
    assert model == TD.remote_dma_schedule_wire_bytes(
        X // nx, Y // ny, Z, 4, nx=nx, ny=ny, T=T)
    words = TR.integrity_bytes_model(X, Y, Z, nx=nx, ny=ny, T=T)
    for verify in (False, True):
        step = TD.make_distributed_step(mesh, p, T=T, dt=DT,
                                        exchange=exchange,
                                        verify_integrity=verify)
        assert TD.count_exchange_wire_bytes(step, shards) == model
        assert TD.count_integrity_bytes(step, shards) == \
            (words if verify else 0)
    run = TD.make_distributed_run(mesh, p, n_blocks=3, T=T, dt=DT,
                                  exchange=exchange, verify_integrity=True)
    assert TD.count_exchange_wire_bytes(run, shards) == model
    assert TD.count_integrity_bytes(run, shards) == words


# --- K7's plain version -----------------------------------------------------

def band_inputs(mesh, shape, seed):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  for _ in range(3)) for _ in mesh.devices]


@pytest.mark.parametrize("nx,ny,axis,dim,shape,depth", [
    (2, 2, "x", 0, (4, 6, 8), 2), (2, 2, "y", 1, (4, 6, 8), 3),
    (1, 4, "y", 1, (5, 3, 4), 7), (3, 1, "x", 0, (3, 4, 4), 7),
    (2, 1, "x", 1, (4, 5, 4), 1), (1, 2, "y", 0, (6, 4, 4), 4)])
def test_band_exchange_plain_lands_the_collective_bands(nx, ny, axis, dim,
                                                        shape, depth):
    """Each slot's halos hold what the collective engine moves for the same
    field, side and phase, its middle the shard itself; the other slot
    keeps its fill, over several blocks on the same slabs."""
    mesh = loopback(nx, ny)
    slabs = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5)
    for block in range(4):
        fields = band_inputs(mesh, shape, block)
        got = TK.halo_band_exchange_dma(fields, mesh=mesh, axis=axis,
                                        depth=depth, dim=dim,
                                        block_index=block, slabs=slabs)
        assert got == slabs.bands(block % 2)
        for f in range(3):
            want = TD._exchange_halos(mesh, [s[f] for s in fields], axis,
                                      depth, dim)
            for s in range(len(fields)):
                assert torch.equal(got[s][f][0], want[s][0])
                assert torch.equal(got[s][f][1], want[s][1])
                assert torch.equal(slabs.interior(block % 2)[s][f],
                                   fields[s][f])
                if block == 0:
                    assert bool((slabs.extended(1)[s][f] == -3.5).all())
        slabs.check()
    assert slabs.epoch == 0   # the plain version counts no kernel epochs


# (nx, ny, T): the step's meshes, x only, y only, and three hops a side
LANDING_MESHES = MESHES + ((2, 1, 2), (1, 2, 2), (1, 2, 6))


@pytest.mark.parametrize("mesh_case", LANDING_MESHES)
def test_extended_landing_equals_the_collective_cat_bitwise(mesh_case):
    """The remote_dma exchange lands each shard and its bands in K7's
    persistent buffers: over four blocks (both slots) every extended slab
    == the collective engine's `torch.cat` of the same phase, bit for bit,
    and the slot a block did not write keeps the last block's slab."""
    nx, ny, T = mesh_case
    mesh = loopback(nx, ny)
    dx, dy = (T if nx > 1 else 0), (T if ny > 1 else 0)
    p = default_params(GRID[2], device="cpu")
    blocks = {ex: TD._LocalBlock(mesh, p, T=T, dt=DT,
                                 local_kernel="reference", y_tile=None,
                                 overlap=True, exchange=ex)
              for ex in ENGINES}
    before = None
    for k in range(4):
        rng = np.random.default_rng(k)
        u, v, w = (torch.from_numpy(rng.normal(size=GRID).astype(np.float32))
                   for _ in range(3))
        shards = TD.shard(mesh, u, v, w)
        want = blocks["collective"]._exchange(shards, k, dx, dy)
        got = blocks["remote_dma"]._exchange(shards, k, dx, dy)
        assert all(torch.equal(a, b) for ga, wa in zip(got, want)
                   for a, b in zip(ga, wa))
        bufs = blocks["remote_dma"].buffers.bufs
        if before is not None:
            assert all(torch.equal(b[:, (k + 1) % 2], old)
                       for b, old in zip(bufs, before))
        before = [b[:, k % 2].clone() for b in bufs]


def test_remote_dma_extend_hands_k1_the_persistent_buffers():
    """The remote_dma phases return views of the block's own buffers (the
    slab K1 reads is where K7 stored), slot block % 2, and run no
    concatenation; the collective engine's phases do."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    u, v, w, p = inputs()
    mesh = loopback(2, 2)
    shards = TD.shard(mesh, u, v, w)
    seen = {}
    for ex in ENGINES:
        block = TD._LocalBlock(mesh, p, T=2, dt=DT, local_kernel="fused",
                               y_tile=None, overlap=True, exchange=ex)
        for k in range(3):
            with Ops() as ops:
                ext = block._exchange(shards, k, 2, 2)
            seen[ex] = ops.seen
            if ex == "remote_dma":
                for s, trio in enumerate(ext):
                    for f, t in enumerate(trio):
                        buf = block.buffers.bufs[s][f, k % 2]
                        assert t.data_ptr() == buf.data_ptr()
                        assert t.shape == buf.shape and t.is_contiguous()
    assert "cat" not in seen["remote_dma"]
    assert "cat" in seen["collective"]


def test_band_tables_are_kept_per_slot_and_shape():
    """A table is built once per (axis, slot, layout) and reused by the
    blocks that follow, never for another slot, layout or shape."""
    mesh = loopback(2, 2)
    shape = (4, 6, 8)
    slabs = TK.BandSlabs(mesh, shape, 2, 0)
    fields = band_inputs(mesh, shape, 0)
    t0 = slabs.table("x", 0, fields)
    t1 = slabs.table("x", 1, fields)
    assert t0 is slabs.table("x", 0, band_inputs(mesh, shape, 1))
    assert t1 is not t0 and (t0.slot, t1.slot) == (0, 1)
    assert t0.rows() is not None and t0.rows() != t1.rows()
    inner = slabs.table("x", 0, slabs.interior(0))
    assert inner.in_place and not t0.in_place and inner is not t0
    # slot 1's interior rows passed for slot 0 are not in place, and are
    # strided
    rows = TK.BandSlabs(mesh, shape, 2, 1)
    assert rows.table("y", 0, rows.interior(0)).in_place
    with pytest.raises(ValueError, match="must be contiguous"):
        rows.table("y", 0, rows.interior(1))
    assert slabs.table("y", 0, fields) is not t0
    assert not slabs.matches(mesh, (4, 6, 4), 2, 0)
    assert not slabs.matches(loopback(1, 4), shape, 2, 0)
    # a run on shards of a new shape builds new buffers, slabs and tables
    p = default_params(8, device="cpu")
    block = TD._LocalBlock(mesh, p, T=2, dt=DT, local_kernel="reference",
                           y_tile=None, overlap=False, exchange="remote_dma")
    u, v, w, _ = inputs()
    block(TD.shard(mesh, u, v, w), 0)
    first = (block.buffers, dict(block.slabs))
    block(TD.shard(mesh, u, v, w), 1)
    assert block.buffers is first[0] and block.slabs == first[1]
    wide = TSA.stratus_fields(8, 16, 8, seed=1, device="cpu")
    block(TD.shard(mesh, *wide), 0)
    assert block.buffers is not first[0]
    assert all(block.slabs[a] is not first[1][a] for a in "xy")
    assert block.slabs["x"].shape == (4, 8, 8)
    assert block.slabs["y"].shape == (8, 8, 8)


def replay(slabs, table, fields):
    """K7's copy loop over `table`'s rows, run on CPU memory: per row and
    run, `run` floats from the source base plus offset to the row's
    destination address (the kernel's addressing, without its threads)."""
    import ctypes
    for card, rows in table.rows().items():
        shards = [s for s, d in enumerate(slabs.devices) if d == card]
        bases = [f.data_ptr() for s in shards for f in fields[s]]
        tile = 0
        for row in rows:
            r = dict(zip(TK.BAND_COLUMNS, row))
            assert r["tile0"] == tile and r["arrive"] == 0
            units = -(-r["runs"] * r["run"] // 4)
            tile += -(-units // TK.BAND_TILE_UNITS)
            for o in range(r["runs"]):
                ctypes.memmove(
                    r["dst"] + 4 * o * r["dst_stride"],
                    bases[r["src"]] + 4 * (r["src_off"] + o * r["src_stride"]),
                    4 * r["run"])


@pytest.mark.parametrize("nx,ny,axis,dim,shape,depth", [
    (2, 2, "x", 0, (4, 6, 8), 2), (2, 2, "y", 1, (4, 6, 8), 3),
    (1, 4, "y", 1, (5, 3, 4), 7), (3, 1, "x", 0, (3, 4, 5), 7),
    (2, 1, "x", 1, (4, 5, 4), 1), (1, 2, "y", 0, (6, 4, 4), 4),
    (2, 2, "y", 0, (6, 5, 5), 2)])
@pytest.mark.parametrize("in_place", [False, True])
def test_band_table_rows_land_like_the_plain_version(nx, ny, axis, dim,
                                                     shape, depth,
                                                     in_place):
    """The rows the kernel reads (sources, offsets, destinations, runs,
    strides, tiles), replayed on the CPU, land every buffer of both slots
    bit for bit as the plain version does; 16-byte moves are marked only
    where Z is a multiple of 4."""
    mesh = loopback(nx, ny)
    got = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5)
    want = TK.BandSlabs(mesh, shape, depth, dim, fill=-3.5)
    for block in range(4):
        slot = block % 2
        fields = band_inputs(mesh, shape, 7 + block)
        if in_place:
            for sl in (got, want):
                for own, new in zip(sl.interior(slot), fields):
                    for a, b in zip(own, new):
                        a.copy_(b)
            src = (got.interior(slot), want.interior(slot))
        else:
            src = (fields, fields)
        table = got.table(axis, slot, src[0])
        assert table.in_place == in_place
        replay(got, table, src[0])
        TK._band_exchange_plain(src[1], want,
                                want.table(axis, slot, src[1]))
        assert all(torch.equal(a, b) for a, b in zip(got.buffers.bufs,
                                                     want.buffers.bufs))
        rows = [r for rs in table.rows().values() for r in rs]
        assert len(rows) == len(table.msgs) + (0 if in_place
                                                else 3 * nx * ny)
        for r in (dict(zip(TK.BAND_COLUMNS, row)) for row in rows):
            assert r["vec4"] == (r["run"] % 4 == 0
                                 and r["src_stride"] % 4 == 0
                                 and r["dst_stride"] % 4 == 0
                                 and r["src_off"] % 4 == 0
                                 and r["dst"] % 16 == 0)
            assert r["vec4"] or shape[2] % 4



def test_band_launch_plan_is_one_wave():
    assert TK.band_launch_plan(10_000, 132, 6) == 792
    assert TK.band_launch_plan(100, 132, 6) == 100
    assert TK.band_launch_plan(1, 132, 8) == 1
    with pytest.raises(ValueError, match="must be >= 1"):
        TK.band_launch_plan(0, 132, 8)


def test_block_masks_are_built_once():
    """The interior masks and the overlap select of each shard are built
    on the first block and reused by the next, for either local kernel;
    a new shard shape builds its own."""
    u, v, w, p = inputs()
    mesh = loopback(2, 2)
    for kernel in ("reference", "fused"):
        block = TD._LocalBlock(mesh, p, T=2, dt=DT, local_kernel=kernel,
                               y_tile=None, overlap=True,
                               exchange="remote_dma")
        shards = block(TD.shard(mesh, u, v, w), 0)[0]
        masks = dict(block._masks)
        block(shards, 1)
        assert len(masks) == 4 and block._masks == masks
        assert all(block._masks[k] is m for k, m in masks.items())
        ext, own, sel = masks[(0, 4, 6)]
        assert sel.shape == (4, 6, 1) and sel.dtype == torch.bool
        if kernel == "fused":
            assert [m.shape for m in ext] == [(8,), (10,)]
            assert [m.dtype for m in own] == [torch.float32] * 2
        else:
            assert ext.shape == (8, 10, 1) and own.shape == (4, 6, 1)
        block(TD.shard(mesh, *TSA.stratus_fields(8, 16, 8, seed=1,
                                                 device="cpu")), 0)
        assert len(block._masks) == 8


def test_band_messages_follow_the_schedule():
    mesh = loopback(1, 4)
    msgs = TK.band_messages(mesh, "y", 3, 7)
    assert len(msgs) == 4 * 3 * 2 * 3
    for m in msgs:
        assert m.cnt == (3 if m.k < 3 else 1)
        step = m.k if m.side == 0 else -m.k
        assert m.receiver == (m.sender + step) % 4
    # the recv offsets of one side partition its halo exactly
    for side in range(2):
        rows = sorted(r for m in msgs if m.sender == 0 and m.field == 0
                      and m.side == side
                      for r in range(m.dst_off, m.dst_off + m.cnt))
        assert rows == list(range(7))


def test_band_exchange_refusals():
    mesh = loopback(2, 2)
    fields = band_inputs(mesh, (4, 6, 8), 0)
    kw = dict(mesh=mesh, axis="x")
    with pytest.raises(ValueError, match="dim must be"):
        TK.halo_band_exchange_dma(fields, depth=1, dim=2, **kw)
    with pytest.raises(ValueError, match="depth must be"):
        TK.halo_band_exchange_dma(fields, depth=0, dim=0, **kw)
    with pytest.raises(ValueError, match="3 shards given"):
        TK.halo_band_exchange_dma(fields[:3], depth=1, dim=0, **kw)
    with pytest.raises(ValueError, match="not in mesh axes"):
        TK.halo_band_exchange_dma(fields, mesh=mesh, axis="z", depth=1,
                                  dim=0)
    slabs = TK.BandSlabs(mesh, (4, 6, 8), 2, 0)
    with pytest.raises(ValueError, match="slabs for shape"):
        TK.halo_band_exchange_dma(fields, depth=1, dim=0, slabs=slabs, **kw)
    odd = [fields[0], fields[1], fields[2],
           tuple(f[:, :5].contiguous() for f in fields[3])]
    with pytest.raises(ValueError, match="shard 3 has shape"):
        TK.halo_band_exchange_dma(odd, depth=1, dim=0, **kw)
    strided = [tuple(f.transpose(0, 1).contiguous().transpose(0, 1)
                     for f in trio) for trio in fields]
    with pytest.raises(ValueError, match="shard 0 u must be contiguous"):
        TK.halo_band_exchange_dma(strided, depth=1, dim=0, **kw)
    with pytest.raises(ValueError, match="buffers of"):
        TK.BandSlabs(mesh, (4, 6, 8), 2, 0,
                     buffers=TK.ExtendedBuffers(mesh, (4, 6, 8), (1, 0)))


def test_band_slabs_check_names_the_timeout():
    mesh = loopback(1, 2)
    slabs = TK.BandSlabs(mesh, (4, 6, 8), 2, 1)
    slabs.check()
    slabs.words[1][2] = 2
    with pytest.raises(RuntimeError, match="shard 1: a wait ran past its "
                                           "bound"):
        slabs.check()
    slabs.words[0][2] = 1
    with pytest.raises(RuntimeError, match="shard 0: a put waited"):
        slabs.check()


# --- refusals ---------------------------------------------------------------

def test_step_refusals():
    u, v, w, p = inputs()
    mesh = loopback(1, 4)
    shards = TD.shard(mesh, u, v, w)
    with pytest.raises(ValueError, match="exceeds the decomposable global Y"):
        TD.make_distributed_step(mesh, p, T=11)(shards)
    with pytest.raises(ValueError, match="exceeds the decomposable global X"):
        step = TD.make_distributed_step(loopback(4, 1), p, T=7)
        step(TD.shard(loopback(4, 1), u, v, w))
    with pytest.raises(ValueError, match="spec must be a StencilSpec"):
        TD.make_distributed_step(mesh, p, spec=object())
    with pytest.raises(ValueError, match="spec must be a StencilSpec"):
        TD.make_distributed_run(mesh, p, n_blocks=2, spec=object())
    with pytest.raises(ValueError, match="checkpointing is not wired to the "
                                         "spec-driven run"):
        TD.make_distributed_run(mesh, p, n_blocks=2, checkpoint_every=1,
                                checkpoint_dir="ck",
                                spec=TSP.pw_advection_spec(), spec_params=p)
    with pytest.raises(ValueError, match="come together"):
        TD.make_distributed_run(mesh, p, n_blocks=2, checkpoint_every=1)
    with pytest.raises(ValueError, match="n_blocks must be"):
        TD.make_distributed_run(mesh, p, n_blocks=0)
    with pytest.raises(ValueError, match="T must be"):
        TD.make_distributed_step(mesh, p, T=0)
    with pytest.raises(ValueError, match="local_kernel must be"):
        TD.make_distributed_step(mesh, p, local_kernel="wide")
    with pytest.raises(ValueError, match="exchange must be one of"):
        TD.make_distributed_step(mesh, p, exchange="nccl")
    with pytest.raises(ValueError, match="field index"):
        TD.make_distributed_step(mesh, p, corrupt_halo=(3, 1, 0.0))
    with pytest.raises(ValueError, match="depth must be"):
        TD.make_distributed_step(mesh, p, corrupt_halo=(0, 0, 0.0))
    with pytest.raises(ValueError, match="3 shards given"):
        TD.make_distributed_step(mesh, p)(shards[:3])
    with pytest.raises(ValueError, match="not divisible by mesh"):
        TD.shard(loopback(1, 5), u, v, w)
    # the CPU plain version takes both integrity knobs with remote_dma
    TD.make_distributed_step(mesh, p, exchange="remote_dma",
                             verify_integrity=True, corrupt_halo=(0, 1, 0.0))


def test_shard_gather_round_trip():
    u, v, w, _ = inputs()
    for nx, ny, _ in MESHES:
        mesh = loopback(nx, ny)
        shards = TD.shard(mesh, u, v, w)
        assert all(f.shape == (8 // nx, 12 // ny, 8) and f.is_contiguous()
                   for trio in shards for f in trio)
        assert same(TD.gather(mesh, shards), (u, v, w))


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
