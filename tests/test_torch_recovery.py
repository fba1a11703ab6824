"""The port's checkpointed distributed run (`make_distributed_run` with
`checkpoint_every` and `checkpoint_dir`), `resume_distributed_run` and
`serving.faults.resilient_distributed_run`, against the JAX reference on
CPU loopback meshes.

One child interpreter runs the JAX side on 4 forced host devices
(`tests/_subproc.py`'s env) with `local_kernel="reference"`: the
checkpointed run and its resume on the 2D (2, 2) mesh (axis "y", x_axis
"x": the reference's flag layout there is the port's (nx, ny)), a resume of
the block-2 checkpoint the port wrote, and the resilient run under each
plan of `PLANS`, whose `health()` it writes as JSON. The reference's own
gates are `tests/test_recovery_distributed.py` and the distributed-run
cases of `tests/test_faults.py`."""
import json
import textwrap

import numpy as np
import pytest
import torch

from _subproc import run_ok
from repro_torch.kernels.advection.ref import default_params
from repro_torch.launch import mesh as TM
from repro_torch.serving import faults as TF
from repro_torch.stencil import advection as TSA
from repro_torch.stencil import distributed as TD
from repro_torch.training import checkpoint as TC

TOL = 1e-5              # test_torch_distributed.py's
GRID, T, DT = (6, 16, 12), 2, 0.005       # test_recovery_distributed.py's
GRID_2D = (8, 12, 8)
ONE_SHARD_GRID = (6, 20, 12)              # test_faults.py's
CHIP_PLAN = ("exchange_stall@1:stalls=5,rung=remote_dma;"
             "nan_poison@2:persistent=false;cache_evict@2;"
             "device_loss@1:reshard_to=2;device_loss@3:reshard_to=4")
# name: (mesh (nx, ny), grid, T, n_blocks, plan, options). `ladder` is the
# rung the DegradationLadder starts on (None: ELASTIC_LADDER from its
# first), `default` makes it DEFAULT_LADDER's; `disk` snapshots through a
# checkpoint directory.
PLANS = {
    "degrade": ((1, 1), ONE_SHARD_GRID, 1, 3,
                "exchange_stall@1:stalls=5,rung=remote_dma;"
                "nan_poison@2:persistent=false",
                dict(default=True, max_retries=1)),
    "stall_exhausts": ((1, 1), ONE_SHARD_GRID, 1, 2,
                       "exchange_stall@0:stalls=9,rung=collective",
                       dict(default=True, ladder="collective",
                            max_retries=0)),
    "persistent_poison": ((1, 1), ONE_SHARD_GRID, 1, 3, "nan_poison@1",
                          dict(max_replays=2)),
    "all_kinds_one_shard": ((1, 1), ONE_SHARD_GRID, 1, 3,
                            "halo_corruption@0;nan_poison@1:persistent="
                            "false;cache_evict@1;device_loss@2:reshard_to=1;"
                            "exchange_stall@2:stalls=1,rung=remote_dma",
                            dict(default=True, disk=True, max_retries=2)),
    "clean": ((1, 4), GRID, T, 4, "", {}),
    "halo_corruption": ((1, 4), GRID, T, 4, "halo_corruption@2:field=v", {}),
    "elastic": ((1, 4), GRID, T, 4,
                "device_loss@1:reshard_to=2;device_loss@3:reshard_to=4", {}),
    "mesh_shrink": ((1, 4), GRID, T, 3,
                    "exchange_stall@1:stalls=9,rung=remote_dma;"
                    "exchange_stall@1:stalls=9,rung=collective",
                    dict(max_retries=1)),
    "chip_plan": ((1, 4), GRID, 4, 4, CHIP_PLAN, {}),
    "chip_halo": ((1, 4), GRID, 4, 4, "halo_corruption@2:field=v",
                  dict(ladder="collective", verify=True)),
    "chip_persistent": ((1, 4), GRID, 4, 4, "nan_poison@1", {}),
    "two_d": ((2, 2), GRID_2D, T, 4,
              "nan_poison@1:slot=1,persistent=false;device_loss@2:"
              "reshard_to=1;halo_corruption@3:field=w,depth=2",
              dict(disk=True)),
}

JAX_CHILD = textwrap.dedent("""
    import os, json, tempfile
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.launch.mesh import make_stencil_mesh, compat_make_mesh
    from repro.kernels.advection.ref import default_params
    from repro.stencil.advection import stratus_fields
    from repro.stencil import distributed as D
    from repro.serving import faults as F

    res, health = {}, {}
    # -- checkpoint and resume on the 2D mesh, both ways --------------------
    X, Y, Z = GRID_2D
    u, v, w = stratus_fields(X, Y, Z)
    p = default_params(Z)
    mesh = make_stencil_mesh(2, 2)
    for tag, ex, ver in CKPT_CASES:
        kw = dict(axis="y", x_axis="x", T=T, dt=DT, exchange=ex,
                  verify_integrity=ver)
        full = D.make_distributed_run(mesh, p, n_blocks=4, **kw)(u, v, w)
        d = os.path.join(JAX_CK, tag)
        D.make_distributed_run(mesh, p, n_blocks=2, checkpoint_every=2,
                               checkpoint_dir=d, **kw)(u, v, w)
        back = D.resume_distributed_run(mesh, p, u, v, w, n_blocks=4,
                                        checkpoint_dir=os.path.join(
                                            PORT_CK, tag), **kw)
        for f, a, b in zip("uvw", full, back):
            res[f"{tag}/full/{f}"] = np.asarray(a)
            res[f"{tag}/resumed_port/{f}"] = np.asarray(b)
        if ver:
            res[f"{tag}/full/flags"] = np.asarray(full[3])
            res[f"{tag}/resumed_port/flags"] = np.asarray(back[3])

    # -- the resilient run under each plan ----------------------------------
    for name, (shape, grid, t, n_blocks, plan, opt) in PLANS.items():
        X, Y, Z = grid
        u, v, w = stratus_fields(X, Y, Z, seed=3)
        p = default_params(Z)
        if shape == (1, 1):
            mesh, kw = compat_make_mesh((1,), ("data",)), {}
        elif shape[0] == 1:
            mesh, kw = make_stencil_mesh(*shape), dict(axis="y")
        else:
            mesh, kw = make_stencil_mesh(*shape), dict(axis="y",
                                                       x_axis="x")
        rungs = F.DEFAULT_LADDER if opt.get("default") else F.ELASTIC_LADDER
        ladder = F.DegradationLadder(rungs, start=opt.get("ladder"))
        inj = F.FaultInjector(F.FaultPlan.parse(plan))
        extra = {k: opt[k] for k in ("max_retries", "max_replays")
                 if k in opt}
        if opt.get("verify"):
            extra["verify_integrity"] = True
        with tempfile.TemporaryDirectory() as d:
            try:
                out, _ = F.resilient_distributed_run(
                    mesh, p, u, v, w, n_blocks=n_blocks, T=t, dt=DT,
                    injector=inj, ladder=ladder,
                    checkpoint_dir=d if opt.get("disk") else None,
                    **kw, **extra)
                raised = None
                for f, a in zip("uvw", out):
                    res[f"{name}/{f}"] = np.asarray(a)
            except F.RecoveryExhausted as e:
                raised = str(e)
        health[name] = {"health": inj.health(), "raised": raised}
    with open(HEALTH, "w") as fh:
        json.dump(health, fh)
    np.savez(OUT, **res)
    print("OK")
""")

# (tag, engine, verify_integrity) of the cross-package checkpoint cases
CKPT_CASES = (("remote_dma", "remote_dma", False),
              ("verified", "collective", True))


def loopback(nx, ny):
    return TM.make_stencil_mesh(nx, ny, devices=["cpu"] * (nx * ny))


def inputs(grid=GRID, seed=0):
    X, Y, Z = grid
    u, v, w = TSA.stratus_fields(X, Y, Z, seed=seed, device="cpu")
    return u, v, w, default_params(Z, device="cpu")


def same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def run_global(mesh, p, fields, **kw):
    """A distributed run of the global `fields`, gathered (and its flags,
    verified)."""
    out = TD.make_distributed_run(mesh, p, **kw)(TD.shard(mesh, *fields))
    if kw.get("verify_integrity"):
        return TD.gather(mesh, out[0]), out[1]
    return TD.gather(mesh, out)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The port writes its block-2 checkpoints first; then the JAX child
    runs (resuming them) and writes its own."""
    root = tmp_path_factory.mktemp("recovery")
    port_ck, jax_ck = root / "port_ck", root / "jax_ck"
    u, v, w, p = inputs(GRID_2D)
    mesh = loopback(2, 2)
    for tag, ex, ver in CKPT_CASES:
        TD.make_distributed_run(
            mesh, p, n_blocks=2, T=T, dt=DT, exchange=ex,
            verify_integrity=ver, checkpoint_every=2,
            checkpoint_dir=str(port_ck / tag))(TD.shard(mesh, u, v, w))
    out, health = root / "out.npz", root / "health.json"
    consts = (f"GRID_2D = {GRID_2D!r}\nT = {T}\nDT = {DT}\n"
              f"CKPT_CASES = {CKPT_CASES!r}\nPLANS = {PLANS!r}\n"
              f"PORT_CK = {str(port_ck)!r}\nJAX_CK = {str(jax_ck)!r}\n"
              f"OUT = {str(out)!r}\nHEALTH = {str(health)!r}\n")
    run_ok(consts + JAX_CHILD, timeout=300)
    with np.load(out) as r:
        arrays = {k: r[k] for k in r.files}
    return {"arrays": arrays, "health": json.loads(health.read_text()),
            "jax_ck": jax_ck}


# --- checkpointed runs and their resume --------------------------------------

def test_checkpoint_kwargs_come_together():
    _, _, _, p = inputs()
    mesh = loopback(1, 4)
    for kw in (dict(checkpoint_every=2), dict(checkpoint_dir="unused")):
        with pytest.raises(ValueError, match="together"):
            TD.make_distributed_run(mesh, p, n_blocks=2, T=T, dt=DT, **kw)
    with pytest.raises(ValueError, match="checkpoint_every must be"):
        TD.make_distributed_run(mesh, p, n_blocks=2, checkpoint_every=0,
                                checkpoint_dir="unused")


@pytest.mark.parametrize("local_kernel", ["reference", "fused"])
@pytest.mark.parametrize("engine", ["collective", "remote_dma"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_checkpointed_run_and_resume_bitwise(tmp_path, shape, engine,
                                             local_kernel):
    u, v, w, p = inputs(GRID if shape == (1, 4) else GRID_2D)
    mesh = loopback(*shape)
    kw = dict(T=T, dt=DT, exchange=engine, local_kernel=local_kernel)
    full = run_global(mesh, p, (u, v, w), n_blocks=5, **kw)
    ck = run_global(mesh, p, (u, v, w), n_blocks=5, checkpoint_every=2,
                    checkpoint_dir=str(tmp_path / "ck"), **kw)
    assert same(full, ck)
    # checkpoints at 0, 2, 4, 5; keep_last=3 keeps the last three
    assert sorted(d.name for d in (tmp_path / "ck").glob("step_*")) == [
        f"step_{b:09d}" for b in (2, 4, 5)]
    # stopped at block 3, resumed to 5: bitwise the uninterrupted run
    part = tmp_path / "part"
    run_global(mesh, p, (u, v, w), n_blocks=3, checkpoint_every=2,
               checkpoint_dir=str(part), **kw)
    shards = TD.shard(mesh, u, v, w)
    res = TD.resume_distributed_run(mesh, p, shards, n_blocks=5,
                                    checkpoint_dir=str(part),
                                    checkpoint_every=2, **kw)
    assert same(full, TD.gather(mesh, res))
    # the resume wrote its own checkpoints: resuming again is a no-op
    done = TD.resume_distributed_run(mesh, p, shards, n_blocks=5,
                                     checkpoint_dir=str(part), **kw)
    assert same(full, TD.gather(mesh, done))
    # and from an earlier step, replaying what followed it
    again = TD.resume_distributed_run(mesh, p, shards, n_blocks=5,
                                      checkpoint_dir=str(part), step=2,
                                      **kw)
    assert same(full, TD.gather(mesh, again))


def test_checkpointed_run_with_verify_carries_flags(tmp_path):
    u, v, w, p = inputs()
    mesh = loopback(1, 4)
    kw = dict(T=T, dt=DT, exchange="collective", verify_integrity=True)
    full, ffl = run_global(mesh, p, (u, v, w), n_blocks=4, **kw)
    run_global(mesh, p, (u, v, w), n_blocks=2, checkpoint_every=1,
               checkpoint_dir=str(tmp_path), **kw)
    res, rfl = TD.resume_distributed_run(mesh, p, TD.shard(mesh, u, v, w),
                                         n_blocks=4,
                                         checkpoint_dir=str(tmp_path), **kw)
    assert same(full, TD.gather(mesh, res))
    assert rfl.shape == ffl.shape == (1, 4) and int(rfl.sum()) == 0
    state, _ = TC.restore(tmp_path, {"mismatches": 0})
    assert state["mismatches"].dtype == np.uint32
    assert state["mismatches"].shape == (1, 4)


def test_checkpointed_run_state_is_the_reference_leaf_dict(tmp_path):
    u, v, w, p = inputs()
    mesh = loopback(1, 4)
    for ver in (False, True):
        d = tmp_path / str(ver)
        run_global(mesh, p, (u, v, w), n_blocks=3, T=T, dt=DT,
                   checkpoint_every=3, checkpoint_dir=str(d),
                   verify_integrity=ver)
        man = json.loads((d / "step_000000003" / "manifest.json").read_text())
        want = {"block": "int64", "parity": "int64", "u": "float32",
                "v": "float32", "w": "float32"}
        if ver:
            want["mismatches"] = "uint32"
        assert man["dtypes"] == want
        assert man["shapes"]["u"] == list(GRID)
        assert man["shapes"]["block"] == man["shapes"]["parity"] == []
        state, step = TC.restore(d, {k: 0 for k in want})
        assert step == 3 and int(state["block"]) == 3
        assert int(state["parity"]) == 1


def test_resume_refuses_tampered_snapshots(tmp_path):
    u, v, w, p = inputs()
    mesh = loopback(1, 4)
    kw = dict(T=T, dt=DT)
    shards = TD.shard(mesh, u, v, w)
    uu, vv, ww = (a.numpy() for a in (u, v, w))
    bad = {"u": uu, "v": vv, "w": ww, "block": np.int64(1),
           "parity": np.int64(0)}
    TC.save(tmp_path / "parity", bad, 1)
    with pytest.raises(ValueError, match="parity"):
        TD.resume_distributed_run(mesh, p, shards, n_blocks=4,
                                  checkpoint_dir=str(tmp_path / "parity"),
                                  **kw)
    bad["parity"] = np.int64(1)
    TC.save(tmp_path / "step", bad, 2)
    with pytest.raises(ValueError, match="block index"):
        TD.resume_distributed_run(mesh, p, shards, n_blocks=4,
                                  checkpoint_dir=str(tmp_path / "step"),
                                  **kw)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TD.resume_distributed_run(mesh, p, shards, n_blocks=4,
                                  checkpoint_dir=str(tmp_path / "void"),
                                  **kw)
    bad["u"] = uu[:, :8]
    TC.save(tmp_path / "shape", bad, 1)
    with pytest.raises(ValueError, match="the mesh's shards make"):
        TD.resume_distributed_run(mesh, p, shards, n_blocks=4,
                                  checkpoint_dir=str(tmp_path / "shape"),
                                  **kw)
    with pytest.raises(ValueError, match="n_blocks must be"):
        TD.resume_distributed_run(mesh, p, shards, n_blocks=0,
                                  checkpoint_dir=str(tmp_path / "step"))


# --- across packages, on the 2D mesh ------------------------------------------

@pytest.mark.parametrize("case", CKPT_CASES, ids=[c[0] for c in CKPT_CASES])
def test_port_resumes_the_reference_checkpoint(jax_side, case):
    tag, ex, ver = case
    u, v, w, p = inputs(GRID_2D)
    mesh = loopback(2, 2)
    out = TD.resume_distributed_run(
        mesh, p, TD.shard(mesh, u, v, w), n_blocks=4,
        checkpoint_dir=str(jax_side["jax_ck"] / tag), T=T, dt=DT,
        exchange=ex, verify_integrity=ver)
    a = jax_side["arrays"]
    want = [a[f"{tag}/full/{f}"] for f in "uvw"]
    got = TD.gather(mesh, out[0] if ver else out)
    assert max_diff(got, want) <= TOL
    if ver:
        assert np.array_equal(out[1].numpy(), a[f"{tag}/full/flags"])


@pytest.mark.parametrize("case", CKPT_CASES, ids=[c[0] for c in CKPT_CASES])
def test_reference_resumes_the_port_checkpoint(jax_side, case):
    tag, ex, ver = case
    u, v, w, p = inputs(GRID_2D)
    mesh = loopback(2, 2)
    full = run_global(mesh, p, (u, v, w), n_blocks=4, T=T, dt=DT,
                      exchange=ex, verify_integrity=ver)
    a = jax_side["arrays"]
    got = [a[f"{tag}/resumed_port/{f}"] for f in "uvw"]
    assert max_diff(full[0] if ver else full, got) <= TOL
    if ver:
        assert np.array_equal(full[1].numpy(), a[f"{tag}/resumed_port/flags"])


# --- the resilient run ---------------------------------------------------------

def resilient(name, local_kernel, tmp_path):
    """The port's resilient run under plan `name` of `PLANS`: (out or None,
    injector, the RecoveryExhausted message or None)."""
    shape, grid, t, n_blocks, plan, opt = PLANS[name]
    u, v, w, p = inputs(grid, seed=3)
    rungs = TF.DEFAULT_LADDER if opt.get("default") else TF.ELASTIC_LADDER
    inj = TF.FaultInjector(TF.FaultPlan.parse(plan))
    extra = {k: opt[k] for k in ("max_retries", "max_replays") if k in opt}
    if opt.get("verify"):
        extra["verify_integrity"] = True
    try:
        out, inj = TF.resilient_distributed_run(
            loopback(*shape), p, u, v, w, n_blocks=n_blocks, T=t, dt=DT,
            local_kernel=local_kernel,
            injector=inj, ladder=TF.DegradationLadder(
                rungs, start=opt.get("ladder")),
            checkpoint_dir=str(tmp_path) if opt.get("disk") else None,
            **extra)
        return out, inj, None
    except TF.RecoveryExhausted as e:
        return None, inj, str(e)


def clean_run(name, local_kernel):
    shape, grid, t, n_blocks, _, _ = PLANS[name]
    u, v, w, p = inputs(grid, seed=3)
    return run_global(loopback(*shape), p, (u, v, w), n_blocks=n_blocks,
                      T=t, dt=DT, local_kernel=local_kernel,
                      exchange="remote_dma")


@pytest.mark.parametrize("local_kernel", ["reference", "fused"])
@pytest.mark.parametrize("name", list(PLANS))
def test_resilient_run_health_equals_jax_and_fields_bitwise(
        jax_side, tmp_path, name, local_kernel):
    out, inj, raised = resilient(name, local_kernel, tmp_path)
    want = jax_side["health"][name]
    assert inj.health() == want["health"]
    assert raised == want["raised"]
    if raised is None:
        assert same(out, clean_run(name, local_kernel))
        a = jax_side["arrays"]
        assert max_diff(out, [a[f"{name}/{f}"] for f in "uvw"]) <= TOL


def test_resilient_run_keeps_its_promises():
    """Every fault applied, none skipped, and the caller's fields untouched
    (the poison writes into the run's own shards)."""
    u, v, w, p = inputs(ONE_SHARD_GRID, seed=3)
    keep = [f.clone() for f in (u, v, w)]
    plan = PLANS["all_kinds_one_shard"][4]
    out, inj = TF.resilient_distributed_run(
        loopback(1, 1), p, u, v, w, n_blocks=3, T=1, dt=DT, max_retries=2,
        ladder=TF.DegradationLadder(start="remote_dma"),
        injector=TF.FaultInjector(TF.FaultPlan.parse(plan)))
    h = inj.health()
    assert h["faults_injected"] == 5 and h["faults_skipped"] == 0
    assert h["rollbacks"] == 2 and h["snapshots"] >= 1
    assert same((u, v, w), keep)
    assert same(out, clean_run("all_kinds_one_shard", "reference"))


def test_resilient_run_disk_snapshots_equal_memory(tmp_path):
    u, v, w, p = inputs(GRID, seed=3)
    plan = "nan_poison@1:persistent=false;halo_corruption@2:field=w"
    outs = []
    for d in (None, str(tmp_path)):
        out, inj = TF.resilient_distributed_run(
            loopback(1, 4), p, u, v, w, n_blocks=4, T=T, dt=DT,
            checkpoint_every=2, checkpoint_dir=d,
            injector=TF.FaultInjector(TF.FaultPlan.parse(plan)))
        assert inj.health()["rollbacks"] == 2
        assert inj.health()["replayed_blocks"] == 1
        outs.append(out)
    assert same(*outs)
    assert sorted(x.name for x in tmp_path.glob("step_*")) == [
        f"step_{b:09d}" for b in (0, 2, 4)]


def test_resilient_run_refusals():
    u, v, w, p = inputs()
    mesh = loopback(1, 4)
    with pytest.raises(ValueError, match="ladder must start on an exchange"):
        TF.resilient_distributed_run(
            mesh, p, u, v, w, n_blocks=1,
            ladder=TF.DegradationLadder(TF.ELASTIC_LADDER,
                                        start="mesh_shrink"))
    with pytest.raises(ValueError, match="checkpoint_every must be"):
        TF.resilient_distributed_run(mesh, p, u, v, w, n_blocks=1,
                                     checkpoint_every=0)
    with pytest.raises(ValueError, match="max_replays must be"):
        TF.resilient_distributed_run(mesh, p, u, v, w, n_blocks=1,
                                     max_replays=-1)
    with pytest.raises(ValueError, match="cannot re-shard to ny=3"):
        TF.resilient_distributed_run(
            mesh, p, u, v, w, n_blocks=2, injector=TF.FaultInjector(
                TF.FaultPlan.parse("device_loss@1:reshard_to=3")))


def test_verify_defaults_to_cpu_shards_only(monkeypatch):
    """`verify_integrity=None` verifies on CPU shards (the plain K7 carries
    checksums); a CUDA mesh builds its steps unverified, which the ladder's
    remote_dma rung requires there. Read at the first step build, which
    needs no card (the shards are handed over on the CPU)."""
    calls = []

    def spy(mesh, params, **kw):
        calls.append(kw["verify_integrity"])
        raise RuntimeError("stop")

    monkeypatch.setattr(TD, "make_distributed_step", spy)
    monkeypatch.setattr(TD, "shard",
                        lambda m, *fs: [tuple(fs)] * len(m.devices))
    u, v, w, p = inputs()
    for dev in ("cpu", "cuda:0"):
        mesh = TM.make_stencil_mesh(1, 4, devices=[dev] * 4)
        with pytest.raises(RuntimeError, match="stop"):
            TF.resilient_distributed_run(mesh, p, u, v, w, n_blocks=1)
    assert calls == [True, False]


# --- the reshard's mesh --------------------------------------------------------

@pytest.mark.parametrize("dev", ["cpu", "cuda:0"])
def test_resize_keeps_a_loopback_mesh_on_its_device(dev):
    mesh = TM.make_stencil_mesh(1, 4, devices=[dev] * 4)
    for nx, ny in ((1, 2), (1, 1), (2, 4), (1, 4)):
        m = TF._resized_mesh(mesh, nx, ny)
        assert m.shape == (nx, ny)
        assert set(m.devices) == {torch.device(dev)}
    # a mesh of distinct cards asks for distinct cards again
    spread = TM.StencilMesh((1, 2), (torch.device("cuda", 0),
                                     torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="needs 4 devices"):
        TF._resized_mesh(spread, 1, 4)
