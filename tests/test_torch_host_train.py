"""Training on every card of the host (`launch.ranks`, `launch.train`
under a process group) and the leaf-by-leaf checkpoint
(`training.checkpoint` under a `DeviceMesh`), on gloo ranks on the CPU.

  (a) the reference's `train_loop` runs on four forced host devices (its
      host mesh (4, 1)) on the qwen3-32b and falcon-mamba-7b smoke
      configs in f32 compute, checkpointing at step 2 and going on to
      step 5; the port resumes from that step-2 checkpoint on four gloo
      ranks at (4, 1) (`make_host_mesh()`), at (2, 2) and in one process
      with no group: each step's loss within TOL_REL_F32 of the
      reference's, each leaf of the port's step-5 checkpoint within
      TOL_REL_F32 of the largest |value| of the reference's leaf (the
      ssm family: or within WITNESS_K times the reference's own f32 error,
      below). The reference's checkpoint restored onto (4, 1) leaf by leaf
      equals its one-process restore bitwise;
  (b) at (4, 1), 2 steps, a checkpoint, a resume to 4 == 4 steps straight,
      bitwise (losses, every rank's blocks of the final state);
  (c) a save under the mesh holds at most one whole leaf on any rank (a
      counting wrapper of `sharding.gather`), ranks other than 0 write
      nothing, and the archive equals, bitwise, the one a single process
      writes of the same state gathered whole; a restore reads each leaf
      once on each rank and gives back every rank's blocks bitwise;
  (d) `python -m repro_torch.launch.train` in two interpreters with
      `torchrun`'s variables trains as one run: both exit 0, one log, one
      checkpoint; a function that raises on rank 1 of `ranks.spawn`'s
      gloo ranks fails the call.

Every world starts at once in one module fixture; this process runs the
one-process resumes while the ranks run.

The ssm family's f32 gradient is conditioned about 20x worse than the
dense one's: at the smoke weights both packages' f32 gradients lie
1.5e-5 to 7.4e-5 of each leaf's largest |value| off the reference's f64
one (the dense family's 1e-6 to 2e-6 off each other), and three AdamW
steps (the update's m / sqrt(v) turns small gradients' relative errors
into whole steps) take the reference's own f32 run up to 3.5e-3 of a
leaf's largest |value| off its run in f64 compute. So for WITNESS_ARCHS
a child runs the reference from the same step-2 checkpoint in f64 compute
(`jax_enable_x64`), and a leaf may also lie within WITNESS_K times the
reference's f32 drift from it: each run within its own rounding of the
exact one, the two within the sum, the port's own rounding taken no
larger than the reference's (the worst leaf reads 1.67x at world 1).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from _subproc import ENV
from test_torch_pipeline import collect_ranks, start_ranks

from repro_torch import pspec as TP
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train_loop
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as TC
from repro_torch.training import step as TS

ROOT = Path(__file__).resolve().parents[1]
TOL_REL_F32 = 2e-5           # the reference's TOL_REL["float32"]
ARCHS = ("qwen3-32b", "falcon-mamba-7b")
MESHES = ("(4, 1)", "(2, 2)")
STEPS, RESUME_AT, B, S = 5, 2, 4, 32
TIMEOUT = 240
WITNESS_ARCHS = ("falcon-mamba-7b",)
WITNESS_K = 2.0

REFERENCE = f"""
import json, os, sys
from repro.configs import get_smoke_config
from repro.launch.train import train_loop
arch, out = sys.argv[1], sys.argv[2]
cfg = get_smoke_config(arch).replace(compute_dtype="float32")
_, hist, _ = train_loop(cfg, steps={STEPS}, batch={B}, seq={S},
                        ckpt_dir=os.path.join(out, "ck"),
                        ckpt_every={RESUME_AT}, log_every=0)
with open(os.path.join(out, "losses.json"), "w") as f:
    json.dump(hist, f)
print("OK")
"""

# the reference from its own step-2 checkpoint to step 5 in f64 compute
WITNESS = f"""
import os, shutil, sys, time
import jax
jax.config.update("jax_enable_x64", True)
from repro.configs import get_smoke_config
from repro.launch.train import train_loop
arch, src, out = sys.argv[1], sys.argv[2], sys.argv[3]
ref = os.path.join(src, "step_{RESUME_AT:09d}")
t0 = time.time()
while not os.path.exists(os.path.join(ref, "manifest.json")):
    if time.time() - t0 > {TIMEOUT}:
        raise TimeoutError(f"no reference checkpoint at {{ref}}")
    time.sleep(0.2)
shutil.copytree(ref, os.path.join(out, "step_{RESUME_AT:09d}"))
cfg = get_smoke_config(arch).replace(compute_dtype="float64")
train_loop(cfg, steps={STEPS}, batch={B}, seq={S}, ckpt_dir=out,
           ckpt_every={STEPS}, log_every=0)
print("OK")
"""

RANKS = f"""
    import shutil
    import time
    import weakref
    from pathlib import Path
    from repro_torch import pspec as TP
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as TM
    from repro_torch.training import checkpoint as TC
    from repro_torch.training import optimizer as TO
    from repro_torch.training import step as TS
    WORK = Path(os.environ["WORK"])
    rules = make_rules(multi_pod=False)
    meshes = {{"(4, 1)": make_host_mesh(device="cpu"),
              "(2, 2)": make_host_mesh(model=2, device="cpu")}}
    mesh = meshes["(4, 1)"]
    OUT["mesh"] = tuple(mesh.shape)
    leaves = lambda t: TP.tree_leaves(t, is_leaf=torch.is_tensor)

    # (c) a save and a restore under the mesh, leaf by leaf
    cfg = get_smoke_config("qwen3-32b")
    lo = TM.make_layout(cfg, 1)
    state = TS.init_sharded_state(cfg, lo, torch.Generator().manual_seed(0),
                                  rules, mesh)
    OUT["own_bytes"] = [
        (t.to_local().untyped_storage().nbytes(),
         t.to_local().numel() * t.element_size()) for t in leaves(state)]
    alive, seen = set(), {{"peak": 0, "gathers": 0}}
    gather, save = SH.gather, TC.save

    def counting(x):
        full = gather(x)
        if SH.is_dtensor(x):
            seen["gathers"] += 1
            alive.add(id(full))
            seen["peak"] = max(seen["peak"], len(alive))
            weakref.finalize(full, alive.discard, id(full))
        return full
    writes = []

    def saving(d, st, step, **kw):
        writes.append(step)
        return save(d, st, step, **kw)
    SH.gather, TC.save = counting, saving
    ck = TC.AsyncCheckpointer(WORK / "leafwise", writer=RANK == 0)
    ck.save(state, 7, cfg=cfg, layout=lo)
    ck.wait()
    SH.gather, TC.save = gather, save
    ranks.barrier()
    whole = TP.gather_tree(state)
    if RANK == 0:
        TC.save(WORK / "whole", whole, 7, cfg=cfg, layout=lo)
    del whole
    OUT["save"] = dict(seen, writes=writes, leaves=len(leaves(state)))
    reads = {{}}
    getitem = np.lib.npyio.NpzFile.__getitem__

    def reading(self, key):
        reads[key] = reads.get(key, 0) + 1
        return getitem(self, key)
    np.lib.npyio.NpzFile.__getitem__ = reading
    back, step = TC.restore_placed(WORK / "leafwise",
                                   TS.state_specs(cfg, lo), rules, mesh,
                                   cfg=cfg, layout=lo)
    np.lib.npyio.NpzFile.__getitem__ = getitem
    OUT["restore"] = dict(reads=reads, step=step, equal=all(
        a.placements == b.placements and torch.equal(a.to_local(),
                                                     b.to_local())
        for a, b in zip(leaves(back), leaves(state))))
    del state, back

    # (b) a resume == the run straight through, bitwise
    cfg = get_smoke_config("falcon-mamba-7b")
    kw = dict(batch={B}, seq={S}, mesh=mesh, log_every=0, seed=99,
              device="cpu", opt=TO.OptConfig(peak_lr=1e-3, warmup_steps=0,
                                             total_steps=4))
    full, h_full, _ = train_loop(cfg, steps=4, **kw)
    d = WORK / "resume"
    _, h1, _ = train_loop(cfg, steps=2, ckpt_dir=d, ckpt_every=2, **kw)
    latest = TC.latest_step(d)
    resumed, h2, _ = train_loop(cfg, steps=4, ckpt_dir=d, ckpt_every=2,
                                **kw)
    OUT["resume"] = dict(full=h_full, parts=h1 + h2, latest=latest,
                         final=TC.latest_step(d), equal=all(
                             torch.equal(a.to_local(), b.to_local())
                             for a, b in zip(leaves(full), leaves(resumed))))
    del full, resumed

    # (a) the reference's step-2 checkpoints, resumed on each mesh
    OUT["a"] = {{}}
    for arch in {ARCHS!r}:
        ref = WORK / f"ref_{{arch}}" / "ck" / "step_{RESUME_AT:09d}"
        t0 = time.time()
        while not (ref / "manifest.json").exists():
            if time.time() - t0 > {TIMEOUT}:
                raise TimeoutError(f"no reference checkpoint at {{ref}}")
            time.sleep(0.2)
        cfg = get_smoke_config(arch).replace(compute_dtype="float32")
        lo = TM.make_layout(cfg, 1)
        back, _ = TC.restore_placed(ref.parent, TS.state_specs(cfg, lo),
                                    rules, mesh, step={RESUME_AT}, cfg=cfg,
                                    layout=lo)
        whole = TP.gather_tree(back)
        if RANK == 0:
            OUT["a"][arch, "restored"] = whole
        del back, whole
        for tag, m in meshes.items():
            d = WORK / f"port_{{arch}}_{{tag[1]}}x{{tag[4]}}"
            if RANK == 0:
                shutil.copytree(ref, d / ref.name)
            ranks.barrier()
            _, hist, _ = train_loop(cfg, steps={STEPS}, batch={B}, seq={S},
                                    ckpt_dir=d, ckpt_every={STEPS},
                                    mesh=m, log_every=0, device="cpu")
            OUT["a"][arch, tag] = dict(losses=hist, dir=str(d))
"""

# `python -m repro_torch.launch.train` as the command runs it, with the
# visible cards taken as two so that it spawns two ranks itself (on gloo)
SPAWNED_CLI = """
import runpy, sys
from repro_torch.launch import ranks
ranks.ranks_wanted = lambda device: 2
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.train", run_name="__main__",
                 alter_sys=True)
"""

BOOM = """
import time

import torch.distributed as dist


def boom():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(10 * 60)   # ended by the launcher, long before this
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(cmd, env, cwd=None):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=cwd)


def finish(p, what: str):
    """(returncode, stdout, stderr) of a started child, killed past
    TIMEOUT."""
    try:
        out, err = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        raise AssertionError(f"{what} timed out")
    return p.returncode, out, err


def archive(d: Path, step: int):
    """{key: raw bytes of the member} and the manifest (its time left out)
    of a checkpoint."""
    path = d / f"step_{step:09d}"
    with zipfile.ZipFile(path / "arrays.npz") as z:
        members = {n: z.read(n) for n in z.namelist()}
    manifest = json.loads((path / "manifest.json").read_text())
    manifest.pop("time")
    return members, manifest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_train")
    torch_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     OMP_NUM_THREADS="1")
    jax_env = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {}
    try:
        for arch in ARCHS:
            out = tmp / f"ref_{arch}"
            out.mkdir()
            procs[arch] = start([sys.executable, "-c", REFERENCE, arch,
                                 str(out)], jax_env, cwd=ROOT)
            if arch in WITNESS_ARCHS:
                (tmp / f"f64_{arch}").mkdir()
                procs["f64", arch] = start(
                    [sys.executable, "-c", WITNESS, arch, str(out / "ck"),
                     str(tmp / f"f64_{arch}")], jax_env, cwd=ROOT)
        world = start_ranks(RANKS, 4, tmp, "host", env={"WORK": str(tmp)})
        procs.update({f"rank{r}": p for r, (p, _) in enumerate(world[1])})
        port = free_port()
        cli = ["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
               "--steps", "3", "--batch", "4", "--seq", "32", "--ckpt-dir"]
        for r in range(2):
            procs[f"cli{r}"] = start(
                [sys.executable, "-m", "repro_torch.launch.train"] + cli
                + [str(tmp / "cli")],
                dict(torch_env, RANK=str(r), WORLD_SIZE="2",
                     LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)))
        procs["clispawn"] = start(
            [sys.executable, "-c", SPAWNED_CLI] + cli
            + [str(tmp / "clispawn")], torch_env)
        (tmp / "boomfn.py").write_text(BOOM)
        procs["spawn"] = start(
            [sys.executable, "-c", "import boomfn\n"
             "from repro_torch.launch import ranks\n"
             "ranks.spawn(boomfn.boom, (), world=2, device='cpu')\n"],
            dict(torch_env, PYTHONPATH=f"{ROOT / 'src'}:{tmp}"))
        out = {"tmp": tmp}
        for arch in ARCHS:
            rc, so, se = finish(procs.pop(arch), f"reference {arch}")
            assert rc == 0 and "OK" in so, se[-3000:]
            out["ref", arch] = json.loads(
                (tmp / f"ref_{arch}" / "losses.json").read_text())
            # one process, no group: the reference's one-device host
            cfg = get_smoke_config(arch).replace(compute_dtype="float32")
            d = tmp / f"port_{arch}_1"
            step = tmp / f"ref_{arch}" / "ck" / f"step_{RESUME_AT:09d}"
            shutil.copytree(step, d / step.name)
            _, hist, _ = train_loop(cfg, steps=STEPS, batch=B, seq=S,
                                    ckpt_dir=d, ckpt_every=STEPS,
                                    log_every=0, device="cpu")
            out["a"] = out.get("a", {})
            out["a"][arch, "1"] = dict(losses=hist, dir=str(d))
        for arch in WITNESS_ARCHS:
            rc, so, se = finish(procs.pop(("f64", arch)), f"f64 {arch}")
            assert rc == 0 and "OK" in so, se[-3000:]
        for name in ("cli0", "cli1", "clispawn", "spawn"):
            out[name] = finish(procs.pop(name), name)
        ranks_out = collect_ranks(world, TIMEOUT)
        procs.clear()
    finally:
        for p in procs.values():
            p.kill()
    out["ranks"] = ranks_out
    for arch in ARCHS:
        for tag in MESHES:
            out["a"][arch, tag] = ranks_out[0]["a"][arch, tag]
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("where", MESHES + ("1",))
def test_resume_from_the_references_checkpoint(runs, arch, where):
    """(a): each step's loss and each leaf of the step-5 checkpoint within
    TOL_REL_F32 of the reference's four-device run."""
    want = runs["ref", arch][RESUME_AT:]
    got = runs["a"][arch, where]
    assert len(got["losses"]) == len(want) == STEPS - RESUME_AT
    for g, w in zip(got["losses"], want):
        assert abs(g - w) <= TOL_REL_F32 * abs(w), (got["losses"], want)
    assert TC.latest_step(got["dir"]) == STEPS
    mine, ref, bounds = step5_leaves(runs, arch, got["dir"])
    for a, b, bound in zip(mine, ref, bounds):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float(np.abs(a - b).max()) <= bound


def step5_leaves(runs, arch, port_dir):
    """The port's step-5 leaves in `port_dir`, the reference's, and each
    leaf's bound: TOL_REL_F32 of the reference leaf's largest |value|,
    for WITNESS_ARCHS or WITNESS_K times the reference's own f32 drift
    from its f64-compute run, whichever is larger."""
    like = abstract_state(arch)
    mine, _ = TC.restore(port_dir, like, step=STEPS)
    ref, _ = TC.restore(runs["tmp"] / f"ref_{arch}" / "ck", like, step=STEPS)
    witness = (TC.restore(runs["tmp"] / f"f64_{arch}", like, step=STEPS)[0]
               if arch in WITNESS_ARCHS else None)
    mine, ref = array_leaves(mine), array_leaves(ref)
    witness = array_leaves(witness) if witness else [None] * len(ref)
    assert len(mine) == len(ref) == len(witness)
    bounds = []
    for b, w in zip(ref, witness):
        bound = TOL_REL_F32 * float(np.abs(b).max())
        if w is not None:
            bound = max(bound, WITNESS_K * float(np.abs(b - w).max()))
        bounds.append(bound)
    return mine, ref, bounds


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fault", ("last update skipped",
                                   "last learning rate halved"))
def test_leaf_gate_fails_a_planted_fault(runs, arch, fault):
    """The leaf gate of (a) fails a wrong program: the port's step-5 state
    (world 1) with its last update undone, or with half of it undone (the
    last step's learning rate halved), the last update taken as the
    reference's step 4 -> 5 change. Every params leaf must then lie
    outside its bound (the ssm family's looser bound included), and with
    the update skipped every moment leaf too."""
    keys = [k for k, _ in TC._flatten_with_paths(abstract_state(arch))]
    mine, ref, bounds = step5_leaves(runs, arch, runs["a"][arch, "1"]["dir"])
    ref4 = array_leaves(TC.restore(runs["tmp"] / f"ref_{arch}" / "ck",
                                   abstract_state(arch), step=4)[0])
    undone = 1.0 if fault == "last update skipped" else 0.5
    checked = 0
    for k, a, b, b4, bound in zip(keys, mine, ref, ref4, bounds):
        if k == "opt/step" or (undone < 1 and not k.startswith("params/")):
            continue     # the counter; the moments do not see the rate
        bad = a - undone * (b - b4)
        assert float(np.abs(bad - b).max()) > bound, (k, bound)
        checked += 1
    assert checked > 0


def test_a_checkpoint_keeps_no_leaf_alive(tmp_path):
    """A save and a restore leave no reference cycle that holds the
    state: with the cyclic collector off, every leaf of a dropped state
    is freed at once (a sharded state's blocks on the card would
    otherwise stay allocated until the collector runs)."""
    import gc
    import weakref
    state = {"params": {"w": torch.ones(4, 3), "b": [torch.zeros(2)]},
             "opt": {"step": torch.tensor(3)}}
    gc.disable()
    try:
        ck = TC.AsyncCheckpointer(tmp_path)
        ck.save(state, 3)
        ck.wait()
        back, step = TC.restore(tmp_path, state)
        assert step == 3
        refs = [weakref.ref(t) for t in TP.tree_leaves(
            state, is_leaf=torch.is_tensor)]
        del state, back, ck
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def abstract_state(arch):
    cfg = get_smoke_config(arch)
    return TP.abstract_params(TS.state_specs(cfg, TM.make_layout(cfg, 1)))


def array_leaves(tree) -> list:
    return TP.tree_leaves(tree, is_leaf=lambda a: isinstance(a, np.ndarray))


@pytest.mark.parametrize("arch", ARCHS)
def test_references_checkpoint_restores_onto_the_mesh_bitwise(runs, arch):
    """The reference's step-2 checkpoint, restored onto (4, 1) leaf by
    leaf and gathered, == its one-process restore, bitwise."""
    want, _ = TC.restore(runs["tmp"] / f"ref_{arch}" / "ck",
                         abstract_state(arch), step=RESUME_AT)
    g = TP.tree_leaves(runs["ranks"][0]["a"][arch, "restored"],
                       is_leaf=torch.is_tensor)
    w = array_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert np.array_equal(a.numpy(), b) and a.numpy().dtype == b.dtype


def test_resume_equals_uninterrupted_on_four_ranks(runs):
    """(b): 2 steps, a checkpoint, a resume to 4 == 4 straight, bitwise,
    on every rank."""
    for r in runs["ranks"]:
        assert r["mesh"] == (4, 1)
        res = r["resume"]
        assert res["latest"] == 2 and res["final"] == 4
        assert len(res["full"]) == 4 and res["full"] == res["parts"]
        assert res["equal"]


def test_save_holds_one_whole_leaf_and_only_rank_0_writes(runs):
    """(c): at most one gathered leaf alive at once, one gather a leaf,
    one write, by rank 0."""
    for r, out in enumerate(runs["ranks"]):
        save = out["save"]
        assert save["peak"] == 1 and save["gathers"] == save["leaves"]
        assert save["writes"] == ([7] if r == 0 else [])


def test_placed_blocks_hold_their_own_bytes_only(runs):
    """A state drawn onto (4, 1) leaf by leaf keeps each rank's block in
    storage of its own: no block is a view that keeps its whole drawn
    leaf alive (a leaf split on its first dimension, `lm_head`)."""
    for out in runs["ranks"]:
        assert out["own_bytes"] and all(
            held == own for held, own in out["own_bytes"])


def test_mesh_archive_equals_one_process_archive(runs):
    """(c): the archive written under the mesh == the one a single process
    writes of the same state, member for member, bitwise."""
    tmp = runs["tmp"]
    got_members, got_manifest = archive(tmp / "leafwise", 7)
    want_members, want_manifest = archive(tmp / "whole", 7)
    assert got_manifest == want_manifest
    assert got_members.keys() == want_members.keys()
    assert all(got_members[k] == want_members[k] for k in want_members)
    assert sorted(p.name for p in (tmp / "leafwise").iterdir()) == \
        ["LATEST", "step_000000007"]


def test_restore_reads_each_leaf_once_per_rank(runs):
    """(c): a restore under the mesh reads each stored leaf once and gives
    back every rank's blocks bitwise."""
    _, manifest = archive(runs["tmp"] / "leafwise", 7)
    for out in runs["ranks"]:
        res = out["restore"]
        assert res["step"] == 7 and res["equal"]
        assert res["reads"] == {k: 1 for k in manifest["keys"]}


def test_cli_under_torchrun_variables_is_one_run(runs):
    """(d): two interpreters with torchrun's variables: both exit 0, the
    log once (rank 0's), one checkpoint."""
    (rc0, out0, err0), (rc1, out1, err1) = runs["cli0"], runs["cli1"]
    assert rc0 == 0, err0[-3000:]
    assert rc1 == 0, err1[-3000:]
    assert "[train] done: first loss" in out0 and "(0 skipped)" in out0
    assert "[train]" not in out1
    assert out0.count("[train] done") == 1
    d = runs["tmp"] / "cli"
    assert TC.latest_step(d) == 3
    assert sorted(p.name for p in d.iterdir()) == ["LATEST",
                                                   "step_000000003"]


def test_cli_spawning_its_own_ranks_is_one_run(runs):
    """(d): the command with two cards taken as visible spawns two ranks
    itself (its `_run` pickled from `__main__`): exit 0, one log, one
    checkpoint, and the same losses as the run under torchrun's
    variables on the same (2, 1) mesh, bitwise."""
    rc, out, err = runs["clispawn"]
    assert rc == 0, err[-3000:]
    assert out.count("[train] done") == 1
    steps = [ln.split(" (")[0] for ln in out.splitlines()
             if ln.startswith("[train] step")]
    assert steps and steps == [ln.split(" (")[0] for ln in
                               runs["cli0"][1].splitlines()
                               if ln.startswith("[train] step")]
    d = runs["tmp"] / "clispawn"
    assert sorted(p.name for p in d.iterdir()) == ["LATEST",
                                                   "step_000000003"]


def test_a_failing_spawned_rank_fails_the_call(runs):
    """(d): a rank that raises under `ranks.spawn` makes the
    parent raise: a non-zero exit, the rank's error in its output, the
    other rank ended with it (the child exits within the fixture's
    TIMEOUT, where rank 0 alone would sleep ten minutes)."""
    rc, _, err = runs["spawn"]
    assert rc != 0 and "rank 1 fails on purpose" in err


def test_launch_without_torchrun_or_cards_is_this_process(monkeypatch):
    """With no `torchrun` variables and no card, `launch` runs the work in
    this process with no group; the variables, all set, mean `torchrun`."""
    import torch.distributed as dist

    from repro_torch.launch import ranks
    for v in ranks.TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not ranks.under_torchrun()
    assert ranks.ranks_wanted("cpu") == ranks.ranks_wanted("cuda") == 1
    assert (ranks.backend_of("cpu"), ranks.backend_of("cuda")) == \
        ("gloo", "nccl")
    seen = []
    assert ranks.launch(lambda x: seen.append(dist.is_initialized()) or x,
                        (5,), device="cpu") == 5 and seen == [False]
    for v in ranks.TORCHRUN_VARS[:-1]:
        monkeypatch.setenv(v, "0")
    assert not ranks.under_torchrun()
    monkeypatch.setenv(ranks.TORCHRUN_VARS[-1], "29500")
    assert ranks.under_torchrun()
