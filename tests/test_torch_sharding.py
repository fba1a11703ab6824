"""The port's logical-axis sharding rules against the JAX package's, on the
CPU: `make_rules`, `spec_for` (its divisibility guard, each axis used
once), the full-width parameter and moment specs of every config in the
registry on both production mesh shapes, and the DTensor placements of
`sharding_for` against the index blocks JAX hands each device of a
(2, 2, 2) pod/data/model mesh.

The placement and mesh cases run on a "fake" process group (one rank at a
time, in this process), destroyed after each case so that no group leaks
into later tests of the worker. Specs are compared as tuples: the port's
`PartitionSpec` is a tuple, JAX's a tuple subclass."""
import itertools
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _prop import given, settings, st

from repro import pspec as JP
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as JSH
from repro.models import model as JM
from repro.training import step as JS
from repro_torch import pspec as TP
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.training import step as TS


class FakeMesh:
    """Duck-typed mesh exposing .shape mapping (enough for spec_for)."""
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
PROD_SHAPES = ({"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16})
PLACED_ARCHS = ("qwen3-32b", "arctic-480b")
MESH8 = ((2, 2, 2), ("pod", "data", "model"))


def as_tuple(spec):
    return tuple(spec)


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod,fsdp_over_pod,seq_shard,seq_parallel",
                         list(itertools.product((False, True), repeat=4)))
def test_make_rules_equal_reference(multi_pod, fsdp_over_pod, seq_shard,
                                    seq_parallel):
    kw = dict(multi_pod=multi_pod, fsdp_over_pod=fsdp_over_pod,
              seq_shard=seq_shard, seq_parallel=seq_parallel)
    assert SH.make_rules(**kw) == JSH.make_rules(**kw)
    assert SH.make_rules(shape_kind="decode", **kw) == \
        JSH.make_rules(shape_kind="decode", **kw)


def test_rules_basic_and_guard():
    r = SH.make_rules(multi_pod=True)
    assert r["batch"] == ("pod", "data")
    assert SH.spec_for((256, 4096), ("batch", None), r, MESH) == \
        (("pod", "data"), None)
    r = SH.make_rules(multi_pod=False)
    # 40 heads do not divide 16: the axis is dropped, not an error
    assert SH.spec_for((40, 128), ("heads", None), r, MESH) == (None, None)
    assert SH.spec_for((64, 128), ("heads", None), r, MESH) == \
        ("model", None)
    # both dims map to model: the second use is dropped
    assert SH.spec_for((64, 64), ("heads", "ffn"), r, MESH) == \
        ("model", None)


@settings(max_examples=100, deadline=None)
@given(dims=st.lists(st.integers(1, 512), min_size=1, max_size=4),
       names=st.lists(st.sampled_from(["batch", "heads", "ffn", "embed",
                                       "vocab", None]), min_size=1, max_size=4))
def test_spec_for_equals_reference_and_divides(dims, names):
    n = min(len(dims), len(names))
    dims, names = tuple(dims[:n]), tuple(names[:n])
    r = SH.make_rules(multi_pod=True)
    spec = SH.spec_for(dims, names, r, MESH)
    assert spec == as_tuple(JSH.spec_for(dims, names, JSH.make_rules(
        multi_pod=True), MESH))
    for d, p in zip(dims, spec):
        total = int(np.prod([MESH.shape[a] for a in SH.spec_axes(p)]))
        assert d % total == 0


@pytest.mark.parametrize("shape", PROD_SHAPES, ids=("pod1", "pod2"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_moment_pspecs_equal_reference(arch, shape):
    """Full width, tp = 16 layout: `param_pspecs` of the model's specs and
    the specs of the whole train state (the moments' `opt_expert_embed`
    included) equal the reference's, leaf by leaf."""
    mesh = FakeMesh(shape)
    rules = SH.make_rules(multi_pod="pod" in shape)
    jrules = JSH.make_rules(multi_pod="pod" in shape)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    lo, jlo = TM.make_layout(cfg, 16), JM.make_layout(jcfg, 16)
    got = TP.tree_leaves(TP.param_pspecs(TM.param_specs(cfg, lo), rules,
                                         mesh), is_leaf=is_pspec)
    want = jax.tree.leaves(JP.param_pspecs(JM.param_specs(jcfg, jlo),
                                           jrules, mesh),
                           is_leaf=lambda x: isinstance(
                               x, jax.sharding.PartitionSpec))
    assert [as_tuple(w) for w in want] == got
    tstate = TS.state_specs(cfg, lo)
    jstate = JS.state_specs(jcfg, jlo)
    got = [SH.spec_for(s.shape, s.axes, rules, mesh)
           for s in TP.tree_leaves(tstate)]
    want = [as_tuple(JSH.spec_for(s.shape, s.axes, jrules, mesh))
            for s in jax.tree.leaves(jstate, is_leaf=JP.is_spec)]
    assert got == want
    if cfg.moe is not None and not cfg.moe.expert_fsdp:
        # EP-resident experts: params replicated over data, moments not
        m = TP.tree_leaves(tstate["opt"]["m"])
        assert any("opt_expert_embed" in s.axes for s in m)


def is_pspec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def test_registry_matches():
    assert list(ARCH_IDS) == list(J_ARCH_IDS)


# ---------------------------------------------------------------------------
# placements on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_world():
    """init(rank, world): a fake process group (no communication) in this
    process, destroyed on teardown."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank: int, world: int):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


JAX_BLOCKS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import json, sys
import jax, numpy as np
from repro import pspec
from repro.configs import get_smoke_config
from repro.distributed.sharding import make_rules, sharding_for
from repro.launch.mesh import compat_make_mesh
from repro.models import model as M
from repro.training.step import state_specs
mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"))
rules = make_rules(multi_pod=True, fsdp_over_pod=True)
out = {}
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    specs = state_specs(cfg, M.make_layout(cfg, 2))
    rows = []
    for s in jax.tree.leaves(specs, is_leaf=pspec.is_spec):
        m = sharding_for(s.shape, s.axes, rules, mesh).devices_indices_map(
            s.shape)
        rows.append([[[sl.start or 0, dim if sl.stop is None else sl.stop]
                      for sl, dim in zip(m[mesh.devices[idx]], s.shape)]
                     for idx in np.ndindex(2, 2, 2)])
    out[arch] = rows
json.dump(out, open(PATH, "w"))
print("OK")
"""


def jax_blocks(tmp_path) -> dict:
    """{arch: per leaf of `state_specs` (the tp = 2 layout), per device in
    mesh row-major order, per dim [start, stop]} from JAX on 8 host
    devices."""
    path = tmp_path / "blocks.json"
    code = (f"ARCHS = {PLACED_ARCHS!r}\nPATH = {str(path)!r}\n"
            + JAX_BLOCKS)
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return json.loads(path.read_text())


def test_dtensor_blocks_equal_jax_devices(tmp_path, fake_world):
    """On the (2, 2, 2) pod/data/model mesh, with `embed` over ("pod",
    "data") (`fsdp_over_pod`), each rank's DTensor shard of every leaf of
    the qwen3-32b and arctic-480b smoke train states (params and moments)
    is the index block JAX gives the device at the same mesh coordinates;
    `place` puts exactly that block's values there."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    want = jax_blocks(tmp_path)
    rules = SH.make_rules(multi_pod=True, fsdp_over_pod=True)
    for rank in range(8):
        fake_world(rank, 8)
        mesh = init_device_mesh("cpu", MESH8[0], mesh_dim_names=MESH8[1])
        assert tuple(mesh.get_coordinate()) == tuple(
            np.unravel_index(rank, MESH8[0]))
        for arch in PLACED_ARCHS:
            cfg = get_smoke_config(arch)
            leaves = TP.tree_leaves(TS.state_specs(cfg, TM.make_layout(
                cfg, 2)))
            assert len(leaves) == len(want[arch])
            for s, rows in zip(leaves, want[arch]):
                sh = SH.sharding_for(s.shape, s.axes, rules, mesh)
                shape, off = compute_local_shape_and_global_offset(
                    s.shape, mesh, sh.placements)
                got = [[o, o + n] for o, n in zip(off, shape)]
                assert got == rows[rank], (arch, s, rank)
                x = torch.arange(int(np.prod(s.shape)),
                                 dtype=torch.float32).reshape(s.shape)
                local = SH.place(x, sh).to_local()
                blk = tuple(slice(a, b) for a, b in rows[rank])
                assert torch.equal(local, x[blk])


def test_placements_refuse_axes_out_of_mesh_order(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(0, 8)
    mesh = init_device_mesh("cpu", MESH8[0], mesh_dim_names=MESH8[1])
    with pytest.raises(ValueError, match="out of the mesh's order"):
        SH.placements_for((("data", "pod"), None), mesh)
    from torch.distributed.tensor import Replicate, Shard
    assert SH.placements_for((("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert SH.placements_for((None, None), mesh) == (Replicate(),) * 3


def test_size_one_axes_place_replicated(fake_world):
    """A mesh axis of size 1 holds every index: its placement is
    Replicate() whatever the spec says (the one-card (1, 1) mesh)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    fake_world(0, 2)
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    sh = SH.sharding_for((4, 6), ("batch", "heads"),
                         SH.make_rules(multi_pod=False), mesh)
    assert sh.spec == ("data", "model")
    assert sh.placements == (Shard(0), Replicate())


@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_mesh(fake_world, multi_pod, world):
    fake_world(5, world)
    mesh = TMESH.make_production_mesh(multi_pod=multi_pod, device="cpu")
    shape, names = TMESH.PRODUCTION_SHAPES[multi_pod]
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
    assert TMESH.tp_degree(mesh) == 16
    assert SH.axis_sizes(mesh) == dict(zip(names, shape))
    fake_world(0, 64)
    with pytest.raises(ValueError, match=str(world)):
        TMESH.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_host_mesh_under_a_fake_group(fake_world):
    fake_world(3, 8)
    mesh = TMESH.make_host_mesh(model=4, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (2, 4) and TMESH.tp_degree(mesh) == 4
    with pytest.raises(ValueError, match="does not divide"):
        TMESH.make_host_mesh(model=3, device="cpu")


def test_constrain_is_a_noop_without_a_device_mesh():
    x = torch.ones(4, 8)
    rules = SH.make_rules(multi_pod=False)
    assert SH.constrain(x, ("batch", None), rules, None) is x
    host = TMESH.make_host_mesh(device="cpu")
    assert SH.constrain(x, ("batch", None), rules, host) is x
    assert TMESH.tp_degree(host) == 1
    assert SH.spec_for((4, 8), ("batch", "ffn"), rules, host) == \
        ("data", "model")
