"""The port's launch specs and dry-run policy against the reference's on
all 40 (arch x shape) cells: input specs (shapes, dtypes, logical axes),
batch shardings' PartitionSpecs on both production mesh shapes, the
execution policy, the costing configs and the layer multiplier, field by
field; `make_batch` draws the reference's values from the same seed."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as J_SHAPES
from repro.config import supports as j_supports
from repro.configs import get_config as j_get_config
from repro.distributed.sharding import make_rules as j_make_rules
from repro.distributed.sharding import spec_for as j_spec_for
from repro.launch import dryrun as JDR
from repro.launch import specs as JSP
from repro_torch.config import ALL_SHAPES, SHAPES, supports
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import specs as TSP

CELLS = [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES]


class RefMesh:
    """The reference's duck-typed mesh: axis name -> size."""

    def __init__(self, shape):
        self.shape = shape


class PortMesh:
    """A duck-typed DeviceMesh: dimension names and sizes."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


def test_forty_cells():
    assert len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    tc, jc = get_config(arch), j_get_config(arch)
    assert supports(tc, SHAPES[shape]) == j_supports(jc, J_SHAPES[shape])
    ts, ta = TSP.input_specs(tc, SHAPES[shape])
    js, ja = JSP.input_specs(jc, J_SHAPES[shape])
    assert list(ts) == list(js) and ta == ja
    for k in ts:
        assert ts[k].shape == tuple(js[k].shape)
        assert ts[k].dtype == js[k].dtype.name
        assert ts[k].torch_dtype.is_floating_point == \
            jnp.issubdtype(js[k].dtype, jnp.floating)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_shardings_equal_reference(arch, shape):
    """On both production mesh shapes, with the rules each shape kind and
    the sequence-parallel knob give."""
    tc, jc = get_config(arch), j_get_config(arch)
    specs, axes = JSP.input_specs(jc, J_SHAPES[shape])
    for mesh in MESHES:
        multi = "pod" in mesh
        for sp in (False, True):
            kw = dict(multi_pod=multi, shape_kind=SHAPES[shape].kind,
                      seq_parallel=sp)
            got = TSP.batch_shardings(tc, SHAPES[shape], make_rules(**kw),
                                      PortMesh(mesh))
            want = {k: j_spec_for(specs[k].shape, axes[k],
                                  j_make_rules(**kw), RefMesh(mesh))
                    for k in specs}
            assert {k: tuple(v.spec) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_exec_policy_and_cost_cfgs_equal_reference(arch, shape):
    tc, jc = get_config(arch), j_get_config(arch)
    ts, js = SHAPES[shape], J_SHAPES[shape]
    for for_cost in (False, True):
        for ov in (None, {"param_dtype": "bfloat16"},
                   {"expert_fsdp": False}):
            assert dataclasses.asdict(TDR.exec_policy(
                tc, ts, for_cost=for_cost, overrides=dict(ov) if ov else None)
            ) == dataclasses.asdict(JDR.exec_policy(
                jc, js, for_cost=for_cost, overrides=dict(ov) if ov else None))
    for n in (1, 2):
        assert dataclasses.asdict(TDR._cost_cfg(tc, n)) == \
            dataclasses.asdict(JDR._cost_cfg(jc, n))
        assert dataclasses.asdict(TDR.exec_policy(
            TDR._cost_cfg(tc, n), ts, for_cost=True)) == dataclasses.asdict(
            JDR.exec_policy(JDR._cost_cfg(jc, n), js, for_cost=True))
    assert TDR._layer_multiplier(tc) == JDR._layer_multiplier(jc)
    for n in range(1, 80):
        assert TDR._divisor_near(n, int(np.sqrt(n)) + 2) == \
            JDR._divisor_near(n, int(np.sqrt(n)) + 2)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("arch", ["qwen3-32b", "qwen2-vl-72b",
                                  "whisper-large-v3", "falcon-mamba-7b"])
def test_make_batch_equals_reference(arch):
    """Each shape, at a small batch and length and at the reference's own
    default generator: the same integers, and the same values after the
    cast (bf16 inputs compared as f32)."""
    tc, jc = get_config(arch), j_get_config(arch)
    for s in ALL_SHAPES:
        if not supports(tc, s):
            continue
        for seed in (0, 7):
            got = TSP.make_batch(tc, s, np.random.default_rng(seed), batch=2,
                                 seq=64, device="cpu")
            want = JSP.make_batch(jc, J_SHAPES[s.name],
                                  np.random.default_rng(seed), batch=2,
                                  seq=64)
            assert list(got) == list(want)
            for k in got:
                w = np.asarray(want[k].astype("float32")
                               if "bfloat16" in str(want[k].dtype)
                               else want[k])
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype)
                assert np.array_equal(_np(got[k]), w), (arch, s.name, k)


def test_make_batch_defaults_to_the_card_and_seed_zero():
    cfg = get_config("qwen3-32b")
    a = TSP.make_batch(cfg, SHAPES["train_4k"], batch=2, seq=8, device="cpu")
    b = TSP.make_batch(cfg, SHAPES["train_4k"], np.random.default_rng(0),
                       batch=2, seq=8, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TSP.make_batch(cfg, SHAPES["train_4k"], batch=2, seq=8)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if c[1] == "decode_32k"])
def test_decode_cache_abstract_is_the_model_cache_tree(arch, shape):
    from repro_torch import pspec
    from repro_torch.models import model as TM
    cfg = get_config(arch)
    layout = TM.make_layout(cfg, 16)
    tree = TSP.decode_cache_abstract(cfg, layout, SHAPES[shape])
    want = TM.cache_specs(cfg, layout, SHAPES[shape].global_batch,
                          SHAPES[shape].seq_len)
    assert pspec.tree_leaves(tree) == pspec.tree_leaves(want)
