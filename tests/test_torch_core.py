"""The port's core modules against the reference's: the dataflow pipeline
and its model, the chunk scheduler (on the CPU) and the §IV overlap model,
the LLM-side roofline functions, the collective census's ring accounting
and the profiler.

Models are held to the reference's exactly (the same arithmetic on the
same numbers) and scheduler results bitwise (the same kernel on the same
chunks)."""
import json
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro.config import ALL_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import chunking as JC
from repro.core import dataflow as JD
from repro.core import hlo as JH
from repro.core import profiler as JP
from repro.core import roofline as JR
from repro.models import model as JM
from repro_torch.analysis import trace as TT
from repro_torch.config import SHAPES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import chunking as TC
from repro_torch.core import dataflow as TD
from repro_torch.core import hlo as TH
from repro_torch.core import profiler as TP
from repro_torch.core import roofline as TR
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
MESH_SHAPES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


# --- dataflow pipeline -----------------------------------------------------

def test_pipeline_thread_correctness():
    stages = [TD.Stage("load", lambda x: x * 2),
              TD.Stage("prep", lambda x: x + 1),
              TD.Stage("compute", lambda x: x ** 2),
              TD.Stage("store", lambda x: x - 3)]
    out = TD.Pipeline(stages).run(list(range(50)))
    ref = JD.Pipeline([JD.Stage(s.name, s.fn) for s in stages]).run(
        list(range(50)))
    assert out == ref == [((i * 2 + 1) ** 2 - 3) for i in range(50)]


@settings(max_examples=100, deadline=None)
@given(stage_times=st.lists(st.floats(1e-4, 10.0), min_size=1, max_size=6),
       n=st.integers(1, 1000), overlapped=st.booleans())
def test_pipeline_model_equals_reference(stage_times, n, overlapped):
    stages = {f"s{i}": t for i, t in enumerate(stage_times)}
    assert TD.pipeline_model(stages, n, overlapped=overlapped) == \
        JD.pipeline_model(stages, n, overlapped=overlapped)


@pytest.mark.parametrize("stages,n", [
    ({"load": 3.0, "prepare": 0.5, "compute": 1.0, "store": 2.0}, 100),
    ({"compute": 2.0}, 10)])
def test_pipeline_model_reference_cases(stages, n):
    for ov in (True, False):
        assert TD.pipeline_model(stages, n, overlapped=ov) == \
            JD.pipeline_model(stages, n, overlapped=ov)
    flow = TD.pipeline_model(stages, n)
    serial = TD.pipeline_model(stages, n, overlapped=False)
    assert flow["compute_share"] >= serial["compute_share"]


def test_pipeline_leak_is_loud_not_silent(caplog):
    """A consumer stage that dies leaves its producer blocked on the
    bounded queue (depth 1): the drain re-raises the stage error and logs
    the leaked worker."""

    def dies(x):
        raise RuntimeError("consumer died")

    pipe = TD.Pipeline([TD.Stage("produce", lambda x: x, depth=8),
                        TD.Stage("consume", dies, depth=1)],
                       join_timeout=0.2)
    with caplog.at_level(logging.ERROR, logger="repro_torch.core.dataflow"):
        with pytest.raises(RuntimeError, match="consumer died"):
            pipe.run([0, 1, 2])
    assert any("leaked" in rec.message and "produce" in str(rec.args)
               for rec in caplog.records)


def test_pipeline_leak_without_stage_error_raises(caplog, monkeypatch):
    """A worker still alive after `join_timeout` that no stage error
    explains is logged and raised as RuntimeError naming its stage."""
    monkeypatch.setattr(TD.threading.Thread, "is_alive", lambda self: True)
    pipe = TD.Pipeline([TD.Stage("wedged", lambda x: x)], join_timeout=0.05)
    with caplog.at_level(logging.ERROR, logger="repro_torch.core.dataflow"):
        with pytest.raises(RuntimeError, match=r"\['wedged'\].*no stage"):
            pipe.run([1])
    assert any("leaked" in rec.message for rec in caplog.records)


def test_pipeline_join_timeout_validation_and_clean_run():
    with pytest.raises(ValueError, match="join_timeout"):
        TD.Pipeline([TD.Stage("a", lambda x: x)], join_timeout=0.0)
    out = TD.Pipeline([TD.Stage("a", lambda x: x + 1),
                       TD.Stage("b", lambda x: x * 2)]).run([1, 2, 3])
    assert out == [4, 6, 8]


# --- chunk scheduler (CPU) and the §IV model ------------------------------

def _chunks(n, shape=(32, 32), seed=0):
    return [np.random.default_rng(seed + i).normal(size=shape).astype(
        np.float32) for i in range(n)]


def test_chunk_scheduler_results_bitwise_and_equal_reference():
    kernel = lambda x: torch.tanh(x) @ x.T  # noqa: E731
    chunks = _chunks(12)
    s = TC.ChunkScheduler(kernel, depth=4, device="cpu")
    a, b = s.run_serial(chunks), s.run_overlapped(chunks)
    want = [(np.tanh(c.astype(np.float64)) @ c.T.astype(np.float64))
            for c in chunks]
    for x, y, w in zip(a, b, want):
        assert isinstance(x, np.ndarray) and x.dtype == np.float32
        assert np.array_equal(x, y)
        np.testing.assert_allclose(x, w, rtol=1e-5, atol=1e-5)
    ref = JC.ChunkScheduler(lambda x: jnp.tanh(x) @ x.T, depth=4)
    for x, y in zip(a, ref.run_overlapped(chunks)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-5)


@settings(max_examples=50, deadline=None)
@given(n=st.integers(1, 64), depth=st.integers(1, 8))
def test_chunk_scheduler_order_preserved(n, depth):
    chunks = [np.full((2, 2), i, np.float32) for i in range(n)]
    out = TC.ChunkScheduler(lambda x: x + 1.0, depth=depth,
                            device="cpu").run_overlapped(chunks)
    assert [float(o[0, 0]) for o in out] == [i + 1.0 for i in range(n)]


def test_chunk_scheduler_tuples_in_and_out():
    """A tuple chunk gives the kernel one tensor an array, and a kernel
    returning a tuple gives a tuple of arrays; the inputs are never
    written."""
    chunks = [tuple(_chunks(3, (4, 5), seed=3 * i)) for i in range(5)]
    kept = [tuple(a.copy() for a in c) for c in chunks]

    def kernel(u, v, w):
        u.add_(1.0)                   # the scheduler's copy, not the chunk
        return u + v, v * w, w - u

    for depth in (1, 2, 4, 8):
        s = TC.ChunkScheduler(kernel, depth=depth, device="cpu")
        for got in (s.run_serial(chunks), s.run_overlapped(chunks)):
            for c, g in zip(kept, got):
                u = c[0] + 1.0
                want = (u + c[1], c[1] * c[2], c[2] - u)
                assert isinstance(g, tuple) and len(g) == 3
                assert all(np.array_equal(x, y) for x, y in zip(g, want))
        assert all(np.array_equal(a, b) for c, k in zip(chunks, kept)
                   for a, b in zip(c, k))


def test_chunk_scheduler_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA scheduler builds")
    with pytest.raises(RuntimeError, match="CUDA device"):
        TC.ChunkScheduler(lambda x: x, device="cuda")
    with pytest.raises(ValueError, match="depth"):
        TC.ChunkScheduler(lambda x: x, depth=0, device="cpu")


def test_time_both_runs_both():
    calls = []
    s = TC.ChunkScheduler(lambda x: calls.append(1) or x * 2, depth=2,
                          device="cpu")
    t = s.time_both(_chunks(4, (3, 3)))
    assert t.serial_s > 0 and t.overlapped_s > 0 and t.speedup > 0
    assert len(calls) == 1 + 1 + 4 + 4


@settings(max_examples=100, deadline=None)
@given(total=st.floats(1e6, 1e12), compute=st.floats(1e-4, 10.0),
       bw=st.floats(1e9, 1e12), n=st.integers(1, 256))
def test_overlap_model_equals_reference(total, compute, bw, n):
    m = TC.overlap_model(total, compute, bw, n)
    assert m == JC.overlap_model(total, compute, bw, n)
    assert m["overlapped_s"] <= m["serial_s"] + 1e-9
    assert 0.0 <= m["dma_overhead_overlapped"] <= 1.0 + 1e-9


# --- the LLM-side roofline functions ---------------------------------------

CELLS = [(a, s.name) for a in ARCH_IDS for s in J_SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_llm_functions_equal_reference(arch, shape):
    """`kernel_core_io_bytes` and `streaming_memory_bytes` on every config
    and shape, on both production mesh shapes, with and without the
    sequence-parallel knob."""
    for mesh_shape in MESH_SHAPES:
        tp = mesh_shape["model"]
        for sp in (False, True):
            tc = get_config(arch).replace(seq_parallel=sp)
            jc = j_get_config(arch).replace(seq_parallel=sp)
            sh_t, sh_j = SHAPES[shape], next(s for s in J_SHAPES
                                             if s.name == shape)
            core_t = TR.kernel_core_io_bytes(tc, sh_t, TM.make_layout(tc, tp),
                                             mesh_shape)
            core_j = JR.kernel_core_io_bytes(jc, sh_j, JM.make_layout(jc, tp),
                                             mesh_shape)
            assert core_t == core_j
            for args_b in (0.0, 1.5e9, 7.25e10):
                assert TR.streaming_memory_bytes(
                    tc, sh_t, args_bytes_per_dev=args_b,
                    core_io_bytes=core_t, mesh_shape=mesh_shape) == \
                    JR.streaming_memory_bytes(
                        jc, sh_j, args_bytes_per_dev=args_b,
                        core_io_bytes=core_j, mesh_shape=mesh_shape)
    assert TR.MATERIALIZATIONS_PER_BLOCK == JR.MATERIALIZATIONS_PER_BLOCK


@settings(max_examples=100, deadline=None)
@given(c1=st.floats(0, 1e15), c2=st.floats(0, 1e15),
       n=st.integers(1, 128), key=st.sampled_from(["flops", "bytes", "x"]))
def test_differential_equals_reference(c1, c2, n, key):
    a, b = {"flops": c1, "bytes": c2}, {"flops": c2, "bytes": c1}
    assert TR.differential(a, b, n, key) == JR.differential(a, b, n, key)


@pytest.mark.parametrize("grid_tiled", [True, False])
def test_stencil_tiling_bytes_factor_equals_reference(grid_tiled):
    for Y in (1, 7, 64, 1024):
        for y_tile in (None, 1, 3, 8, 64, 2048):
            for halo in (0, 1, 2, 4):
                assert TR.stencil_tiling_bytes_factor(
                    Y, y_tile, halo, grid_tiled=grid_tiled) == \
                    JR.stencil_tiling_bytes_factor(Y, y_tile, halo,
                                                   grid_tiled=grid_tiled)
    with pytest.raises(ValueError):
        TR.stencil_tiling_bytes_factor(8, 2, -1)


def test_cross_pod_term_and_single_pod_keys():
    """A cross-pod wire term adds its seconds; without one the collective
    term is what it was, bit for bit, and a single-pod dict has the same
    keys with a zero cross-pod term."""
    kw = dict(flops_per_dev=1e12, hbm_bytes_per_dev=1e9, wire_bytes=4.5e8)
    plain = TR.RooflineTerms(**kw)
    assert plain.collective_s == 4.5e8 / TR.NVLINK_BW
    assert plain.as_dict()["cross_wire_bytes"] == 0.0
    both = TR.RooflineTerms(**kw, cross_wire_bytes=5e7)
    assert both.collective_s == 4.5e8 / TR.NVLINK_BW + 5e7 / TR.CROSS_POD_BW
    assert both.as_dict()["cross_wire_bw"] == TR.CROSS_POD_BW
    assert set(both.as_dict()) == set(plain.as_dict())
    assert TR.PCIE_BW == 64e9


# --- collective census -----------------------------------------------------

def _hlo_fixtures():
    """Every HLO text of `tests/test_hlo_analysis.py` (its module-level
    module and the texts its tests write inline)."""
    text = (ROOT / "tests" / "test_hlo_analysis.py").read_text()
    return [t for t in re.findall(r'"""\\\n(.*?)"""', text, flags=re.S)
            if " = " in t and "(" in t]


def test_hlo_fixtures_found():
    assert len(_hlo_fixtures()) == 4


@pytest.mark.parametrize("pod_size", [0, 2, 4])
def test_wire_bytes_equal_reference_on_hlo_fixtures(pod_size):
    """The port's ring formulas on the reference's parsed (kind, output
    bytes, group size) give the reference's wire bytes, op by op."""
    n_ops = 0
    for text in _hlo_fixtures():
        for op in JH.parse_collectives(text, pod_size=pod_size):
            assert TH.wire_bytes(op.kind, op.out_bytes, op.group_size) == \
                op.wire_bytes
            n_ops += 1
    assert n_ops >= 5


FAKE_GROUP_CHILD = r"""
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, Replicate, Partial
from repro_torch.analysis import trace as TR
from repro_torch.core import hlo as H
from repro_torch.core import profiler as P
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
with TR.fake_mode():
    x = DTensor.from_local(torch.empty(4, 32), mesh, (Replicate(), Shard(0)),
                           run_check=False)
    y = DTensor.from_local(torch.empty(16, 32), mesh,
                           (Replicate(), Partial()), run_check=False)
    z = DTensor.from_local(torch.empty(8, 8), mesh, (Partial(), Replicate()),
                           run_check=False)
    def f(x, y, z):
        return (x.redistribute(mesh, (Replicate(), Replicate())),
                y.redistribute(mesh, (Replicate(), Shard(0))),
                z.redistribute(mesh, (Replicate(), Replicate())))
    tr = P.trace_cost(f, x, y, z)
out = {}
for pod in (0, 8, 4):
    ops = H.parse_collectives(tr.records, pod_size=pod)
    out[pod] = {"ops": [[o.kind, o.group_size, o.group_span, o.out_bytes,
                         o.wire_bytes] for o in ops],
                "census": H.op_census(tr.records)}
print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def world_8():
    """The census of the three redistributions, read at pod sizes 0, 8
    and 4, from one child interpreter that holds the fake group."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", FAKE_GROUP_CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("pod_size,span_model,span_data", [
    (0, "pod", "pod"), (8, "pod", "pod"), (4, "pod", "cross_pod")])
def test_dtensor_collectives_on_a_world_8_fake_group(world_8, pod_size,
                                                     span_model, span_data):
    """On a (2, 4) mesh of a world-8 fake group: an all-gather of a (4, 32)
    f32 shard over "model" (4 ranks), a reduce-scatter of a (16, 32) f32
    partial to (4, 32) over "model", and an all-reduce of an (8, 8) f32
    partial over "data" (2 ranks, 0 and 4: across pods of 4)."""
    got = world_8[str(pod_size)]
    assert got["ops"] == [
        ["all-gather", 4, span_model, 2048, 3 / 4 * 2048],
        ["reduce-scatter", 4, span_model, 512, 3 * 512],
        ["all-reduce", 2, span_data, 256, 2 * 1 / 2 * 256]]
    assert got["census"] == {"all-gather": 1, "reduce-scatter": 1,
                             "all-reduce": 1}


def _collective_record(**args):
    meta = TT.TensorMeta((4,), "torch.float32", "cpu", (1,), 0, 4, 16, True)
    return TT.OpRecord("_c10d_functional::all_reduce", None,
                       (("input", meta),) + tuple(args.items()), (meta,), ())


def test_unresolved_collective_group_raises():
    """A collective whose group is missing, or named while no process
    group exists to resolve it, raises rather than counting one rank."""
    with pytest.raises(ValueError, match="names no process group"):
        TH.parse_collectives([_collective_record(reduce_op="sum")])
    with pytest.raises(RuntimeError, match="no process group"):
        TH.parse_collectives([_collective_record(group_name="7")])


def _site_attr(site):
    import importlib
    mod, cls, name, _ = site
    owner = importlib.import_module(mod)
    return vars(getattr(owner, cls) if cls else owner)[name]


def test_dtensor_internals_patch_every_site_on_this_torch():
    """Every DTensor internal the trace patches exists on the installed
    torch as a plain function, is patched once inside the context (a
    nested entry re-patches nothing) and restored after it."""
    sites = TT.DTENSOR_SITES + (TT.CARD_ALLTOALL_SITE,)
    orig = [_site_attr(s) for s in sites]
    with TT.dtensor_internals(card_alltoall=True):
        patched = [_site_attr(s) for s in sites]
        assert all(p is not o for p, o in zip(patched, orig))
        with TT.dtensor_internals(card_alltoall=True):
            assert [_site_attr(s) for s in sites] == patched
        assert [_site_attr(s) for s in sites] == patched
    assert [_site_attr(s) for s in sites] == orig
    with TT.dtensor_internals():
        assert _site_attr(TT.CARD_ALLTOALL_SITE) is orig[-1]


def test_dtensor_internals_raise_on_a_missing_site(monkeypatch):
    """A site missing from torch raises before any site is patched."""
    mod, cls, _, wrap = TT.DTENSOR_SITES[0]
    before = _site_attr(TT.DTENSOR_SITES[0])
    monkeypatch.setattr(TT, "DTENSOR_SITES", TT.DTENSOR_SITES
                        + ((mod, cls, "no_such_method", wrap),))
    with pytest.raises(RuntimeError, match="not a plain function"):
        with TT.dtensor_internals():
            pass
    assert _site_attr(TT.DTENSOR_SITES[0]) is before


# --- profiler --------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(8, 4, 16), (3, 5, 7), (64, 1, 2)])
def test_profile_counts_a_product(m, n, k):
    """2 m n k FLOPs; the bytes are the product's operands and result; one
    dot in the census; no wire bytes."""
    a, b = torch.randn(m, k), torch.randn(k, n)
    c = TP.profile(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * m * n * k
    assert c.bytes == 4 * (m * k + k * n + m * n)
    assert c.census == {"dot": 1}
    assert c.pod_bytes == 0 and c.cross_pod_bytes == 0


def test_trace_cost_live_bytes_by_hand():
    """Peak live bytes of a chain counted by hand: the arguments (a 1 KiB
    and a 256 B f32 tensor), then x @ y (64 x 16 f32, 4 KiB) alive with
    its relu (4 KiB), then the sum (4 B) after the product dies."""
    def fn(x, y):
        h = x @ y
        r = torch.relu(h)
        del h
        return r.sum()
    tr = TP.trace_cost(fn, torch.randn(64, 4), torch.randn(4, 16))
    args = 64 * 4 * 4 + 4 * 16 * 4
    assert tr.args_bytes == args
    assert tr.peak_bytes == args + 2 * 64 * 16 * 4
    assert tr.flops == 2 * 64 * 16 * 4


@settings(max_examples=50, deadline=None)
@given(vals=st.lists(st.floats(0, 1e12), min_size=10, max_size=10))
def test_attribute_equals_reference(vals):
    def pair(v):
        return (TP.PhaseCost(v[0], v[1], v[2], v[3]),
                JP.PhaseCost(v[0], v[1], v[2], v[3]))
    ft, fj = pair(vals[:4])
    wt1, wj1 = pair(vals[4:8])
    wt2, wj2 = pair(vals[6:10])
    got = TP.attribute(ft, {"core": wt1, "dispatch": wt2})
    want = JP.attribute(fj, {"core": wj1, "dispatch": wj2})
    assert list(got) == list(want)
    for k in got:
        g, w = got[k], want[k]
        assert (g.flops, g.bytes, g.pod_bytes, g.cross_pod_bytes) == \
            (w.flops, w.bytes, w.ici_bytes, w.dcn_bytes)


def test_wallclock_on_the_cpu():
    calls = []
    t = TP.wallclock(lambda x: calls.append(1) or x + 1, torch.ones(3),
                     iters=3, warmup=1)
    assert t >= 0.0 and len(calls) == 4
