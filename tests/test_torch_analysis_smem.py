"""Shared-memory plans (`repro_torch.analysis.smem`): their arithmetic, their
agreement with the kernels' own planners and the serving bound, and their
refusals, at build time in the distributed drivers and at allocation in
the serving engine. The reference's `tests/test_analysis_vmem.py`
re-derived for the card's budgets."""
import pytest
import torch

from repro_torch.analysis import programs as PR
from repro_torch.analysis import smem as SM
from repro_torch.analysis import trace as TR
from repro_torch.core import roofline as R
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection.ref import default_params
from repro_torch.kernels.attention import attention as TA
from repro_torch.kernels.ssm import ssm as TS
from repro_torch.launch import mesh as TM
from repro_torch.stencil import distributed as TD
from repro_torch.stencil import spec as TSP
from repro_torch.stencil.advection import AdvectionDomain


def test_plan_arithmetic_and_table():
    plan = SM.SmemPlan((SM.SmemBuffer("a", 1000, "n=1"),
                        SM.SmemBuffer("b", 24, ""),
                        SM.SmemBuffer("ring", 10 ** 6, space="registers"),
                        SM.SmemBuffer("slab", 5000, space="device")),
                       blocks_per_sm=2)
    assert plan.total() == 1024 and plan.device_total() == 5000
    assert plan.per_sm() == 2 * (1024 + R.SMEM_RESERVED_PER_BLOCK)
    assert plan.headroom() == R.SMEM_PER_BLOCK - 1024 and plan.fits()
    assert plan.check() is plan
    table = plan.table()
    assert "1000 B  shared" in table and "(n=1)" in table
    assert "5000 B  device    TOTAL" in table
    with pytest.raises(ValueError, match="space must be one of"):
        SM.SmemBuffer("x", 1, space="vmem")


@pytest.mark.parametrize("kw,what", [
    (dict(buffers=(SM.SmemBuffer("small", 10),
                   SM.SmemBuffer("the big one", R.SMEM_PER_BLOCK))),
     "shared memory a block"),
    (dict(buffers=(SM.SmemBuffer("tile", 60_000),), blocks_per_sm=4),
     "4 resident blocks need"),
    (dict(buffers=(SM.SmemBuffer("tile", 100),
                   SM.SmemBuffer("slots", R.HBM_PER_CHIP + 1,
                                 space="device"))),
     "of device memory"),
])
def test_check_raises_naming_largest_buffer(kw, what):
    plan = SM.SmemPlan(context="probe", **kw)
    assert not plan.fits()
    worst = max(plan.buffers, key=lambda b: b.nbytes)
    with pytest.raises(SM.SmemBudgetExceeded) as e:
        plan.check()
    msg = str(e.value)
    assert what in msg and "[probe]" in msg
    assert f"largest buffer: {worst.name!r}" in msg
    assert all(b.name in msg for b in plan.buffers)


@pytest.mark.parametrize("shape,T,y_tile", [((8, 16, 32), 4, None),
                                            ((6, 1024, 64), 4, None),
                                            ((6, 1024, 64), 2, 128),
                                            ((5, 12, 700), 3, None)])
def test_fused_ring_plan_is_k1s_launch(shape, T, y_tile):
    X, Y, Z = shape
    plan = SM.fused_ring_plan(X, Y, Z, T=T, y_tile=y_tile)
    launch = TK.fused_launch_plan(X, Y, Z, T, 1, SM.H100_SMS, 1,
                                  y_tile=y_tile)
    assert plan.total() == launch.shared_bytes
    assert plan.total() == TK.fused_shared_bytes(
        T, launch.S, launch.W, launch.cells_per_thread)
    ring = next(b for b in plan.buffers if b.space == "registers")
    assert ring.nbytes == TK.fused_register_bytes(T, launch.S, launch.W)
    plan.check()


@pytest.mark.parametrize("op,integrator,T", [("pw", "rk2", 2),
                                             ("diffusion", "euler", 4),
                                             ("tracer", "euler", 3)])
def test_fused_ring_plan_spec_geometry(op, integrator, T):
    spec = {"pw": TSP.pw_advection_spec, "tracer": TSP.tracer_advection_spec,
            "diffusion": TSP.diffusion_spec}[op](integrator)
    plan = SM.fused_ring_plan(16, 256, 64, T=T, spec=spec)
    launch = TK.spec_launch_plan(16, 256, 64, spec, T, 1, SM.H100_SMS, 1)
    assert plan.total() == launch.shared_bytes
    assert all(b.name.startswith("K6") for b in plan.buffers)


def test_serving_ring_plan_and_max_batch_agree():
    X, Y, Z = 64, 256, 64
    slot = R.serving_slot_bytes_model(X, Y, Z)
    budget = 100 * slot + slot // 2
    most = SM.plan_max_batch(X, Y, Z, budget=budget)
    assert most == R.serving_max_batch(slot, device_budget=budget) == 100
    fits = SM.serving_ring_plan(X, Y, Z, batch=most, T=4)
    assert fits.device_total() == most * slot
    assert fits.total() == TK.fused_launch_plan(X, Y, Z, 4, most, 132,
                                                1).shared_bytes
    over = SM.SmemPlan(SM.serving_ring_plan(X, Y, Z, batch=most + 1,
                                            T=4).buffers,
                       device_budget=budget)
    with pytest.raises(SM.SmemBudgetExceeded,
                       match="serving slot buffers"):
        over.check()


def test_distributed_block_plan_fused_and_k7_buffers():
    plan = SM.distributed_block_plan((512, 512, 64), T=4,
                                     local_kernel="fused",
                                     exchange="remote_dma", nx=2, ny=2,
                                     shards_per_card=4)
    ext = (520, 520, 64)
    k1 = TK.fused_launch_plan(*ext, 4, 1, SM.H100_SMS, 1)
    assert plan.total() == k1.shared_bytes
    dev = [b for b in plan.buffers if b.space == "device"]
    assert [b.name for b in dev] == ["K7 extended buffers (2 slots)"]
    assert dev[0].nbytes == 4 * 3 * 2 * 520 * 520 * 64 * 4
    plan.check()
    collective = SM.distributed_block_plan((512, 512, 64), T=4,
                                           local_kernel="fused",
                                           exchange="collective", nx=2, ny=2)
    assert collective.device_total() == 0
    assert collective.total() == plan.total()
    reference = SM.distributed_block_plan((512, 512, 64), T=4,
                                          local_kernel="reference",
                                          exchange="collective", nx=2, ny=2)
    assert reference.buffers == ()
    # x decomposed alone: the slab widens along x only
    x_only = SM.distributed_block_plan((512, 1024, 64), T=2,
                                       local_kernel="fused",
                                       exchange="remote_dma", nx=2, ny=1)
    assert x_only.device_total() == 3 * 2 * 516 * 1024 * 64 * 4


def test_distributed_block_plan_spec_depth():
    spec = TSP.pw_advection_spec("rk2")
    plan = SM.distributed_block_plan((64, 64, 64), T=2, local_kernel="fused",
                                     exchange="collective", nx=2, ny=2,
                                     spec=spec)
    ext = 64 + 2 * spec.halo(2)
    assert plan.total() == TK.spec_launch_plan(ext, ext, 64, spec, 2, 1,
                                               SM.H100_SMS, 1).shared_bytes


def test_oversized_distributed_build_refused_before_any_launch():
    """Shards whose K7 buffers exceed the card are refused at the first
    block, naming the buffer; the shards are fake, so nothing is held."""
    mesh = TM.make_stencil_mesh(2, 2, devices=["cuda:0"] * 4)
    with TR.fake_mode():
        p = PR.place(default_params(64, device="cpu"), "cuda")
        shards = [tuple(torch.empty(8192, 8192, 64, device="cuda")
                        for _ in range(3)) for _ in range(4)]
        step = TD.make_distributed_step(mesh, p, T=4, local_kernel="fused",
                                        exchange="remote_dma")
        with pytest.raises(SM.SmemBudgetExceeded,
                           match="largest buffer: 'K7 extended buffers"):
            step(shards)


def test_serving_engine_alloc_checks_its_plan(monkeypatch):
    from repro_torch.serving import stencil_engine as SE
    real = SM.serving_ring_plan

    def tight(*a, **kw):
        plan = real(*a, **kw)
        return SM.SmemPlan(plan.buffers, budget=1024, context=plan.context)

    monkeypatch.setattr(SE.SM, "serving_ring_plan", tight)
    dom = AdvectionDomain(8, 16, 32, variant="fused", fuse_T=2, dt=0.01,
                          device="cpu")
    with pytest.raises(SM.SmemBudgetExceeded,
                       match="serving engine slot buffers.*shared memory a block"):
        SE.StencilServingEngine(dom, batch_size=2)


@pytest.mark.parametrize("name", ["advect_blocked", "advect_dataflow",
                                  "advect_wide"])
def test_rung_plan_is_the_rungs_launch(name):
    plan = SM.rung_plan(name, 64, 1024, 64)
    launch = TK.rung_launch_plan(name, 64, 1024, 64, SM.H100_SMS,
                                 TK._RUNG_KNOBS[name].blocks_per_sm)
    assert plan.total() == launch.shared_bytes
    plan.check()


@pytest.mark.parametrize("D", [64, 128, 256])
def test_attention_and_scan_plans(D):
    assert SM.attention_plan(D, torch.bfloat16).total() == \
        TA.tc_smem_bytes(D)
    bq, bk = TA.simt_tiles(128, 128, D)
    assert SM.attention_plan(D, torch.float32).total() == \
        TA.smem_bytes(bq, bk, D)
    SM.attention_plan(D, torch.float32).check()
    plan = SM.scan_plan(1, 2048, 8192, 16, x_itemsize=2, dt_itemsize=2)
    assert plan.total() == TS.scan_launch_plan(1, 2048, 8192, 16, 2, 2,
                                               SM.H100_SMS, 1).shared_bytes
