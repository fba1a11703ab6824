"""The port's stencil serving tier (`repro_torch.serving.stencil_engine`,
the batch accounting of `stencil.advection`, the serving models of
`core.roofline` and `launch.serve --stencil`) on the CPU, where the kernel
wrappers run their plain versions.

(a) Within the port, bitwise: the reference's contracts of
    tests/test_stencil_serving.py and tests/test_faults.py.
(b) Against the JAX engine (`repro.serving.stencil_engine`) on the same
    requests and fault plans. This jax's Pallas lacks `pl.Unblocked`, so the
    reference's `advect_fused_batched` is replaced, inside each test, by a
    batched masked loop over its own `pw_step_ref` with the same masks and
    the same guard (`jax_batched_seam`); nothing in `src/repro/` changes.
    Statuses, counters, cache stats and state counts are equal; every field
    lies within 1e-6 of the JAX engine's.
(c) The serving models against the reference's.
(d) The CLI against the reference's `_run_stencil` (through the same seam).
"""
import dataclasses
import os
import re
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from repro.core import roofline as JR
from repro.kernels.advection import advection as JK
from repro.kernels.advection import ref as JREF
from repro.serving import stencil_engine as JE
from repro.stencil import advection as JSA
from repro_torch.core import roofline as TR
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF
from repro_torch.launch import serve as TSERVE
from repro_torch.serving import stencil_engine as TE
from repro_torch.serving.faults import FaultPlan
from repro_torch.stencil import advection as TSA

ROOT = Path(__file__).resolve().parents[1]
X, Y, Z, T = 8, 10, 16, 2
DT = 0.005
SIZES = [(X, Y, 3), (5, 6, 2), (4, 8, 3)]
VALUE_TOL = 1e-6     # test_torch_advection_fused.py's bound on the plain
                     # fused version against the JAX masked loop
needs_unblocked = pytest.mark.skipif(
    not hasattr(pl, "Unblocked"), reason="the installed Pallas has no "
    "pl.Unblocked, which the JAX advect_fused kernel needs (jax 0.4.x has "
    "it)")


# -- helpers ----------------------------------------------------------------

def _dom(**kw):
    kw.setdefault("variant", "fused")
    kw.setdefault("fuse_T", T)
    kw.setdefault("dt", DT)
    return TSA.AdvectionDomain(X, Y, Z, device="cpu", **kw)


def _jdom(**kw):
    kw.setdefault("variant", "fused")
    kw.setdefault("fuse_T", T)
    kw.setdefault("dt", DT)
    return JSA.AdvectionDomain(X, Y, Z, **kw)


def _fields(uid, Xr, Yr):
    return [f.numpy() for f in TSA.stratus_fields(Xr, Yr, Z, seed=uid,
                                                  device="cpu")]


def _req(uid, Xr, Yr, n_steps=1, mod=TE):
    u, v, w = _fields(uid, Xr, Yr)
    return mod.StencilRequest(uid=uid, u=u, v=v, w=w, n_steps=n_steps)


def _reqs(mod=TE, sizes=SIZES):
    return [_req(i, xr, yr, n, mod) for i, (xr, yr, n) in enumerate(sizes)]


def _sequential(uid, Xr, Yr, n_steps):
    p = TREF.default_params(Z, device="cpu")
    u, v, w = TSA.stratus_fields(Xr, Yr, Z, seed=uid, device="cpu")
    states = []
    for _ in range(n_steps):
        u, v, w = TK.advect_fused(u, v, w, p, T=T, dt=DT)
        states.append(tuple(a.numpy() for a in (u, v, w)))
    return states


def _assert_bitwise(req, ref_req):
    for got, ref in zip(req.out, ref_req.out):
        np.testing.assert_array_equal(got, ref)
    assert len(req.states) == len(ref_req.states)
    for st_g, st_r in zip(req.states, ref_req.states):
        for got, ref in zip(st_g, st_r):
            np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def clean_done():
    return TE.StencilServingEngine(_dom(), batch_size=2).run(_reqs())


def jax_batched_seam(u, v, w, p, *, T, dt, interpret=True, y_tile=None,
                     tiling="grid", x_interior_mask=None,
                     y_interior_mask=None, guard=False):
    """The reference's `advect_fused_batched` contract through its jnp
    oracle: T masked Euler steps of `pw_step_ref`'s source per slot, with
    per-slot params and (B, X) / (B, Y) interior masks, then the guard's
    per-(slot, x) isfinite AND over u, v, w (as `jax_masked_loop` in
    tests/test_torch_advection_fused.py, batched)."""
    del interpret, y_tile, tiling

    def one(u, v, w, tcx, tcy, tzc1, tzc2, xm, ym):
        j = jnp.arange(u.shape[0])
        m = ((((j >= 1) & (j <= u.shape[0] - 2) & (xm > 0))[:, None, None])
             & (ym > 0)[None, :, None])
        pp = JREF.AdvectParams(tcx, tcy, tzc1, tzc2)
        for _ in range(T):
            su, sv, sw = JREF.pw_advect_ref(u, v, w, pp)
            u = u + dt * jnp.where(m, su, 0.0)
            v = v + dt * jnp.where(m, sv, 0.0)
            w = w + dt * jnp.where(m, sw, 0.0)
        return u, v, w

    ou, ov, ow = jax.vmap(one)(u, v, w, *p, x_interior_mask,
                               y_interior_mask)
    if not guard:
        return ou, ov, ow
    ok = jnp.ones(ou.shape[:2], bool)
    for f in (ou, ov, ow):
        ok &= jnp.all(jnp.isfinite(f), axis=(2, 3))
    return ou, ov, ow, ok.astype(jnp.float32)


@pytest.fixture
def seam(monkeypatch):
    monkeypatch.setattr(JK, "advect_fused_batched", jax_batched_seam)


# -- (a) within the port, bitwise --------------------------------------------

def test_engine_padded_mixed_extents_bitwise(clean_done):
    assert set(clean_done) == {0, 1, 2}
    for i, (xr, yr, n) in enumerate(SIZES):
        ref = _sequential(i, xr, yr, n)
        assert clean_done[i].status == "done"
        assert len(clean_done[i].states) == n
        for got, want in zip(clean_done[i].states, ref):
            for g, r in zip(got, want):
                assert isinstance(g, np.ndarray) and g.shape == (xr, yr, Z)
                np.testing.assert_array_equal(g, r)
        for g, r in zip(clean_done[i].out, ref[-1]):
            np.testing.assert_array_equal(g, r)


def test_engine_per_request_params_bitwise():
    jp = JREF.default_params(Z)
    scaled = TREF.AdvectParams(np.float32(np.asarray(jp.tcx) * 1.5),
                               np.asarray(jp.tcy), np.asarray(jp.tzc1) * 0.5,
                               np.asarray(jp.tzc2))
    reqs = _reqs()
    reqs[1].params = scaled
    done = TE.StencilServingEngine(_dom(), batch_size=2).run(reqs)
    u, v, w = TSA.stratus_fields(5, 6, Z, seed=1, device="cpu")
    p = TREF.params_from_numpy(scaled, device="cpu")
    for state in done[1].states:
        u, v, w = TK.advect_fused(u, v, w, p, T=T, dt=DT)
        for g, r in zip(state, (u, v, w)):
            np.testing.assert_array_equal(g, r.numpy())


def test_engine_keeps_the_batch_on_its_device():
    eng = TE.StencilServingEngine(_dom(), batch_size=3)
    for t in (eng.u, eng.v, eng.w, eng.xm, eng.ym, *eng._p):
        assert t.device.type == "cpu" and t.shape[0] == 3
    assert tuple(eng.u.shape) == (3, X, Y, Z)
    assert [tuple(p.shape) for p in eng._p] == [(3,), (3,), (3, Z), (3, Z)]


def test_engine_zero_steps_completes_at_prime():
    eng = TE.StencilServingEngine(_dom(), batch_size=2)
    r = _req(0, 5, 6, n_steps=0)
    done = eng.run([r])
    assert done[0].states == []
    np.testing.assert_array_equal(done[0].out[0], r.u)
    assert done[0].out[0] is not r.u
    assert not eng.slots.any_live()
    assert eng.cache_stats()["misses"] == 0      # never launched


def test_engine_validates_requests():
    eng = TE.StencilServingEngine(_dom(), batch_size=1)
    u, v, w = (np.zeros((5, 6, Z), np.float32) for _ in range(3))
    with pytest.raises(ValueError, match="n_steps"):
        eng.run([TE.StencilRequest(uid=0, u=u, v=v, w=w, n_steps=-1)])
    big = np.zeros((X + 1, Y, Z), np.float32)
    with pytest.raises(ValueError, match="slot"):
        eng.run([TE.StencilRequest(uid=1, u=big, v=big, w=big, n_steps=1)])
    zbad = np.zeros((5, 6, Z + 8), np.float32)
    with pytest.raises(ValueError, match="lane"):
        eng.run([TE.StencilRequest(uid=2, u=zbad, v=zbad, w=zbad)])
    thin = np.zeros((2, 6, Z), np.float32)
    with pytest.raises(ValueError, match="interior"):
        eng.run([TE.StencilRequest(uid=3, u=thin, v=thin, w=thin)])
    with pytest.raises(ValueError, match="differ"):
        eng.run([TE.StencilRequest(uid=4, u=u, v=big, w=w)])
    flat = np.zeros((5, 6), np.float32)
    with pytest.raises(ValueError, match=r"\(X, Y, Z\)"):
        eng.run([TE.StencilRequest(uid=5, u=flat, v=flat, w=flat)])
    bad_p = TREF.default_params(Z + 1, device="cpu")
    with pytest.raises(ValueError, match="params"):
        eng.run([TE.StencilRequest(uid=6, u=u, v=v, w=w, params=bad_p)])


def test_engine_refuses_before_allocating():
    with pytest.raises(ValueError, match="fused"):
        TE.StencilServingEngine(_dom(variant="dataflow"))
    with pytest.raises(ValueError, match="batch_size"):
        TE.StencilServingEngine(_dom(), batch_size=0)
    with pytest.raises(ValueError, match="snapshot_every"):
        TE.StencilServingEngine(_dom(), snapshot_every=0)
    # the slot axis of the launch grid
    with pytest.raises(ValueError, match="65535"):
        TE.StencilServingEngine(_dom(), batch_size=TR.MAX_GRID_Y + 1)
    # the batch's device buffers: slots of (2048, 2048, 64) f32
    big = TSA.AdvectionDomain(2048, 2048, 64, variant="fused", device="cpu")
    most = TR.serving_max_batch(big.serving_slot_bytes())
    with pytest.raises(ValueError, match="slot buffers.*batch_size"):
        TE.StencilServingEngine(big, batch_size=most + 1)


def test_executable_cache_builds_once_per_key():
    sizes = [(X, Y, 2), (5, 6, 1), (4, 8, 3), (6, 6, 2)]
    eng = TE.StencilServingEngine(_dom(), batch_size=2)
    eng.run(_reqs(sizes=sizes))
    stats = eng.cache_stats()
    assert stats["misses"] == 1 and stats["entries"] == 1
    assert stats["hits"] == eng.megasteps_executed - 1
    assert eng._step_key() == ((2, X, Y, Z), T, "float32", 1, "collective",
                               (1, 1))


def test_cache_unit_and_lru_bound():
    c = TE.ExecutableCache()
    calls = []
    f = c.get("k1", lambda: calls.append(1) or (lambda: 7))
    g = c.get("k1", lambda: calls.append(1) or (lambda: 9))
    assert f is g and calls == [1]
    assert c.stats() == {"hits": 1, "misses": 1, "entries": 1,
                         "evictions": 0}
    lru = TE.ExecutableCache(max_entries=2)
    for k in ("a", "b", "a", "c", "b"):
        lru.get(k, lambda: object())
    assert lru.stats() == {"hits": 1, "misses": 4, "entries": 2,
                           "evictions": 2}
    assert lru.evict("b") and not lru.evict("zz")
    with pytest.raises(ValueError, match="max_entries"):
        TE.ExecutableCache(max_entries=0)


def test_device_loss_reshard_bitwise_resume(clean_done):
    faulted = TE.StencilServingEngine(_dom(), batch_size=2)
    done_f = faulted.run(_reqs(), lose_device_at=1, reshard_to=1)
    assert set(done_f) == set(clean_done)
    for i in clean_done:
        _assert_bitwise(done_f[i], clean_done[i])
    assert faulted.cache_stats()["misses"] == 2
    assert faulted.cache_stats()["entries"] == 2


def test_reshard_up_mid_flight_bitwise(clean_done):
    eng = TE.StencilServingEngine(_dom(), batch_size=2,
                                  fault_plan="device_loss@1:reshard_to=4")
    done = eng.run(_reqs())
    assert eng.B == 4 and eng.health()["reshards"] == 1
    assert eng.cache_stats()["misses"] == 2
    for uid in done:
        _assert_bitwise(done[uid], clean_done[uid])


def test_nan_poison_rolls_back_then_quarantines(clean_done):
    eng = TE.StencilServingEngine(_dom(), batch_size=2,
                                  fault_plan="nan_poison@1:slot=1,field=v")
    done = eng.run(_reqs())
    h = eng.health()
    assert h["rollbacks"] == 1 and h["quarantines"] == 1
    assert h["faults_injected"] == 2
    [quid] = h["quarantined_uids"]
    assert done[quid].status == "quarantined" and done[quid].out is None
    assert "non-finite" in done[quid].error
    for uid in done:
        if uid != quid:
            assert done[uid].status == "done"
            _assert_bitwise(done[uid], clean_done[uid])


def test_halo_corruption_rolls_back_bitwise(clean_done):
    clean = TE.StencilServingEngine(_dom(), batch_size=2)
    clean.run(_reqs())
    eng = TE.StencilServingEngine(
        _dom(), batch_size=2,
        fault_plan="halo_corruption@1:slot=0,mode=inf,depth=2")
    done = eng.run(_reqs())
    h = eng.health()
    assert h["rollbacks"] == 1 and h["quarantines"] == 0
    for uid in done:
        assert done[uid].status == "done"
        _assert_bitwise(done[uid], clean_done[uid])
    assert eng.megasteps_executed == clean.megasteps_executed + 1


def test_disk_snapshot_rollback_equals_the_in_memory_one(tmp_path,
                                                         clean_done):
    plan = "halo_corruption@1:slot=1"
    mem = TE.StencilServingEngine(_dom(), batch_size=2, fault_plan=plan)
    done_m = mem.run(_reqs())
    disk = TE.StencilServingEngine(_dom(), batch_size=2, fault_plan=plan,
                                   snapshot_dir=tmp_path)
    done_d = disk.run(_reqs())
    assert disk.health() == mem.health()
    assert disk.health()["rollbacks"] == 1
    assert sorted(p.name for p in tmp_path.glob("step_*"))  # on disk
    for uid in done_d:
        _assert_bitwise(done_d[uid], done_m[uid])
        _assert_bitwise(done_d[uid], clean_done[uid])


def test_exchange_stall_retries_then_degrades():
    clean = TE.StencilServingEngine(_dom(exchange="remote_dma"),
                                    batch_size=2)
    done_c = clean.run(_reqs())
    sleeps = []
    eng = TE.StencilServingEngine(
        _dom(exchange="remote_dma"), batch_size=2,
        fault_plan="exchange_stall@1:stalls=10,rung=remote_dma",
        max_retries=2, backoff_s=0.25, sleeper=sleeps.append)
    done = eng.run(_reqs())
    h = eng.health()
    assert h["retries"] == 2 and h["degradations"] == 1
    assert h["exchange"] == "collective"
    assert sleeps == [0.25, 0.5]
    assert any("remote_dma -> collective" in t for t in h["transitions"])
    assert eng.cache_stats()["misses"] == 2       # a new key, one build
    for uid in done:
        _assert_bitwise(done[uid], done_c[uid])


def test_ladder_exhaustion_reshards_down(clean_done):
    eng = TE.StencilServingEngine(
        _dom(), batch_size=2, max_retries=1,
        fault_plan="exchange_stall@1:stalls=10,rung=collective")
    done = eng.run(_reqs())
    h = eng.health()
    assert h["degradations"] == 0 and h["reshards"] == 1
    assert eng.B == 1
    assert any("exhausted" in t for t in h["transitions"])
    for uid in done:
        _assert_bitwise(done[uid], clean_done[uid])


def test_cache_evict_records_eviction_and_rebuild(clean_done):
    eng = TE.StencilServingEngine(_dom(), batch_size=2,
                                  fault_plan="cache_evict@2")
    done = eng.run(_reqs())
    stats = eng.cache_stats()
    assert stats["evictions"] == 1 and stats["misses"] == 2
    assert eng.health()["cache_evictions"] == 1
    for uid in done:
        _assert_bitwise(done[uid], clean_done[uid])


def test_device_loss_plan_matches_deprecated_alias(clean_done):
    eng = TE.StencilServingEngine(_dom(), batch_size=2,
                                  fault_plan="device_loss@1:reshard_to=1")
    done = eng.run(_reqs())
    h = eng.health()
    assert h["device_losses"] == 1 and h["reshards"] == 1
    for uid in done:
        _assert_bitwise(done[uid], clean_done[uid])
    alias = TE.StencilServingEngine(_dom(), batch_size=2)
    done_a = alias.run(_reqs(), lose_device_at=1, reshard_to=1)
    ha = alias.health()
    assert (ha["device_losses"], ha["reshards"]) == (1, 1)
    for uid in done_a:
        _assert_bitwise(done_a[uid], done[uid])
    with pytest.raises(ValueError, match="not both"):
        TE.StencilServingEngine(_dom(), batch_size=2).run(
            _reqs(), lose_device_at=1, fault_plan="cache_evict@1")
    with pytest.raises(ValueError, match="lose_device_at"):
        TE.StencilServingEngine(_dom(), batch_size=2).run(
            _reqs(), lose_device_at=0)


def test_engine_slot_reusable_after_quarantine():
    eng = TE.StencilServingEngine(_dom(), batch_size=2,
                                  fault_plan="nan_poison@1:slot=0")
    eng.run(_reqs())
    assert eng.health()["quarantines"] == 1
    assert not eng.slots.any_live()
    done2 = eng.run([_req(10, X, Y, 2)])
    assert done2[10].status == "done"
    ref = TE.StencilServingEngine(_dom(), batch_size=2).run(
        [_req(10, X, Y, 2)])
    _assert_bitwise(done2[10], ref[10])


def test_health_surface_shape():
    eng = TE.StencilServingEngine(_dom(), batch_size=2,
                                  fault_plan="cache_evict@1")
    eng.run(_reqs())
    h = eng.health()
    for key in ("faults_injected", "faults_skipped", "device_losses",
                "quarantines", "rollbacks", "retries", "degradations",
                "reshards", "cache_evictions", "snapshots", "transitions",
                "plan", "exchange", "quarantined_uids", "cache"):
        assert key in h, key
    assert h["plan"] == "cache_evict@1"


def test_guard_bytes_and_modelled_throughput_of_the_engine():
    eng = TE.StencilServingEngine(_dom(), batch_size=2)
    assert eng.guard_bytes_per_step() == TR.guard_bytes_model(X, Y, Z,
                                                              batch=2)
    assert eng.modelled_throughput() == \
        dataclasses.replace(_dom(), batch=2).serving_throughput()


# -- (b) against the JAX engine ---------------------------------------------

def close(a, b) -> bool:
    """Within VALUE_TOL where finite; NaN and inf in the same places."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return False
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return False
    if not np.array_equal(a[~fa], b[~fb], equal_nan=True):
        return False
    return not fa.any() or float(np.max(np.abs(a[fa] - b[fa]))) <= VALUE_TOL


def assert_engines_agree(mine, ref, done_m, done_r):
    assert sorted(done_m) == sorted(done_r)
    for uid in done_r:
        m, r = done_m[uid], done_r[uid]
        assert (m.status, m.error) == (r.status, r.error), uid
        assert (m.out is None) == (r.out is None), uid
        if r.out is not None:
            assert all(close(a, b) for a, b in zip(m.out, r.out)), uid
        assert len(m.states) == len(r.states), uid
        for sm, sr in zip(m.states, r.states):
            assert all(close(a, b) for a, b in zip(sm, sr)), uid
    assert mine.steps_run == ref.steps_run
    assert mine.megasteps_executed == ref.megasteps_executed
    assert mine.B == ref.B
    assert mine.cache_stats() == ref.cache_stats()
    assert mine.health() == ref.health()


CASES = [
    ("clean", {}, None),
    ("nan_poison", {}, "nan_poison@1:slot=1,field=v"),
    ("nan_poison_inf_w", {}, "nan_poison@2:slot=0,field=w,mode=inf"),
    ("nan_poison_one_shot", {}, "nan_poison@1:slot=0,persistent=false"),
    ("halo_corruption", {}, "halo_corruption@1:slot=0,mode=inf,depth=2"),
    ("device_loss", {}, "device_loss@1:reshard_to=1"),
    ("reshard_up", {}, "device_loss@1:reshard_to=4"),
    ("exchange_stall", dict(exchange="remote_dma"),
     "exchange_stall@1:stalls=10,rung=remote_dma"),
    ("ladder_exhausted", {}, "exchange_stall@1:stalls=10,rung=collective"),
    ("cache_evict", {}, "cache_evict@2"),
    ("skipped", {}, "nan_poison@0:slot=3;halo_corruption@6:slot=1"),
    ("mixed", {}, "halo_corruption@1:slot=1;cache_evict@2;"
     "device_loss@3;nan_poison@4:slot=0"),
]


@pytest.mark.parametrize("name,dom_kw,plan", CASES,
                         ids=[c[0] for c in CASES])
def test_engine_equals_the_jax_engine(seam, name, dom_kw, plan):
    eng_kw = dict(batch_size=2, max_retries=2, backoff_s=0.25)
    sleeps_m, sleeps_r = [], []
    mine = TE.StencilServingEngine(_dom(**dom_kw), fault_plan=plan,
                                   sleeper=sleeps_m.append, **eng_kw)
    ref = JE.StencilServingEngine(_jdom(**dom_kw), fault_plan=plan,
                                  sleeper=sleeps_r.append, **eng_kw)
    assert_engines_agree(mine, ref, mine.run(_reqs()), ref.run(_reqs(JE)))
    assert sleeps_m == sleeps_r


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_engine_equals_the_jax_engine_on_random_plans(seam, seed):
    plan = FaultPlan.random(seed, n_steps=4, batch=2, n_faults=3).describe()
    sizes = SIZES + [(6, 7, 2)]
    mine = TE.StencilServingEngine(_dom(exchange="remote_dma"),
                                   batch_size=2, fault_plan=plan,
                                   max_retries=1, sleeper=lambda s: None)
    ref = JE.StencilServingEngine(_jdom(exchange="remote_dma"),
                                  batch_size=2, fault_plan=plan,
                                  max_retries=1, sleeper=lambda s: None)
    assert_engines_agree(mine, ref, mine.run(_reqs(sizes=sizes)),
                         ref.run(_reqs(JE, sizes=sizes)))


def test_engine_equals_the_jax_engine_with_disk_snapshots(seam, tmp_path):
    plan = "halo_corruption@1:slot=1;device_loss@2:reshard_to=1"
    mine = TE.StencilServingEngine(_dom(), batch_size=2, fault_plan=plan,
                                   snapshot_dir=tmp_path / "port")
    ref = JE.StencilServingEngine(_jdom(), batch_size=2, fault_plan=plan,
                                  snapshot_dir=tmp_path / "ref")
    assert_engines_agree(mine, ref, mine.run(_reqs()), ref.run(_reqs(JE)))


def test_engine_equals_the_jax_engine_without_snapshots(seam):
    plan = "nan_poison@1:slot=1"
    mine = TE.StencilServingEngine(_dom(), batch_size=2, fault_plan=plan,
                                   snapshot_every=None)
    ref = JE.StencilServingEngine(_jdom(), batch_size=2, fault_plan=plan,
                                  snapshot_every=None)
    assert_engines_agree(mine, ref, mine.run(_reqs()), ref.run(_reqs(JE)))
    assert mine.health()["rollbacks"] == 0


def test_engine_equals_the_jax_engine_on_the_deprecated_alias(seam):
    mine = TE.StencilServingEngine(_dom(), batch_size=2)
    ref = JE.StencilServingEngine(_jdom(), batch_size=2)
    assert_engines_agree(mine, ref,
                         mine.run(_reqs(), lose_device_at=2),
                         ref.run(_reqs(JE), lose_device_at=2))


@needs_unblocked
def test_engine_equals_the_unpatched_jax_engine():
    plan = "nan_poison@1:slot=1;device_loss@2:reshard_to=1"
    mine = TE.StencilServingEngine(_dom(), batch_size=2, fault_plan=plan)
    ref = JE.StencilServingEngine(_jdom(), batch_size=2, fault_plan=plan)
    assert_engines_agree(mine, ref, mine.run(_reqs()), ref.run(_reqs(JE)))


# -- (c) the models ---------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2, 7, 40])
@pytest.mark.parametrize("hbm,slot,wire,over,budget,bw", [
    (1e6, 10_000, 0.0, 50e-6, 16 * 1024**2, 819e9),
    (3.2e7, 123_456, 2e-6, 1e-4, 4 * 1024**3, 3.35e12),
    (5e5, 100_000, 0.0, 60e-6, 10**9, 1e12),
])
def test_serving_throughput_model_pinned_to_the_references(batch, hbm, slot,
                                                           wire, over,
                                                           budget, bw):
    mine = TR.serving_throughput_model(
        batch, hbm_bytes_per_domain=hbm, slot_bytes=slot,
        exposed_wire_s_per_domain=wire, launch_overhead_s=over,
        device_budget=budget, hbm_bw=bw)
    ref = JR.serving_throughput_model(
        batch, hbm_bytes_per_domain=hbm, ring_bytes_per_slot=slot,
        exposed_wire_s_per_domain=wire, launch_overhead_s=over,
        vmem_budget=budget, hbm_bw=bw)
    assert mine == ref
    assert TR.serving_max_batch(slot, device_budget=budget) == \
        JR.serving_max_batch(slot, vmem_budget=budget)


@pytest.mark.parametrize("shape", [(64, 256, 64), (512, 512, 64)])
def test_serving_throughput_rises_to_the_bound_then_refuses(shape):
    dom = TSA.AdvectionDomain(*shape, variant="fused", device="cpu")
    slot = dom.serving_slot_bytes()
    max_b = TR.serving_max_batch(slot)
    assert max_b == min(TR.HBM_PER_CHIP // slot, TR.MAX_GRID_Y) >= 8
    hbm = dom.hbm_bytes_per_step()
    tputs = [TR.serving_throughput_model(b, hbm_bytes_per_domain=hbm,
                                         slot_bytes=slot)
             for b in range(1, max_b + 1)]
    assert all(b > a for a, b in zip(tputs, tputs[1:]))
    assert tputs[-1] < 1.0 / (hbm / TR.HBM_BW)     # under the stream rate
    with pytest.raises(ValueError, match="serving bound"):
        TR.serving_throughput_model(max_b + 1, hbm_bytes_per_domain=hbm,
                                    slot_bytes=slot)
    assert [dataclasses.replace(dom, batch=b).serving_throughput()
            for b in (1, 4)] == [tputs[0], tputs[3]]


def test_serving_bound_refusals_and_grid_cap():
    assert TR.serving_max_batch(1) == TR.MAX_GRID_Y
    with pytest.raises(ValueError, match="device-memory budget"):
        TR.serving_max_batch(TR.HBM_PER_CHIP + 1)
    with pytest.raises(ValueError, match="slot_bytes"):
        TR.serving_max_batch(0)
    for kw, match in ((dict(batch=0), "batch"),
                      (dict(hbm_bytes_per_domain=0.0), "hbm_bytes"),
                      (dict(exposed_wire_s_per_domain=-1.0), "wire"),
                      (dict(launch_overhead_s=0.0), "launch_overhead")):
        args = dict(batch=1, hbm_bytes_per_domain=1e6, slot_bytes=100)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            TR.serving_throughput_model(args.pop("batch"), **args)
    assert TR.serving_slot_bytes_model(4, 5, 6) == (
        3 * 3 * 4 * 5 * 6 * 4 + (4 + 5) * 4 + (2 + 2 * 6) * 4 + 4 * 4)
    assert TR.SERVING_LAUNCH_OVERHEAD_S != JR.SERVING_LAUNCH_OVERHEAD_S


ACCOUNTING = ("flops_per_step", "hbm_bytes_per_step",
              "hbm_bytes_per_shard_step", "halo_wire_bytes_per_step",
              "vmem_register_bytes", "vmem_halo_bytes_per_step",
              "guard_bytes_per_step")


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("kw", [dict(), dict(mesh_nx=2, mesh_ny=2),
                                dict(mesh_ny=2, fuse_T=1, y_tile=4)])
def test_domain_batch_accounting_scales_and_equals_the_references(batch,
                                                                   kw):
    shape = (16, 24, 128)       # lane-aligned: the reference's byte models
                                # then price what the port's do
    one = TSA.AdvectionDomain(*shape, variant="fused", device="cpu", **kw)
    many = dataclasses.replace(one, batch=batch)
    ref = JSA.AdvectionDomain(*shape, variant="fused", batch=batch, **kw)
    for name in ACCOUNTING:
        got = getattr(many, name)()
        assert got == batch * getattr(one, name)(), name
        assert got == getattr(ref, name)(), name
    with pytest.raises(ValueError, match="batch"):
        TSA.AdvectionDomain(*shape, variant="fused", device="cpu", batch=0)


def test_domain_serving_throughput_is_the_references_formula():
    dom = TSA.AdvectionDomain(64, 256, 64, variant="fused", device="cpu",
                              batch=4)
    want = JR.serving_throughput_model(
        4, hbm_bytes_per_domain=dom.hbm_bytes_per_step() / 4,
        ring_bytes_per_slot=dom.serving_slot_bytes(),
        launch_overhead_s=TR.SERVING_LAUNCH_OVERHEAD_S,
        vmem_budget=TR.HBM_PER_CHIP, hbm_bw=TR.HBM_BW)
    assert dom.serving_throughput() == want


# -- (d) the CLI ------------------------------------------------------------

CLI_PLANS = [None, "nan_poison@1:slot=1;device_loss@2:reshard_to=1",
             "halo_corruption@1:slot=0;cache_evict@3"]


def cli_lines(text: str):
    """The lines both CLIs print alike: the cache counters (without the
    wall time), the health counters and transitions, and each job's
    extent, status and streamed-state count."""
    out = []
    for line in text.splitlines():
        if "executable cache" in line:
            out.append(re.sub(r" in [0-9.]+s;", ";", line))
        elif line.startswith(("[serve] health", "  [health]")):
            out.append(line)
        elif line.startswith("  job"):
            out.append(line.split(", |u|max")[0])
    return out


@pytest.mark.parametrize("plan", CLI_PLANS)
def test_serve_stencil_cli_prints_the_references_health(seam, capsys, plan):
    from repro.launch import serve as JSERVE

    argv = ["--smoke", "--stencil", "--device", "cpu"]
    if plan is not None:
        argv += ["--fault-plan", plan]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                         + argv, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    JSERVE._run_stencil(Namespace(smoke=True, fault_plan=plan,
                                  lose_device_at=None, batch_size=4,
                                  requests=8, max_new=16))
    ref = capsys.readouterr().out
    mine = cli_lines(out.stdout)
    assert mine == cli_lines(ref)
    assert len(mine) >= 6
    assert re.search(r"modelled serving throughput at batch=\d+: [0-9.]+ "
                     r"domains/s; measured [0-9.]+ domains/s \(both "
                     r"domain-steps/s; [0-9.]+ finished jobs/s\) on cpu",
                     out.stdout)


def test_serve_stencil_cli_deprecated_alias(seam, capsys):
    from repro.launch import serve as JSERVE

    TSERVE.main(["--smoke", "--stencil", "--device", "cpu", "--requests",
                 "4", "--lose-device-at", "2"])
    mine = capsys.readouterr().out
    JSERVE._run_stencil(Namespace(smoke=True, fault_plan=None,
                                  lose_device_at=2, batch_size=4,
                                  requests=4, max_new=16))
    ref = capsys.readouterr().out
    assert "deprecated" in mine
    assert cli_lines(mine) == cli_lines(ref)
    with pytest.raises(SystemExit, match="only one"):
        TSERVE.main(["--smoke", "--stencil", "--device", "cpu",
                     "--lose-device-at", "2", "--fault-plan", "cache_evict@1"])


def test_serve_stencil_traffic_is_the_references():
    for smoke in (True, False):
        Xs, Ys, Zs, _ = TSERVE.STENCIL_SHAPES[smoke]
        rng = np.random.default_rng(0)
        got = TSERVE.stencil_requests(Xs, Ys, Zs, 8, 16)
        for i, r in enumerate(got):
            Xr = int(rng.integers(4, Xs + 1))
            Yr = int(rng.integers(4, Ys + 1))
            n = int(rng.integers(1, 17))
            assert (r.uid, r.n_steps, r.u.shape) == (i, n, (Xr, Yr, Zs))
            want = JSA.stratus_fields(Xr, Yr, Zs, seed=i)
            assert all(a.tobytes() == np.asarray(b).tobytes()
                       for a, b in zip((r.u, r.v, r.w), want))
