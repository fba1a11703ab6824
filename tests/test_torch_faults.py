"""The port's fault plan, injector, degradation ladder and retry loop
(`repro_torch.serving.faults`) against the reference's
(`repro.serving.faults`): the same plans, strings, counters and sleeps."""
import dataclasses

import numpy as np
import pytest
import torch

from _prop import given, settings, st
from repro.serving import faults as JF
from repro_torch.kernels.advection.ref import default_params
from repro_torch.launch import mesh as TM
from repro_torch.serving import faults as TF


def plan_fields(plan):
    """A plan as plain tuples of its faults' fields, comparable across the
    two packages."""
    return tuple(dataclasses.astuple(f) for f in plan.faults), plan.seed


def test_constants_equal_the_references():
    assert TF.FAULT_KINDS == JF.FAULT_KINDS
    assert TF.DEFAULT_LADDER == JF.DEFAULT_LADDER
    assert TF.ELASTIC_LADDER == JF.ELASTIC_LADDER
    assert TF._COUNTERS == JF._COUNTERS
    assert [f.name for f in dataclasses.fields(TF.Fault)] == \
        [f.name for f in dataclasses.fields(JF.Fault)]


def test_fault_plan_parse_describe_roundtrip():
    spec = ("nan_poison@1:slot=1,field=v,mode=inf;"
            "exchange_stall@2:stalls=6,rung=remote_dma;"
            "device_loss@3:reshard_to=1;"
            "halo_corruption@4:depth=2;cache_evict@5")
    mine, ref = TF.FaultPlan.parse(spec), JF.FaultPlan.parse(spec)
    assert plan_fields(mine) == plan_fields(ref)
    assert mine.describe() == ref.describe()
    assert mine.max_step() == ref.max_step() == 5
    assert TF.FaultPlan().max_step() == JF.FaultPlan().max_step() == -1
    for step in range(7):
        assert [dataclasses.astuple(f) for f in mine.at(step)] == \
            [dataclasses.astuple(f) for f in ref.at(step)]
    assert TF.FaultPlan.parse(mine.describe()).faults == mine.faults


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       n_steps=st.integers(min_value=0, max_value=9),
       batch=st.integers(min_value=0, max_value=8),
       n_faults=st.integers(min_value=0, max_value=6))
def test_random_plan_equals_the_references(seed, n_steps, batch, n_faults):
    mine = TF.FaultPlan.random(seed, n_steps=n_steps, batch=batch,
                               n_faults=n_faults)
    ref = JF.FaultPlan.random(seed, n_steps=n_steps, batch=batch,
                              n_faults=n_faults)
    assert plan_fields(mine) == plan_fields(ref)
    assert mine.describe() == ref.describe()
    assert TF.FaultPlan.parse(mine.describe()).describe() == mine.describe()


@pytest.mark.parametrize("kinds", [("nan_poison", "halo_corruption"),
                                   ("device_loss",), ("exchange_stall",
                                                      "cache_evict")])
def test_random_plan_of_some_kinds_equals_the_references(kinds):
    mine = TF.FaultPlan.random(11, n_steps=5, batch=4, n_faults=5,
                               kinds=kinds)
    ref = JF.FaultPlan.random(11, n_steps=5, batch=4, n_faults=5,
                              kinds=kinds)
    assert plan_fields(mine) == plan_fields(ref)


@settings(max_examples=25, deadline=None)
@given(kind=st.sampled_from(TF.FAULT_KINDS),
       at_step=st.integers(min_value=0, max_value=99),
       slot=st.integers(min_value=0, max_value=7),
       field=st.sampled_from(("u", "v", "w")),
       mode=st.sampled_from(("nan", "inf")),
       reshard_to=st.one_of(st.none(), st.integers(min_value=1,
                                                    max_value=8)),
       stalls=st.integers(min_value=1, max_value=9),
       rung=st.sampled_from(("remote_dma", "collective")),
       depth=st.integers(min_value=1, max_value=4),
       persistent=st.one_of(st.none(), st.booleans()))
def test_fault_describe_parse_roundtrip_all_kinds(kind, at_step, slot, field,
                                                  mode, reshard_to, stalls,
                                                  rung, depth, persistent):
    kw = dict(kind=kind, at_step=at_step, slot=slot, field=field, mode=mode,
              reshard_to=reshard_to, stalls=stalls, rung=rung, depth=depth,
              persistent=persistent)
    mine, ref = TF.Fault(**kw), JF.Fault(**kw)
    assert mine.describe() == ref.describe()
    assert mine.is_persistent == ref.is_persistent
    assert str(mine.value()) == str(ref.value())
    back = TF.FaultPlan.parse(TF.FaultPlan(faults=(mine,)).describe())
    assert back.faults == (mine,)
    assert plan_fields(back) == plan_fields(
        JF.FaultPlan.parse(JF.FaultPlan(faults=(ref,)).describe()))


@pytest.mark.parametrize("spec", [
    "nan_poison",                   # missing @step
    "nan_poison@soon",              # non-integer step
    "nan_poison@1:slot",            # option without =
    "nan_poison@1:turbo=3",         # unknown key
    "nan_poison@1:slot=much",       # bad value
    "warp_core_breach@1",           # unknown kind
    "nan_poison@-1",                # negative step
    "nan_poison@1:field=q",
    "nan_poison@1:mode=zero",
    "exchange_stall@1:stalls=0",
    "halo_corruption@1:depth=0",
    "device_loss@1:reshard_to=0",
])
def test_malformed_specs_raise_the_references_message(spec):
    with pytest.raises(ValueError) as mine:
        TF.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as ref:
        JF.FaultPlan.parse(spec)
    assert str(mine.value) == str(ref.value)


def test_parse_values():
    for key, raw in (("field", "v"), ("persistent", "yes"),
                     ("persistent", "0"), ("reshard_to", "None"),
                     ("depth", "3")):
        assert TF._parse_value(key, raw) == JF._parse_value(key, raw)


def test_degradation_ladder_transitions():
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="start rung"):
            mod.DegradationLadder(start="smoke_signals")
        with pytest.raises(ValueError, match="at least one"):
            mod.DegradationLadder(rungs=())
    runs = []
    for mod in (TF, JF):
        lad = mod.DegradationLadder(mod.ELASTIC_LADDER)
        seen = [lad.current]
        seen.append(lad.degrade("stall"))
        seen.append(lad.degrade("stall again"))
        with pytest.raises(mod.RecoveryExhausted) as e:
            lad.degrade("and again")
        runs.append((seen, lad.transitions, str(e.value)))
        started = mod.DegradationLadder(start="collective")
        assert started.current == "collective"
    assert runs[0] == runs[1]
    assert runs[0][0] == ["remote_dma", "collective", "mesh_shrink"]


def test_injector_stall_arming_and_counters():
    spec = ("exchange_stall@0:stalls=2,rung=remote_dma;nan_poison@0;"
            "halo_corruption@1;cache_evict@1")
    logs = []
    for mod in (TF, JF):
        inj = mod.FaultInjector(mod.FaultPlan.parse(spec))
        log = []
        for idx, f in inj.due(0):
            if f.kind == "exchange_stall":
                inj.arm_stall(idx, f)
            inj.mark_fired(idx)
        for rung in ("remote_dma", "remote_dma", "remote_dma"):
            try:
                inj.poll_stall(rung)
                log.append("passed")
            except mod.ExchangeStalled as e:
                log.append(str(e))
        log.append([i for i, _ in inj.due(0)])   # the persistent poison
        [(idx, _), _] = inj.due(1)
        inj.skip(idx, "slot 0 not live")
        log.append([i for i, _ in inj.due(1)])
        inj.record("retries", 3)
        inj.note("an event")
        with pytest.raises(KeyError, match="unknown health counter"):
            inj.record("optimism")
        inj.arm_stall(0, f)
        inj.clear_stalls()
        inj.poll_stall("remote_dma")
        log.append(inj.health())
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][:3] == ["injected stall on rung 'remote_dma' (1 more)",
                           "injected stall on rung 'remote_dma' (0 more)",
                           "passed"]


def test_injector_stall_cleared_by_degrading_past_its_rung():
    for mod in (TF, JF):
        inj = mod.FaultInjector(mod.FaultPlan.parse(
            "exchange_stall@0:stalls=2,rung=remote_dma"))
        [(idx, f)] = inj.due(0)
        inj.arm_stall(idx, f)
        inj.mark_fired(idx)
        with pytest.raises(mod.ExchangeStalled):
            inj.poll_stall("remote_dma")
        inj.poll_stall("collective")
        inj.poll_stall("remote_dma")
        assert inj.due(0) == []


def flaky(n, mod):
    calls = {"n": 0}

    def attempt():
        calls["n"] += 1
        if calls["n"] <= n:
            raise mod.ExchangeStalled("transient")
        return "ok"

    return attempt, calls


@pytest.mark.parametrize("kw", [
    dict(max_retries=3, backoff_s=0.1),
    dict(max_retries=5, backoff_s=0.1, max_backoff_s=0.25),
    dict(max_retries=4, backoff_s=0.1, jitter_seed=7),
    dict(max_retries=6, backoff_s=0.3, max_backoff_s=1.0, jitter_seed=123),
    dict(max_retries=2, backoff_s=0.0),
])
@pytest.mark.parametrize("n_stalls", [0, 2, 4])
def test_retry_with_backoff_sleeps_as_the_reference(kw, n_stalls):
    results = []
    for mod in (TF, JF):
        sleeps, retried = [], []
        attempt, calls = flaky(n_stalls, mod)
        try:
            out = mod.retry_with_backoff(
                attempt, sleeper=sleeps.append,
                on_retry=lambda k, e: retried.append(k), **kw)
        except mod.ExchangeStalled as e:
            out = f"stalled: {e}"
        results.append((out, sleeps, retried, calls["n"]))
    assert results[0] == results[1]


def test_retry_with_backoff_cap_and_seeded_jitter():
    attempt, _ = flaky(4, TF)
    sleeps = []
    assert TF.retry_with_backoff(attempt, max_retries=5, backoff_s=0.1,
                                 max_backoff_s=0.25,
                                 sleeper=sleeps.append) == "ok"
    assert sleeps == [0.1, 0.2, 0.25, 0.25]
    attempt, _ = flaky(3, TF)
    sleeps = []
    TF.retry_with_backoff(attempt, max_retries=4, backoff_s=0.1,
                          jitter_seed=7, sleeper=sleeps.append)
    rng = np.random.default_rng(7)
    assert sleeps == [0.1 * 2 ** k * (0.5 + 0.5 * float(rng.random()))
                      for k in range(3)]


def test_retry_with_backoff_refusals_and_other_errors():
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="max_retries"):
            mod.retry_with_backoff(lambda: 1, max_retries=-1)
        with pytest.raises(ValueError, match="max_backoff_s"):
            mod.retry_with_backoff(lambda: 1, max_backoff_s=-1.0)

        def broken():
            raise RuntimeError("not a stall")

        with pytest.raises(RuntimeError, match="not a stall"):
            mod.retry_with_backoff(broken, max_retries=5)


def test_resilient_distributed_run_names_its_slice():
    """The run is ported (tests/test_torch_recovery.py holds it against
    the reference); what stays here is its refusals, the reference's."""
    mesh = TM.make_stencil_mesh(1, 2, devices=["cpu"] * 2)
    u = torch.zeros(4, 4, 4)
    args = (mesh, default_params(4, device="cpu"), u, u, u)
    with pytest.raises(ValueError, match="ladder must start on an exchange "
                                         "rung"):
        TF.resilient_distributed_run(*args, n_blocks=1,
                                     ladder=TF.DegradationLadder(
                                         TF.ELASTIC_LADDER,
                                         start=TF.MESH_SHRINK))
    with pytest.raises(ValueError, match="checkpoint_every must be"):
        TF.resilient_distributed_run(*args, n_blocks=1, checkpoint_every=0)
    with pytest.raises(ValueError, match="max_replays must be"):
        TF.resilient_distributed_run(*args, n_blocks=1, max_replays=-1)
