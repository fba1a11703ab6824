"""The port's training path against the JAX package's, on the CPU.

Covers the kernel routes' refusal of gradients (K8 and K9 are forward-only,
as the reference's Pallas calls), `attn_flash`'s backward, AdamW and its
schedule, the train step (grad_accum, the NaN guard), remat and the
grouped stacks, the synthetic data, the head relayout, the model half of
the checkpoint, the train loop's resume and the host mesh.

Tolerances: port against port is bitwise wherever both run the same
operations (remat modes, scan groups, resume). Port against JAX, in f32:
the loss within 1e-5 x max(1, |loss|), gradients and updated params within
the relative bounds each test states (f32 rounding of the two frameworks'
orders of summation)."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pspec as JP
from repro.config import RunShape as JRunShape
from repro.configs import get_smoke_config as j_smoke
from repro.core import roofline as JR
from repro.data import pipeline as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import relayout as JRL
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training import step as JS
from repro_torch import pspec as TP
from repro_torch.config import RunShape, SHAPES
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import roofline as TR
from repro_torch.data import pipeline as TD
from repro_torch.kernels.attention import attention as TA
from repro_torch.kernels.attention import ops as TAO
from repro_torch.kernels.ssm import ops as TSO
from repro_torch.kernels.ssm import ssm as TSS
from repro_torch.launch import mesh as TMESH
from repro_torch.launch.train import train_loop
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import relayout as TRL
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO
from repro_torch.training import step as TS

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-32b"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_leaves(tree):
    return TP.tree_leaves(tree, is_leaf=torch.is_tensor)


def j_leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def tokens_batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def to_t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def f32_cfgs(arch=ARCH, **kw):
    return (j_smoke(arch).replace(compute_dtype="float32", **kw),
            get_smoke_config(arch).replace(compute_dtype="float32", **kw))


@functools.lru_cache(maxsize=None)
def j_state(arch=ARCH, **kw):
    cfg = j_smoke(arch).replace(**kw)
    return np_tree(JS.init_state(cfg, JM.make_layout(cfg, 1),
                                 jax.random.PRNGKey(0)))


def same_tree(a, b) -> bool:
    la, lb = t_leaves(a), t_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the repair: K8's and K9's entry points are forward-only
# ---------------------------------------------------------------------------


def _attn_args(grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 32, 16, generator=g, requires_grad=grad)
    k = torch.randn(1, 2, 32, 16, generator=g)
    v = torch.randn(1, 2, 32, 16, generator=g)
    return q, k, v


def _gqa_args(grad):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 32, 2, 2, 16, generator=g)
    k = torch.randn(1, 32, 2, 16, generator=g, requires_grad=grad)
    v = torch.randn(1, 32, 2, 16, generator=g)
    return q, k, v


def _scan_args(grad):
    g = torch.Generator().manual_seed(2)
    B, S, D, N = 1, 16, 8, 4
    xc = torch.randn(B, S, D, generator=g)
    dt = torch.rand(B, S, D, generator=g).mul_(0.1).requires_grad_(grad)
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N,
                                                            generator=g)
    A = -torch.rand(D, N, generator=g)
    return xc, dt, Bm, Cm, A, torch.zeros(B, D, N)


ENTRY_POINTS = {
    "flash_attention": (lambda grad: TA.flash_attention(*_attn_args(grad))),
    "gqa_layout_attention": (
        lambda grad: TAO.gqa_layout_attention(*_gqa_args(grad))),
    "selective_scan": (
        lambda grad: TSS.selective_scan(*_scan_args(grad), chunk=8)),
    "mamba_scan": (lambda grad: TSO.mamba_scan(*_scan_args(grad), chunk=8)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_kernel_routes_refuse_grad(name):
    with pytest.raises(RuntimeError, match="forward-only.*'flash'"):
        ENTRY_POINTS[name](True)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_kernel_routes_run_without_grad(name):
    with torch.no_grad():
        grad_off = ENTRY_POINTS[name](True)
    plain = ENTRY_POINTS[name](False)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (grad_off, plain))):
        assert torch.equal(a, b)


def test_pallas_model_refuses_training_and_serves():
    """`attention_impl="pallas"` (K8's and K9's routes) raises under a
    train step, as `jax.grad` through the reference's Pallas calls fails;
    its forward under no_grad is unchanged."""
    for arch in (ARCH, "falcon-mamba-7b"):
        cfg = get_smoke_config(arch).replace(attention_impl="pallas",
                                             compute_dtype="float32")
        layout = TM.make_layout(cfg, 1)
        params = params_from_numpy(np_tree(JP.init_params(
            JM.param_specs(j_smoke(arch), JM.make_layout(j_smoke(arch), 1)),
            jax.random.PRNGKey(0))), device="cpu")
        batch = to_t(tokens_batch(cfg.vocab_size))
        with pytest.raises(RuntimeError, match="forward-only"):
            TS.loss_and_grads(params, batch, cfg, layout)
        with torch.no_grad():
            loss, _ = TM.loss_fn(params, batch, cfg, layout)
            ref, _ = TM.loss_fn(params, batch,
                                cfg.replace(attention_impl="chunked"), layout)
        assert abs(float(loss) - float(ref)) < 1e-5


# ---------------------------------------------------------------------------
# attn_flash
# ---------------------------------------------------------------------------


def _qkv(seed, B=2, S=64, K=2, G=3, D=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, K, G, D), (B, S, K, D), (B, S, K, D))]


def test_attn_flash_vjp_matches_dense():
    """The reference's `test_flash_vjp_matches_dense`, on the port."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv(2))
    pos = torch.arange(q.shape[1])

    def grads(f):
        out = f(q, k, v)
        return torch.autograd.grad((out ** 2).sum(), (q, k, v))

    g1 = grads(lambda q, k, v: TL.attn_dense(q, k, v, q_pos=pos, kv_pos=pos,
                                             causal=True, scale=0.25))
    g2 = grads(lambda q, k, v: TL.attn_flash(q, k, v, pos, pos, True, 0.25,
                                             16))
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) < 1e-4


@pytest.mark.parametrize("causal,chunk", [(True, 16), (True, 64),
                                          (False, 32)])
def test_attn_flash_equals_reference(causal, chunk):
    """Forward and VJP == the reference's `attn_flash` (f32, 1e-5 of the
    largest value)."""
    q, k, v = _qkv(3)
    rng = np.random.default_rng(4)
    do = rng.normal(size=q.shape).astype(np.float32)
    pos = np.arange(q.shape[1])
    jf = lambda q, k, v: JL.attn_flash(q, k, v, jnp.asarray(pos),  # noqa
                                       jnp.asarray(pos), causal, 0.25, chunk)
    jout, jvjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = jvjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tpos = torch.arange(q.shape[1])
    tout = TL.attn_flash(tq, tk, tv, tpos, tpos, causal, 0.25, chunk)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.tensor(do))
    for got, want in zip((tout,) + tgrads, (jout,) + tuple(jgrads)):
        want = np.asarray(want)
        assert np.max(np.abs(got.detach().numpy() - want)) <= \
            1e-5 * max(1.0, np.max(np.abs(want)))


def test_attn_flash_refuses_uneven_chunks():
    q, k, v = (torch.tensor(a) for a in _qkv(5, S=49))
    pos = torch.arange(49)
    with pytest.raises(ValueError, match="equal chunks"):
        TL.attn_flash(q, k, v, pos, pos, True, 0.25, 20)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_equals_reference_over_100_steps():
    oc = TO.OptConfig(peak_lr=3e-3, warmup_steps=20, total_steps=100)
    joc = JO.OptConfig(peak_lr=3e-3, warmup_steps=20, total_steps=100)
    got = np.array([float(TO.lr_at(torch.tensor(s, dtype=torch.int32), oc))
                    for s in range(100)])
    want = np.array([float(JO.lr_at(jnp.asarray(s, jnp.int32), joc))
                     for s in range(100)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] < got[19] and got[30] > got[90] >= 3e-4 * (1 - 1e-6)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": [rng.normal(size=(3,)).astype(np.float32),
                  rng.normal(size=(2, 3, 4)).astype(np.float32)]}


@pytest.mark.parametrize("step,clip", [(0, 1.0), (7, 1.0), (250, 1e9)])
def test_adamw_update_equals_reference(step, clip):
    """One update from a state at `step` with random moments == the
    reference's, within 2 f32 ulps of each value (its pow and cos may
    round otherwise)."""
    p, g = _opt_tree(0), _opt_tree(1)
    m = _opt_tree(2)
    v = jax.tree.map(np.abs, _opt_tree(3))
    oc = dict(peak_lr=1e-3, warmup_steps=10, total_steps=300, clip_norm=clip)
    jp, jstate, jmet = JO.adamw_update(
        p, g, {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)},
        JO.OptConfig(**oc))
    tp, tstate, tmet = TO.adamw_update(
        params_from_numpy(p, device="cpu"), params_from_numpy(g, device="cpu"),
        {"m": params_from_numpy(m, device="cpu"),
         "v": params_from_numpy(v, device="cpu"),
         "step": torch.tensor(step, dtype=torch.int32)}, TO.OptConfig(**oc))
    assert int(tstate["step"]) == step + 1
    for got, want in zip(t_leaves([tp, tstate["m"], tstate["v"]]),
                         j_leaves([jp, jstate["m"], jstate["v"]])):
        np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=1e-9)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=1e-6)


def test_adamw_update_in_slices_equals_whole():
    """A leaf updated slice by slice == updated whole, bitwise (the update
    is elementwise; only the global norm reads across slices)."""
    p, g = _opt_tree(0), _opt_tree(1)
    states = []
    for limit in (TO.SLICE_ELEMS, 4):
        tp = params_from_numpy(p, device="cpu")
        st = TO.init_opt_state(tp)
        orig = TO.SLICE_ELEMS
        try:
            TO.slices.__defaults__ = (limit,)
            TO.adamw_update(tp, params_from_numpy(g, device="cpu"), st,
                            TO.OptConfig())
        finally:
            TO.slices.__defaults__ = (orig,)
        states.append((tp, st))
    assert same_tree(states[0], states[1])
    assert [tuple(s.shape) for s in TO.slices(torch.zeros(5, 7), 4)] == \
        [(4,), (3,)] * 5
    assert [tuple(s.shape) for s in TO.slices(torch.zeros(6, 2), 4)] == \
        [(2, 2)] * 3


def test_adamw_converges_quadratic():
    oc = TO.OptConfig(peak_lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = TO.init_opt_state(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), (w,))
        TO.adamw_update(params, {"w": g}, opt, oc)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2


def test_clip_by_global_norm():
    clipped, gn = TO.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert abs(float(gn) - 20.0) < 1e-5
    assert abs(float(TO.global_norm(clipped)) - 1.0) < 1e-5
    same, _ = TO.clip_by_global_norm({"a": torch.full((4,), 0.01)}, 1.0)
    assert torch.allclose(same["a"], torch.full((4,), 0.01), rtol=1e-6)


def test_adamw_guard_keeps_state_bitwise():
    tp = params_from_numpy(_opt_tree(0), device="cpu")
    st = TO.init_opt_state(tp)
    TO.adamw_update(tp, params_from_numpy(_opt_tree(1), device="cpu"), st,
                    TO.OptConfig())
    before = TP.tree_map(torch.clone, [tp, st], is_leaf=torch.is_tensor)
    bad = TP.tree_map(lambda a: a * float("nan"),
                      params_from_numpy(_opt_tree(1), device="cpu"),
                      is_leaf=torch.is_tensor)
    gn = TO.global_norm(bad)
    TO.adamw_update(tp, bad, st, TO.OptConfig(), gnorm=gn,
                    good=torch.isfinite(gn))
    assert same_tree([tp, st], before)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _step_pair(accum, oc_kw):
    jcfg, tcfg = f32_cfgs(grad_accum=accum)
    state = j_state()
    batch = tokens_batch(jcfg.vocab_size, B=4, seed=0)
    js, jm = JS.make_train_step(jcfg, JM.make_layout(jcfg, 1),
                                opt=JO.OptConfig(**oc_kw))(
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, batch))
    ts = state_from_numpy(state, device="cpu")
    ts, tm = TS.make_train_step(tcfg, TM.make_layout(tcfg, 1),
                                opt=TO.OptConfig(**oc_kw))(ts, to_t(batch))
    return (np_tree(js), jm), (ts, tm)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_equals_reference(accum):
    """One step from the reference's state, grad_accum 1 and 2: loss within
    1e-5; updated params within 1e-5 of each value plus 1e-5, 1 % of the
    step's lr (the update divides by sqrt(v), so where a gradient is near
    0 its f32 difference moves that element's step; 2 of 8192 elements
    read 1.0e-6 off); moments within 1e-4 of each leaf's largest."""
    (js, jm), (ts, tm) = _step_pair(accum, dict(peak_lr=1e-3,
                                                warmup_steps=0,
                                                total_steps=10))
    assert bool(tm["good"]) and bool(jm["good"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * max(
        1.0, abs(float(jm["loss"])))
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 1
    for got, want in zip(t_leaves(ts["params"]), j_leaves(js["params"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for got, want in zip(t_leaves([ts["opt"]["m"], ts["opt"]["v"]]),
                         j_leaves([js["opt"]["m"], js["opt"]["v"]])):
        assert np.max(np.abs(got.numpy() - want)) <= 1e-4 * max(
            np.max(np.abs(want)), 1e-30)


def test_grad_accum_equivalence():
    """accum=2 matches accum=1 on the same global batch (clip disabled),
    at the reference test's tolerances."""
    runs = []
    for accum in (1, 2):
        _, tcfg = f32_cfgs(grad_accum=accum)
        ts = state_from_numpy(j_state(), device="cpu")
        oc = TO.OptConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                          clip_norm=1e9, weight_decay=0.0)
        batch = to_t(tokens_batch(tcfg.vocab_size, B=4, seed=0))
        runs.append(TS.make_train_step(tcfg, TM.make_layout(tcfg, 1),
                                       opt=oc)(ts, batch))
    (s1, m1), (s2, m2) = runs
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    for a, b in zip(t_leaves(s1["params"]), t_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2,
                                   atol=2e-4)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-72b"])
def test_nan_guard_leaves_state_bitwise(arch):
    """A poisoned step (float inputs times NaN for the vlm; the loss times
    NaN for a token batch) is not good and leaves params, moments and step
    unchanged, bitwise; so does the reference's on the vlm."""
    _, tcfg = f32_cfgs(arch)
    ts = state_from_numpy(j_state(arch), device="cpu")
    step = TS.make_train_step(tcfg, TM.make_layout(tcfg, 1))
    batch = to_t(TD.synth_batch(tcfg, RunShape("t", "train", 32, 2), 0))
    ts, m = step(ts, batch)
    before = TP.tree_map(torch.clone, ts, is_leaf=torch.is_tensor)
    if tcfg.embeds_input:
        poisoned = {k: v * float("nan") if v.is_floating_point() else v
                    for k, v in batch.items()}
        ts, m = step(ts, poisoned)
    else:
        ts, m = step(ts, batch, poison=True)
    assert not bool(m["good"]) and not np.isfinite(float(m["loss"]))
    assert same_tree(ts, before)
    if tcfg.embeds_input:      # the reference's guard, on the same batches
        jcfg = j_smoke(arch).replace(compute_dtype="float32")
        jstep = JS.make_train_step(jcfg, JM.make_layout(jcfg, 1))
        js, _ = jstep(jax.tree.map(jnp.asarray, j_state(arch)),
                      {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        js2, jm = jstep(js, {k: jnp.asarray(v.numpy())
                             for k, v in poisoned.items()})
        assert not bool(jm["good"])
        assert all(np.array_equal(a, b) for a, b in zip(j_leaves(js2),
                                                        j_leaves(js)))


# ---------------------------------------------------------------------------
# remat and grouped stacks
# ---------------------------------------------------------------------------


def _grads(cfg, params, batch):
    loss, _, g = TS.loss_and_grads(params, batch, cfg, TM.make_layout(cfg, 1))
    return loss, g


REMAT_CASES = [
    (ARCH, dict(n_layers=4), dict(remat="full")),
    (ARCH, dict(n_layers=4), dict(remat="dots")),
    (ARCH, dict(n_layers=4), dict(remat="full", scan_group=2)),
    (ARCH, dict(n_layers=4), dict(remat="none", scan_group=2)),
    (ARCH, dict(n_layers=4), dict(remat="dots", scan_group=2)),
    ("recurrentgemma-9b", dict(n_layers=7), dict(remat="full",
                                                 scan_group=1)),
    ("recurrentgemma-9b", dict(n_layers=7), dict(remat="none",
                                                 scan_group=1)),
    ("falcon-mamba-7b", dict(n_layers=4), dict(remat="dots", scan_group=2)),
    ("arctic-480b", dict(), dict(remat="dots")),
]


@pytest.mark.parametrize("arch,depth,kw", REMAT_CASES)
def test_remat_and_groups_bitwise_equal_flat(arch, depth, kw):
    """Recompute runs the same operations on the same inputs: loss and
    every gradient == the flat, un-remat'd run's, bitwise."""
    _, cfg = f32_cfgs(arch, **depth)
    params = TP.init_params(TM.param_specs(cfg, TM.make_layout(cfg, 1)),
                            torch.Generator().manual_seed(0))
    batch = to_t(tokens_batch(cfg.vocab_size))
    flat = _grads(cfg.replace(remat="none", scan_group=0), params, batch)
    got = _grads(cfg.replace(**kw), params, batch)
    assert torch.equal(flat[0], got[0]) and same_tree(flat[1], got[1])
    spans = TM._group_spans(cfg.replace(**kw), TM.layer_kinds(cfg))
    if kw.get("scan_group"):
        assert spans is not None        # the grouped path ran


@pytest.mark.parametrize("arch,depth,kw", [
    (ARCH, dict(n_layers=4), dict(scan_group=2)),
    ("recurrentgemma-9b", dict(n_layers=7), dict(scan_group=1))])
def test_grouped_stacks_equal_reference(arch, depth, kw):
    """The reference's `test_scan_group_matches_flat_scan` across the two
    packages: the grouped run's loss within 1e-5 and gradients within 1e-3
    of each leaf's largest of the reference's grouped run."""
    jcfg, tcfg = f32_cfgs(arch, **depth, **kw)
    lo = JM.make_layout(jcfg, 1)
    p = np_tree(JP.init_params(JM.param_specs(jcfg, lo),
                               jax.random.PRNGKey(0)))
    batch = tokens_batch(jcfg.vocab_size, seed=2)
    (jl, _), jg = jax.value_and_grad(
        lambda pp: JM.loss_fn(pp, jax.tree.map(jnp.asarray, batch), jcfg, lo),
        has_aux=True)(p)
    tl, tg = _grads(tcfg, params_from_numpy(p, device="cpu"), to_t(batch))
    assert abs(float(tl) - float(jl)) < 1e-5 * max(1.0, abs(float(jl)))
    for got, want in zip(t_leaves(tg), j_leaves(TS.split_layers(np_tree(jg)))):
        assert np.max(np.abs(got.numpy() - want)) <= 1e-3 * max(
            np.max(np.abs(want)), 1e-30)


def test_pattern_period_and_spans():
    assert TM._pattern_period(("rec", "rec", "attn_mlp") * 2) == 3
    assert TM._pattern_period(("a", "b", "c")) == 0
    cfg = get_smoke_config("recurrentgemma-9b").replace(n_layers=7,
                                                        scan_group=1)
    assert TM._group_spans(cfg, TM.layer_kinds(cfg)) == (3, "full", "none")
    assert TM._group_spans(cfg.replace(remat="none"),
                           TM.layer_kinds(cfg)) == (3, "none", "none")
    assert TM._group_spans(cfg.replace(n_layers=5), TM.layer_kinds(
        cfg.replace(n_layers=5))) is None
    dense = get_smoke_config(ARCH).replace(n_layers=4, scan_group=4)
    assert TM._group_spans(dense, TM.layer_kinds(dense)) is None


def test_split_layers_views_share_storage():
    cfg = get_smoke_config("whisper-large-v3")
    params = TP.init_params(TM.param_specs(cfg, TM.make_layout(cfg, 1)),
                            torch.Generator().manual_seed(0))
    split = TS.split_layers(params)
    assert len(split["enc_layers"]) == cfg.encdec.enc_layers
    assert len(split["dec_layers"]) == cfg.encdec.dec_layers
    w = split["dec_layers"][1]["mlp"]["wi"]
    assert w.data_ptr() == params["dec_layers"]["mlp"]["wi"][1].data_ptr()
    hybrid = get_smoke_config("recurrentgemma-9b")
    hp = TP.init_params(TM.param_specs(hybrid, TM.make_layout(hybrid, 1)),
                        torch.Generator().manual_seed(0))
    assert TS.split_layers(hp)["layers"] is hp["layers"]


# ---------------------------------------------------------------------------
# data, mesh, FLOPs, state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-32b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "arctic-480b",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_synth_batch_bitwise_equals_reference(arch):
    for step, seed in ((0, 1234), (17, 5), (18, 5)):
        want = JD.synth_batch(j_smoke(arch), JRunShape("t", "train", 32, 4),
                              step, seed)
        got = TD.synth_batch(get_smoke_config(arch),
                             RunShape("t", "train", 32, 4), step, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_prefetcher_yields_in_order_and_closes():
    made = []

    def make(s):
        made.append(s)
        return {"x": np.full((2,), s, np.int32)}

    pf = TD.Prefetcher(make, 3, depth=2)
    for want in (3, 4, 5):
        s, b = next(pf)
        assert s == want and b["x"].tolist() == [want, want]
    pf.close()                     # the queue may be full: close must return
    assert not pf._thread.is_alive()


def test_prefetcher_passes_errors_to_the_caller():
    def make(s):
        if s == 1:
            raise ValueError("bad shard")
        return {"x": np.zeros(1)}

    pf = TD.Prefetcher(make, 0)
    next(pf)
    with pytest.raises(ValueError, match="bad shard"):
        next(pf)
    pf.close()


def test_host_mesh_and_tp_degree():
    mesh = TMESH.make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert TMESH.tp_degree(mesh) == 1
    assert TMESH.make_host_mesh().devices == (torch.device("cuda", 0),)
    # tensor parallelism needs one rank a card: a process group first
    with pytest.raises(ValueError, match="process group"):
        TMESH.make_host_mesh(model=4, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-32b", "arctic-480b",
                                  "whisper-large-v3"])
def test_model_flops_equals_reference(arch):
    from repro.config import SHAPES as JSHAPES
    from repro.configs import get_config as j_get
    for name in SHAPES:
        assert TR.model_flops(get_config(arch), SHAPES[name]) == \
            JR.model_flops(j_get(arch), JSHAPES[name])


def test_state_from_numpy_and_specs():
    state = j_state()
    ts = state_from_numpy(state, device="cpu")
    assert ts["opt"]["step"].dtype == torch.int32
    for got, want in zip(t_leaves(ts), j_leaves(state)):
        assert np.array_equal(got.numpy(), want)
    cfg = get_smoke_config(ARCH)
    specs = TS.state_specs(cfg, TM.make_layout(cfg, 1))
    init = TS.init_state(cfg, TM.make_layout(cfg, 1),
                         torch.Generator().manual_seed(0))
    assert [tuple(s.shape) for s in TP.tree_leaves(specs["params"])] == \
        [tuple(t.shape) for t in t_leaves(init["params"])]
    assert init["opt"]["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# relayout and the model half of the checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-32b", "qwen2.5-14b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("tp", [1, 4])
def test_relayout_equals_reference(arch, tp):
    jc, tc = j_smoke(arch), get_smoke_config(arch)
    p1 = np_tree(JP.init_params(JM.param_specs(jc, JM.make_layout(jc, 1)),
                                jax.random.PRNGKey(0)))
    want = np_tree(JRL.relayout(jax.tree.map(jnp.asarray, p1), jc,
                                JM.make_layout(jc, 1), JM.make_layout(jc, tp)))
    src, dst = TM.make_layout(tc, 1), TM.make_layout(tc, tp)
    got_t = TRL.relayout(params_from_numpy(p1, device="cpu"), tc, src, dst)
    got_np = TRL.relayout(p1, tc, src, dst)
    for a, b, w in zip(t_leaves(got_t), TP.tree_leaves(
            got_np, is_leaf=lambda x: isinstance(x, np.ndarray)),
            j_leaves(want)):
        assert np.array_equal(a.numpy(), w) and np.array_equal(b, w)
    back = TRL.to_logical(got_t, tc, dst)
    assert same_tree(back, params_from_numpy(p1, device="cpu"))


def test_elastic_restore_across_tp(tmp_path):
    """Saved under tp=1 by the port, restored under tp=4: the loss is the
    same (the reference's `test_elastic_restore_across_tp`)."""
    _, cfg = f32_cfgs()
    lo1, lo4 = TM.make_layout(cfg, 1), TM.make_layout(cfg, 4)
    state1 = state_from_numpy(j_state(), device="cpu")
    TC.save(tmp_path, state1, 1, cfg=cfg, layout=lo1)
    like4 = TP.abstract_params(TS.state_specs(cfg, lo4))
    state4, _ = TC.restore(tmp_path, like4, cfg=cfg, layout=lo4)
    batch = to_t(tokens_batch(cfg.vocab_size))
    with torch.no_grad():
        l1, _ = TM.loss_fn(state1["params"], batch, cfg, lo1)
        l4, _ = TM.loss_fn(params_from_numpy(state4["params"], device="cpu"),
                           batch, cfg, lo4)
    assert abs(float(l1) - float(l4)) < 1e-5


@pytest.mark.parametrize("tp", [1, 4])
def test_model_checkpoints_cross_packages_bitwise(tmp_path, tp):
    """A train state saved by either package with cfg= and layout= is
    restored by the other, leaf for leaf and bit for bit."""
    jc, tc = j_smoke(ARCH), get_smoke_config(ARCH)
    jlo, tlo = JM.make_layout(jc, tp), TM.make_layout(tc, tp)
    jstate = np_tree(JS.init_state(jc, jlo, jax.random.PRNGKey(0)))
    JC.save(tmp_path / "j", jstate, 3, cfg=jc, layout=jlo)
    like = TP.abstract_params(TS.state_specs(tc, tlo))
    got, step = TC.restore(tmp_path / "j", like, cfg=tc, layout=tlo)
    assert step == 3
    want = JC.restore(tmp_path / "j", jstate, cfg=jc, layout=jlo)[0]
    for a, b in zip(TP.tree_leaves(got, is_leaf=lambda x: isinstance(
            x, np.ndarray)), j_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tstate = state_from_numpy(jstate, device="cpu")
    TC.save(tmp_path / "t", tstate, 4, cfg=tc, layout=tlo)
    back, _ = JC.restore(tmp_path / "t", jstate, cfg=jc, layout=jlo)
    for a, b in zip(j_leaves(back), j_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the train loop and the CLIs
# ---------------------------------------------------------------------------


def test_resume_equals_uninterrupted(tmp_path):
    """6 steps straight == 3 steps, a 'crash', a resume to 6, bitwise: the
    losses and the final state (the reference's test holds 2e-4)."""
    cfg = get_smoke_config(ARCH).replace(n_layers=4, scan_group=2)
    opt = TO.OptConfig(peak_lr=1e-3, warmup_steps=0, total_steps=6)
    kw = dict(batch=2, seq=32, opt=opt, log_every=0, seed=99, device="cpu")
    full, hist_full, _ = train_loop(cfg, steps=6, **kw)
    d = tmp_path / "ck"
    _, h1, _ = train_loop(cfg, steps=3, ckpt_dir=d, ckpt_every=2, **kw)
    assert TC.latest_step(d) == 3
    resumed, h2, _ = train_loop(cfg, steps=6, ckpt_dir=d, ckpt_every=2, **kw)
    assert hist_full == h1 + h2
    assert same_tree(full, resumed)
    assert TC.latest_step(d) == 6


def test_train_loop_skips_poisoned_steps():
    """The reference's `test_nan_guard_skips_poisoned_step` (vlm: float
    inputs), and a token model (its loss poisoned)."""
    for arch in ("qwen2-vl-72b", ARCH):
        cfg = get_smoke_config(arch)
        opt = TO.OptConfig(peak_lr=1e-3, warmup_steps=0, total_steps=5)
        state, hist, info = train_loop(cfg, steps=5, batch=2, seq=32,
                                       opt=opt, log_every=0,
                                       inject_nan_at=2, device="cpu")
        assert info["skipped"] == 1 and len(hist) == 4
        assert len(info["step_s"]) == 5
        assert all(np.isfinite(h) for h in hist)
        assert all(bool(torch.isfinite(t).all()) for t in t_leaves(state))


def test_train_loop_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(get_smoke_config(ARCH), steps=1, batch=2, seq=8)


def test_train_cli_smoke_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "12", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "5"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] done: first loss") and \
        "(0 skipped)" in last
    losses = last.split("first loss ")[1].split(" (")[0]
    first, final = (float(x) for x in losses.split(" -> last "))
    assert final < first
    assert TC.latest_step(tmp_path) == 12


def test_prefill_and_serve_steps_equal_the_model():
    """`make_prefill_step` is the prefill's last logits and caches;
    `make_serve_step` one `decode_step`; both run without autograd."""
    from repro_torch.serving.engine import prefill_to_decode_cache
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    layout = TM.make_layout(cfg, 1)
    params = TP.init_params(TM.param_specs(cfg, layout),
                            torch.Generator().manual_seed(0))
    toks = torch.as_tensor(tokens_batch(cfg.vocab_size, B=1, S=8)["inputs"])
    last, caches = TS.make_prefill_step(cfg, layout)(params,
                                                    {"inputs": toks})
    with torch.no_grad():
        logits, _, want = TM.forward(params, {"inputs": toks}, cfg, layout,
                                     mode="prefill")
    assert torch.equal(last, logits[:, -1]) and not last.requires_grad
    assert all(torch.equal(a, b) for a, b in zip(t_leaves(caches),
                                                  t_leaves(want)))
    dec = prefill_to_decode_cache(cfg, caches, 1, 16)
    ref = prefill_to_decode_cache(cfg, want, 1, 16)
    batch = {"token": torch.tensor([3]), "pos": torch.tensor([8])}
    got, _ = TS.make_serve_step(cfg, layout)(params, dec, batch)
    with torch.no_grad():
        exp, _ = TM.decode_step(params, ref, batch, cfg, layout)
    assert torch.equal(got, exp)
