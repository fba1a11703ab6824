"""The port's sharded train and prefill steps (`training.step` under a
`DeviceMesh`) on gloo ranks, on the CPU, against the single-process step
on the same params (the reference's smoke weights for the dense and MoE
steps and the tp = 2 prefill, carried into the port and through
`relayout.from_logical` to the tp-2 layout; the port's own draws where
the port's single-process path is the reference).

  * (data, model) = (1, 1): one train step of the qwen3-32b and
    arctic-480b smoke configs in their own dtypes (bf16 compute), loss,
    gradient norm and the whole new state bitwise; the other families
    (ssm, hybrid, encdec, vlm) prefill bitwise, and the ssm train step.
  * (2, 1), (1, 2) and (2, 2): the same train steps in f32 compute, loss
    and gradient norm within TOL_REL_F32 relative, each new param leaf
    within TOL_REL_F32 of its largest |value| (the order of the sums over
    the shards differs; AdamW's ratio amplifies none of it at step 1).
  * one decode step at (1, 1) of the dense, ssm and hybrid smoke configs
    from a prefill's caches, bitwise (`make_serve_step`).
  * tp = 2 prefill (`pallas`: K8's plain version on each rank's own kv
    groups) against the JAX forward on the tp-2 layout in f32: logits
    within F32_LOGIT_TOL, caches within F32_CACHE_REL of their largest
    |value|, the tolerances of `tests/test_torch_model.py`; the ssm
    family's tp = 2 prefill (K9 on each rank's d_inner channels) against
    the port's single-process one within the same bounds.

All worlds start together in a module fixture (10 interpreters, one
thread each) while this process computes the single-process references.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import collect_ranks, start_ranks

from repro import pspec as JP
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro_torch import pspec as TP
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models import relayout as TRL
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import prefill_to_decode_cache
from repro_torch.training import optimizer as TO
from repro_torch.training import step as TS

TOL_REL_F32 = 2e-5           # the reference's TOL_REL["float32"]
F32_LOGIT_TOL = 1e-4
F32_CACHE_REL = 2e-5
TRAIN_ARCHS = ("qwen3-32b", "arctic-480b")
FAMILIES = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-large-v3",
            "qwen2-vl-72b")
MESHES = ((2, 1), (1, 2), (2, 2))
DECODE_ARCHS = ("qwen3-32b", "falcon-mamba-7b", "recurrentgemma-9b")
B, S = 4, 16
MAX_LEN = 24


def case_cfg(arch: str, f32: bool, **kw):
    c = get_smoke_config(arch).replace(**kw)
    return c.replace(compute_dtype="float32") if f32 else c


@functools.lru_cache(maxsize=None)
def jax_smoke_weights(arch: str):
    """The reference's smoke weights (seed 0, its init under one jit) as
    numpy arrays."""
    cfg = j_smoke(arch)
    specs = JM.param_specs(cfg, JM.make_layout(cfg, 1))
    p = jax.jit(lambda key: JP.init_params(specs, key))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def drawn_params(arch: str):
    """Smoke weights drawn by the port (the cases held to the port's own
    single-process path need no JAX weights)."""
    cfg = get_smoke_config(arch)
    return TP.init_params(TM.param_specs(cfg, TM.make_layout(cfg, 1)),
                          torch.Generator().manual_seed(0), "cpu")


def smoke_params(arch: str, tp: int):
    """The reference's smoke weights, in the port, on the tp layout."""
    p = params_from_numpy(jax_smoke_weights(arch), device="cpu")
    tc = get_smoke_config(arch)
    return p if tp == 1 else TRL.from_logical(p, tc, TM.make_layout(tc, tp))


def batch_of(cfg, train: bool, seed: int = 3):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    if cfg.family == "encdec":
        b = {"enc_embeds": torch.as_tensor(rng.normal(size=(B, S, cfg.d_model)),
                                           dtype=torch.float32),
             "dec_inputs": toks[:, :8]}
        tgt = toks[:, 1:9]
    elif cfg.embeds_input:
        b = {"embeds": torch.as_tensor(rng.normal(size=(B, S, cfg.d_model)),
                                       dtype=torch.float32)}
        tgt = toks[:, 1:]
    else:
        b = {"inputs": toks[:, :-1]}
        tgt = toks[:, 1:]
    if train:
        b["targets"] = tgt
    return b


RANKS = """
    from repro_torch import pspec as TP
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.training import step as TS
    data, model = (int(v) for v in os.environ["MESH"].split(","))
    B_DEC, MAX_LEN = (int(v) for v in os.environ["DECODE"].split(","))
    mesh = make_host_mesh(model=model, device="cpu")
    OUT["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names)
    rules = make_rules(multi_pod=False)
    cases = torch.load(os.environ["CASES"], weights_only=False)
    for name, case in cases.items():
        if case["mesh"] != (data, model):
            continue
        cfg, lo = case["cfg"], case["layout"]
        if case["kind"] == "train":
            state = TS.place_state(case["state"], cfg, lo, rules, mesh)
            step = TS.make_train_step(cfg, lo, rules, mesh)
            state, m = step(state, case["batch"])
            OUT[name] = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                         "good": m["good"],
                         "state": TP.gather_tree(state)}
        elif case["kind"] == "decode":
            params = TP.place_tree(case["params"],
                                   TM.param_specs(cfg, lo), rules, mesh)
            caches = TP.place_tree(case["caches"], TM.cache_specs(
                cfg, lo, B_DEC, MAX_LEN), rules, mesh)
            step = TS.make_serve_step(cfg, lo, rules, mesh)
            logits, caches = step(params, caches, case["batch"])
            OUT[name] = {"logits": TP.gather_tree(logits),
                         "caches": TP.gather_tree(caches)}
        else:
            params = TP.place_tree(case["params"],
                                   TM.param_specs(cfg, lo), rules, mesh)
            step = TS.make_prefill_step(cfg, lo, rules, mesh)
            logits, caches = step(params, case["batch"])
            OUT[name] = {"logits": TP.gather_tree(logits),
                         "caches": TP.gather_tree(caches)}
"""


def cases():
    """{name: case}: each world's work (the mesh it runs on, the config,
    the layout and its inputs)."""
    out = {}
    for arch in TRAIN_ARCHS:
        for mesh in ((1, 1),) + MESHES:
            f32 = mesh != (1, 1)
            cfg = case_cfg(arch, f32)
            lo = TM.make_layout(cfg, mesh[1])
            p = smoke_params(arch, mesh[1])
            out[f"train/{arch}/{mesh}"] = dict(
                kind="train", mesh=mesh, cfg=cfg, layout=lo,
                state={"params": p, "opt": TO.init_opt_state(
                    p, cfg.opt_dtype)},
                batch=batch_of(cfg, True))
    for arch, p in (("qwen3-32b", smoke_params("qwen3-32b", 2)),
                    ("falcon-mamba-7b", drawn_params("falcon-mamba-7b"))):
        cfg = case_cfg(arch, True, attention_impl="pallas")
        out[f"prefill/{arch}/(1, 2)"] = dict(
            kind="prefill", mesh=(1, 2), cfg=cfg,
            layout=TM.make_layout(cfg, 2), params=p,
            batch=batch_of(cfg, False))
    for arch in FAMILIES:
        cfg = case_cfg(arch, False, attention_impl="pallas")
        out[f"prefill/{arch}/(1, 1)"] = dict(
            kind="prefill", mesh=(1, 1), cfg=cfg,
            layout=TM.make_layout(cfg, 1), params=drawn_params(arch),
            batch=batch_of(cfg, False))
    for arch in DECODE_ARCHS:
        cfg = case_cfg(arch, False)
        lo = TM.make_layout(cfg, 1)
        p = drawn_params(arch)
        _, caches = TS.make_prefill_step(cfg, lo)(p, batch_of(cfg, False))
        out[f"decode/{arch}/(1, 1)"] = dict(
            kind="decode", mesh=(1, 1), cfg=cfg, layout=lo, params=p,
            caches=prefill_to_decode_cache(cfg, caches, S, MAX_LEN),
            batch={"token": torch.arange(B) % cfg.vocab_size,
                   "pos": torch.full((B,), S)})
    cfg = case_cfg("falcon-mamba-7b", False)
    p = drawn_params("falcon-mamba-7b")
    out["train/falcon-mamba-7b/(1, 1)"] = dict(
        kind="train", mesh=(1, 1), cfg=cfg, layout=TM.make_layout(cfg, 1),
        state={"params": p, "opt": TO.init_opt_state(p, cfg.opt_dtype)},
        batch=batch_of(cfg, True))
    return out


def plain(case):
    """The single-process step on the same inputs."""
    cfg, lo = case["cfg"], case["layout"]
    if case["kind"] == "train":
        state = TP.tree_map(lambda t: t.clone(), case["state"],
                            is_leaf=torch.is_tensor)
        state, m = TS.make_train_step(cfg, lo)(state, case["batch"])
        return {"loss": m["loss"], "grad_norm": m["grad_norm"],
                "good": m["good"], "state": state}
    if case["kind"] == "decode":
        caches = TP.tree_map(lambda t: t.clone(), case["caches"],
                             is_leaf=torch.is_tensor)
        logits, caches = TS.make_serve_step(cfg, lo)(case["params"], caches,
                                                     case["batch"])
        return {"logits": logits, "caches": caches}
    logits, caches = TS.make_prefill_step(cfg, lo)(case["params"],
                                                   case["batch"])
    return {"logits": logits, "caches": caches}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases, {name: [each rank's result]}, {name: plain result})."""
    tmp = tmp_path_factory.mktemp("sharded")
    cs = cases()
    # two world-1 interpreters share the (1, 1) cases: the dense and MoE
    # train steps ("a"), and the rest ("b")
    one = {k: v for k, v in cs.items() if v["mesh"] == (1, 1)}
    a = {k: v for k, v in one.items() if k.startswith("train/")
         and k.split("/")[1] in TRAIN_ARCHS}
    torch.save(a, tmp / "cases_a.pt")
    torch.save({k: v for k, v in one.items() if k not in a},
               tmp / "cases_b.pt")
    torch.save({k: v for k, v in cs.items() if k not in one},
               tmp / "cases_n.pt")
    handles = [start_ranks(RANKS, d * m, tmp, f"m{d}{m}{part}",
                           env={"MESH": f"{d},{m}",
                                "DECODE": f"{B},{MAX_LEN}",
                                "CASES": str(tmp / f"cases_{part}.pt")})
               for (d, m), part in (((1, 1), "a"), ((1, 1), "b"),
                                    ((2, 1), "n"), ((1, 2), "n"),
                                    ((2, 2), "n"))]
    want = {k: plain(c) for k, c in cs.items()}
    got = {}
    for h in handles:
        outs = collect_ranks(h, timeout=600)
        for o in outs:
            for k, v in o.items():
                got.setdefault(k, []).append(v)
    return cs, got, want


def leaves(tree):
    return TP.tree_leaves(tree, is_leaf=torch.is_tensor)


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def test_host_meshes_spread_the_world(runs):
    _, got, _ = runs
    assert sorted(set(got["mesh"])) == sorted(
        ((d, m), ("data", "model")) for d, m in ((1, 1),) + MESHES)


@pytest.mark.parametrize("arch", TRAIN_ARCHS + ("falcon-mamba-7b",))
def test_train_step_one_card_mesh_is_bitwise(runs, arch):
    _, got, want = runs
    w = want[f"train/{arch}/(1, 1)"]
    (g,) = got[f"train/{arch}/(1, 1)"]
    for key in ("loss", "grad_norm", "good"):
        assert torch.equal(g[key], w[key]), key
    for a, b in zip(leaves(g["state"]), leaves(w["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_sharded_within_f32(runs, arch, mesh):
    _, got, want = runs
    w = want[f"train/{arch}/{mesh}"]
    ranks = got[f"train/{arch}/{mesh}"]
    assert len(ranks) == mesh[0] * mesh[1]
    assert bool(w["good"])
    for g in ranks:
        assert bool(g["good"])
        for key in ("loss", "grad_norm"):
            assert abs(float(g[key]) - float(w[key])) <= \
                TOL_REL_F32 * abs(float(w[key])), (key, g[key], w[key])
        for a, b in zip(leaves(g["state"]["params"]),
                        leaves(w["state"]["params"])):
            assert rel(a, b) <= TOL_REL_F32
        assert int(g["state"]["opt"]["step"]) == 1
    # every rank ends on the same state
    for g in ranks[1:]:
        for a, b in zip(leaves(g["state"]), leaves(ranks[0]["state"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_one_card_mesh_is_bitwise(runs, arch):
    _, got, want = runs
    w = want[f"prefill/{arch}/(1, 1)"]
    (g,) = got[f"prefill/{arch}/(1, 1)"]
    assert torch.equal(g["logits"], w["logits"])
    assert len(leaves(g["caches"])) == len(leaves(w["caches"]))
    for a, b in zip(leaves(g["caches"]), leaves(w["caches"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_one_card_mesh_is_bitwise(runs, arch):
    """One decode step from a prefill's caches (attention's linear cache,
    mamba's conv and state, the hybrid's ring and recurrent state),
    written in place on DTensors."""
    _, got, want = runs
    w = want[f"decode/{arch}/(1, 1)"]
    (g,) = got[f"decode/{arch}/(1, 1)"]
    assert torch.equal(g["logits"], w["logits"])
    for a, b in zip(leaves(g["caches"]), leaves(w["caches"])):
        assert torch.equal(a, b)


def test_tp2_prefill_equals_reference_forward(runs):
    """K8's route on each rank's 1 of 2 kv groups: the last position's
    logits and the caches against the JAX forward on the tp-2 layout."""
    cs, got, _ = runs
    case = cs["prefill/qwen3-32b/(1, 2)"]
    jc = j_smoke("qwen3-32b").replace(compute_dtype="float32")
    jlo = JM.make_layout(jc, 2)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), case["params"],
                      is_leaf=torch.is_tensor)
    jl, _, jk = JM.forward(jp, {"inputs": jnp.asarray(
        case["batch"]["inputs"].numpy())}, jc, jlo, mode="prefill")
    jl = np.asarray(jl)[:, -1]
    for g in got["prefill/qwen3-32b/(1, 2)"]:
        assert float(np.abs(g["logits"].numpy() - jl).max()) < F32_LOGIT_TOL
        for name in ("k", "v"):
            want = np.asarray(jk[name])
            assert g["caches"][name].shape == want.shape
            assert float(np.abs(g["caches"][name].numpy() - want).max()) <= \
                F32_CACHE_REL * max(1.0, float(np.abs(want).max()))


def test_tp2_ssm_prefill_equals_single_process(runs):
    """K9's route on each rank's half of d_inner, against the port's
    single-process prefill (f32)."""
    _, got, want = runs
    w = want["prefill/falcon-mamba-7b/(1, 2)"]
    for g in got["prefill/falcon-mamba-7b/(1, 2)"]:
        assert float((g["logits"] - w["logits"]).abs().max()) < \
            F32_LOGIT_TOL
        for a, b in zip(leaves(g["caches"]), leaves(w["caches"])):
            assert float((a - b).abs().max()) <= F32_CACHE_REL * max(
                1.0, float(b.abs().max()))
