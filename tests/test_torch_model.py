"""The port's dense model (configs, param specs, prefill, decode) against
the JAX package on the same weights and tokens.

Tolerances: in f32 compute the two frameworks differ by f32 rounding only
(prefill and decode logits within 1e-4 of logits of magnitude ~4, caches
within 2e-5 of their largest value). In bf16 compute the frameworks round
at the same points, but their sigmoid, exp, rsqrt, cos and sin differ by
an ulp here and there, and the smoke init (stacked weights of std
1/sqrt(2)) grows those to 1-5 % of the largest logit over two layers; so
bf16 is held within 10 % of the largest reference value, and the port's
bf16 error against the reference's f32 result within 1.25x the
reference's own."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JCFG
from repro import pspec as JP
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import model as JM
from repro.serving.engine import prefill_to_decode_cache as j_p2d
from repro_torch import config as TCFG
from repro_torch import pspec as TP
from repro_torch.configs import ARCH_IDS, canonical, get_config, \
    get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serving.engine import prefill_to_decode_cache as t_p2d

DENSE = ["qwen2.5-14b", "qwen3-32b", "nemotron-4-15b", "nemotron-4-340b"]
SSM = "falcon-mamba-7b"
F32_LOGIT_TOL = 1e-4
F32_CACHE_REL = 2e-5
BF16_REL = 0.1
BF16_VS_F32_FACTOR = 1.25


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def err(a, b) -> float:
    return float(np.max(np.abs(f32(a) - f32(b))))


def flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k2: v for k in tree
                for k2, v in flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in flat(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def smoke_weights(arch: str):
    """The reference's smoke weights (seed 0) as numpy arrays."""
    cfg = j_get_smoke(arch)
    params = JP.init_params(JM.param_specs(cfg, JM.make_layout(cfg, 1)),
                            jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def both(arch, **knobs):
    """(jax cfg, layout, params), (port cfg, layout, params) on the same
    weights."""
    jc = j_get_smoke(arch).replace(**knobs)
    tc = get_smoke_config(arch).replace(**knobs)
    npw = smoke_weights(arch)
    return ((jc, JM.make_layout(jc, 1), jax.tree.map(jnp.asarray, npw)),
            (tc, TM.make_layout(tc, 1),
             params_from_numpy(npw, device="cpu")))


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert canonical("qwen2.5-14b") == "qwen2_5_14b"
    with pytest.raises(KeyError):
        canonical("no-such-arch")
    for s in JCFG.ALL_SHAPES:
        assert dataclasses.asdict(TCFG.SHAPES[s.name]) == \
            dataclasses.asdict(s)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference_field_by_field(arch):
    for mine, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.d_inner == ref.d_inner
        assert mine.sub_quadratic == ref.sub_quadratic
    r = get_config(arch).replace(n_layers=3, compute_dtype="float32")
    assert dataclasses.asdict(r) == dataclasses.asdict(
        j_get_config(arch).replace(n_layers=3, compute_dtype="float32"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference_at_full_width(arch):
    tc, jc = get_config(arch), j_get_config(arch)
    tspecs = TM.param_specs(tc, TM.make_layout(tc, 1))
    jspecs = JM.param_specs(jc, JM.make_layout(jc, 1))
    mine, ref = flat(tspecs), flat(jspecs)
    assert mine.keys() == ref.keys()
    for path, s in mine.items():
        r = ref[path]
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == \
            (r.shape, r.axes, r.dtype, r.init, r.scale), path
    abstract = flat(TP.abstract_params(tspecs))
    jabs = flat(JP.abstract_params(jspecs))
    for path, a in abstract.items():
        assert a.device.type == "meta"
        assert tuple(a.shape) == jabs[path].shape
        assert str(a.dtype).replace("torch.", "") == str(jabs[path].dtype)
    assert TP.count_params(tspecs) == JP.count_params(jspecs)
    cache_t = flat(TM.cache_specs(tc, TM.make_layout(tc, 1), 4, 128))
    cache_j = flat(JM.cache_specs(jc, JM.make_layout(jc, 1), 4, 128))
    assert {k: (v.shape, v.dtype) for k, v in cache_t.items()} == \
        {k: (v.shape, v.dtype) for k, v in cache_j.items()}


def test_qwen2_5_14b_has_14_77e9_parameters():
    cfg = get_config("qwen2.5-14b")
    assert TP.count_params(TM.param_specs(cfg, TM.make_layout(cfg, 1))) \
        == 14_770_033_664


def test_falcon_mamba_7b_has_7_006e9_parameters():
    cfg = get_config(SSM)
    assert TP.count_params(TM.param_specs(cfg, TM.make_layout(cfg, 1))) \
        == 7_006_326_784


def test_init_rules_on_the_device():
    """The reference's rules, drawn in f32 then cast: ones, zeros, embed
    (std 0.02), fan_in over the first (stacked: layer) axis."""
    cfg = get_smoke_config("qwen2.5-14b").replace(n_layers=8, d_ff=4096)
    gen = torch.Generator().manual_seed(0)
    p = TP.init_params(TM.param_specs(cfg, TM.make_layout(cfg, 1)), gen)
    assert torch.equal(p["final_norm"]["w"], torch.ones(cfg.d_model))
    assert not p["layers"]["attn"]["bq"].any()
    assert abs(p["tok_embed"].std().item() - 0.02) < 0.002
    assert abs(p["layers"]["mlp"]["wi"].std().item() - 8 ** -0.5) < 0.01
    assert abs(p["lm_head"].std().item() - cfg.d_model ** -0.5) < 0.01
    again = TP.init_params(TM.param_specs(cfg, TM.make_layout(cfg, 1)),
                           torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        TP.tree_leaves(p, is_leaf=torch.is_tensor),
        TP.tree_leaves(again, is_leaf=torch.is_tensor)))
    bf = TP.init_params(
        TM.param_specs(cfg.replace(param_dtype="bfloat16"),
                       TM.make_layout(cfg, 1)),
        torch.Generator().manual_seed(0))
    assert bf["lm_head"].dtype == torch.bfloat16


def test_params_from_numpy_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.random.default_rng(0).normal(size=(5, 7)),
                               jnp.bfloat16))
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          a.view(np.int16))


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------


def prefill_decode(jx, tx, toks):
    """Prefill toks[:, :-1], decode toks[:, -1] in both packages."""
    (jc, jlo, jp), (tc, tlo, tp) = jx, tx
    B, S = toks.shape
    jl, _, jk = JM.forward(jp, {"inputs": jnp.asarray(toks[:, :-1])}, jc,
                           jlo, mode="prefill")
    tl, _, tk = TM.forward(tp, {"inputs": torch.as_tensor(toks[:, :-1])},
                           tc, tlo, mode="prefill")
    jd, _ = JM.decode_step(jp, j_p2d(jc, jk, S - 1, S + 4),
                           {"token": jnp.asarray(toks[:, -1]),
                            "pos": jnp.full((B,), S - 1, jnp.int32)}, jc, jlo)
    td, _ = TM.decode_step(tp, t_p2d(tc, tk, S - 1, S + 4),
                           {"token": torch.as_tensor(toks[:, -1]),
                            "pos": torch.full((B,), S - 1)}, tc, tlo)
    return (jl, jk, jd), (tl, tk, td)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_equal_reference_f32(arch, impl):
    jx, tx = both(arch, compute_dtype="float32", attention_impl=impl)
    (jl, jk, jd), (tl, tk, td) = prefill_decode(jx, tx,
                                                tokens(jx[0], (2, 32)))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert err(tl, jl) < F32_LOGIT_TOL
    assert err(td, jd) < F32_LOGIT_TOL
    for name in ("k", "v"):
        assert tk[name].shape == jk[name].shape
        assert err(tk[name], jk[name]) < F32_CACHE_REL * max(
            1.0, float(np.abs(f32(jk[name])).max()))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_equal_reference_bf16(arch):
    jx, tx = both(arch, attention_impl="pallas")
    toks = tokens(jx[0], (2, 32))
    (jl, jk, jd), (tl, tk, td) = prefill_decode(jx, tx, toks)
    jx32 = (jx[0].replace(compute_dtype="float32"),) + jx[1:]
    jl32, _, jk32 = JM.forward(jx32[2], {"inputs": jnp.asarray(toks[:, :-1])},
                               jx32[0], jx32[1], mode="prefill")
    for mine, ref, ref32 in ((tl, jl, jl32), (tk["k"], jk["k"], jk32["k"]),
                             (tk["v"], jk["v"], jk32["v"])):
        assert mine.dtype == (torch.float32 if mine is tl
                              else torch.bfloat16)
        scale = float(np.abs(f32(ref)).max())
        assert err(mine, ref) <= BF16_REL * scale
        assert err(mine, ref32) <= BF16_VS_F32_FACTOR * err(ref, ref32)
    assert err(td, jd) <= BF16_REL * float(np.abs(f32(jd)).max())


# ---------------------------------------------------------------------------
# the port's own contracts (the reference's gates, re-run on the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_pallas_equals_chunked_in_f32(arch):
    """The reference's model gate (tests/test_ssm_kernel.py): within 1e-3."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         attn_chunk=32)
    params = params_from_numpy(smoke_weights(arch), device="cpu")
    layout = TM.make_layout(cfg, 1)
    batch = {"inputs": torch.as_tensor(tokens(cfg, (2, 64), seed=0))}
    fc, _, _ = TM.forward(params, batch, cfg, layout)
    fp, _, _ = TM.forward(params, batch,
                          cfg.replace(attention_impl="pallas"), layout)
    fd, _, _ = TM.forward(params, batch,
                          cfg.replace(attention_impl="dense"), layout)
    assert err(fc, fp) < 1e-3
    assert err(fc, fd) < 1e-3


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_plus_decode_equals_forward(arch, impl):
    """tests/test_decode_consistency.py on the port: the default (bf16)
    compute, within 1e-3."""
    cfg = get_smoke_config(arch).replace(attention_impl=impl)
    params = params_from_numpy(smoke_weights(arch), device="cpu")
    layout = TM.make_layout(cfg, 1)
    B, S = 2, 32
    toks = torch.as_tensor(tokens(cfg, (B, S)))
    full, _, _ = TM.forward(params, {"inputs": toks}, cfg, layout)
    _, _, caches = TM.forward(params, {"inputs": toks[:, :S - 1]}, cfg,
                              layout, mode="prefill")
    caches = t_p2d(cfg, caches, S - 1, S + 4)
    logits, _ = TM.decode_step(params, caches,
                               {"token": toks[:, S - 1],
                                "pos": torch.full((B,), S - 1)}, cfg, layout)
    assert float((logits - full[:, -1]).abs().max()) < 1e-3


def test_multi_token_decode_chain():
    """Decode 8 tokens one by one == slices of the full forward logits."""
    cfg = get_smoke_config("qwen3_32b")
    params = params_from_numpy(smoke_weights("qwen3_32b"), device="cpu")
    layout = TM.make_layout(cfg, 1)
    B, S, T = 2, 24, 8
    toks = torch.as_tensor(tokens(cfg, (B, S + T), seed=3))
    full, _, _ = TM.forward(params, {"inputs": toks}, cfg, layout)
    _, _, caches = TM.forward(params, {"inputs": toks[:, :S]}, cfg, layout,
                              mode="prefill")
    caches = t_p2d(cfg, caches, S, S + T + 2)
    errs = []
    for t in range(T):
        logits, caches = TM.decode_step(
            params, caches, {"token": toks[:, S + t],
                             "pos": torch.full((B,), S + t)}, cfg, layout)
        errs.append(float((logits - full[:, S + t]).abs().max()))
    assert max(errs) < 1e-3, errs


def test_train_mode_is_the_prefill_forward_without_caches():
    cfg = get_smoke_config("qwen2.5-14b")
    params = params_from_numpy(smoke_weights("qwen2.5-14b"), device="cpu")
    layout = TM.make_layout(cfg, 1)
    batch = {"inputs": torch.as_tensor(tokens(cfg, (2, 16)))}
    lt, aux, none = TM.forward(params, batch, cfg, layout)
    lp, _, caches = TM.forward(params, batch, cfg, layout, mode="prefill")
    assert none is None and float(aux) == 0.0 and torch.equal(lt, lp)
    assert caches["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                 cfg.head_dim)


def test_out_of_range_indices_raise_instead_of_clamping():
    cfg = get_smoke_config("qwen2.5-14b")
    params = params_from_numpy(smoke_weights("qwen2.5-14b"), device="cpu")
    layout = TM.make_layout(cfg, 1)
    with pytest.raises(ValueError, match="token ids"):
        TM.forward(params, {"inputs": torch.tensor([[1, cfg.vocab_size]])},
                   cfg, layout)
    caches = t_p2d(cfg, TM.forward(params, {"inputs": torch.tensor([[1, 2]])},
                                   cfg, layout, mode="prefill")[2], 2, 4)
    before = caches["k"].clone()
    for pos in (4, -1):
        with pytest.raises(ValueError, match="decode positions"):
            TM.decode_step(params, caches, {"token": torch.tensor([3]),
                                            "pos": torch.tensor([pos])},
                           cfg, layout)
    assert torch.equal(caches["k"], before)


@pytest.mark.parametrize("knob,value,slice_", [
    ("attention_impl", "flash", "G2"), ("attention_impl", "skip_core", "G2")])
def test_later_paths_raise_naming_their_slice(knob, value, slice_):
    """Both later paths now run. `skip_core`, ported with slice G2b, gives
    the reference's skip_core logits (within 2e-5 of the largest;
    `tests/test_torch_skip_core.py` holds every family). `flash`, ported
    with slice G2a: its f32 forward and gradients equal `chunked`'s
    (within 1e-5 and 1e-4 of each leaf's largest: the backward is the
    reference's hand-written one, not autograd's)."""
    cfg = get_smoke_config("qwen2.5-14b").replace(**{knob: value})
    params = params_from_numpy(smoke_weights("qwen2.5-14b"), device="cpu")
    layout = TM.make_layout(cfg, 1)
    if value != "flash":
        (jc, jlo, jp), (tc, tlo, tp) = both(
            "qwen2.5-14b", compute_dtype="float32", **{knob: value})
        toks = tokens(tc, (1, 12))
        jl = JM.forward(jp, {"inputs": jnp.asarray(toks)}, jc, jlo)[0]
        tl = TM.forward(tp, {"inputs": torch.as_tensor(toks)}, tc, tlo)[0]
        assert err(tl, jl) <= 2e-5 * max(1.0, float(np.abs(f32(jl)).max()))
        return
    from repro_torch.training.step import loss_and_grads
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    runs = [loss_and_grads(params, batch, c.replace(compute_dtype="float32"),
                           layout)
            for c in (cfg, cfg.replace(attention_impl="chunked"))]
    (lf, _, gf), (lc, _, gc) = runs
    assert abs(float(lf) - float(lc)) < 1e-5
    for a, b in zip(TP.tree_leaves(gf, is_leaf=torch.is_tensor),
                    TP.tree_leaves(gc, is_leaf=torch.is_tensor)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# ---------------------------------------------------------------------------
# the ssm family (falcon-mamba): the Mamba-1 block, its caches, K9's route
# ---------------------------------------------------------------------------


def ssm_prefill_decode(jx, tx, toks):
    """`prefill_decode` for mamba caches: the port's decode step updates
    the prefill caches in place, so they are copied before it runs."""
    (jc, jlo, jp), (tc, tlo, tp) = jx, tx
    B, S = toks.shape
    jl, _, jk = JM.forward(jp, {"inputs": jnp.asarray(toks[:, :-1])}, jc,
                           jlo, mode="prefill")
    tl, _, tk = TM.forward(tp, {"inputs": torch.as_tensor(toks[:, :-1])},
                           tc, tlo, mode="prefill")
    kept = {k: v.clone() for k, v in tk.items()}
    jd, _ = JM.decode_step(jp, j_p2d(jc, jk, S - 1, S + 4),
                           {"token": jnp.asarray(toks[:, -1]),
                            "pos": jnp.full((B,), S - 1, jnp.int32)}, jc, jlo)
    td, _ = TM.decode_step(tp, t_p2d(tc, tk, S - 1, S + 4),
                           {"token": torch.as_tensor(toks[:, -1]),
                            "pos": torch.full((B,), S - 1)}, tc, tlo)
    return (jl, jk, jd), (tl, kept, td)


def test_ssm_cache_specs():
    cfg = get_config(SSM)
    specs = TM.cache_specs(cfg, TM.make_layout(cfg, 1), 4, 128)
    assert {k: (s.shape, s.dtype) for k, s in specs.items()} == {
        "conv": ((64, 4, 3, 8192), "bfloat16"),
        "state": ((64, 4, 8192, 16), "bfloat16")}


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_ssm_prefill_and_decode_equal_reference_f32(impl):
    """The dense family's f32 tolerances: logits within 1e-4, caches within
    2e-5 of their largest value (the smoke state reaches ~5e5)."""
    jx, tx = both(SSM, compute_dtype="float32", attention_impl=impl)
    (jl, jk, jd), (tl, tk, td) = ssm_prefill_decode(jx, tx,
                                                    tokens(jx[0], (2, 32)))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert err(tl, jl) < F32_LOGIT_TOL
    assert err(td, jd) < F32_LOGIT_TOL
    for name in ("conv", "state"):
        assert tk[name].shape == jk[name].shape
        assert tk[name].dtype == torch.float32
        assert err(tk[name], jk[name]) < F32_CACHE_REL * max(
            1.0, float(np.abs(f32(jk[name])).max()))


def xla_cpu_silu(x):
    """`jax.nn.silu` as XLA on the CPU rounds it in bf16: x * logistic(x),
    with logistic expanded to 1 / (1 + exp(-x)) and every step rounded to
    x's dtype (the port's `F.silu` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_ssm_prefill_and_decode_equal_reference_bf16(impl):
    """The dense family's bf16 tolerances (see the module docstring) for
    the logits and the conv cache; the state cache (stored in the compute
    dtype, as the reference stores it) within 10 % of its largest value.
    Its error against the reference's f32 state is not bounded by the
    reference's own: the reference's `silu` rounds three more times (see
    `test_ssm_bf16_rounds_where_the_reference_rounds`), and the
    recurrence carries those roundings into a state whose bf16 error is
    already 17 % of its scale in the reference."""
    jx, tx = both(SSM, attention_impl=impl)
    toks = tokens(jx[0], (2, 32))
    (jl, jk, jd), (tl, tk, td) = ssm_prefill_decode(jx, tx, toks)
    jx32 = (jx[0].replace(compute_dtype="float32"),) + jx[1:]
    jl32, _, jk32 = JM.forward(jx32[2], {"inputs": jnp.asarray(toks[:, :-1])},
                               jx32[0], jx32[1], mode="prefill")
    for mine, ref, ref32 in ((tl, jl, jl32),
                             (tk["conv"], jk["conv"], jk32["conv"]),
                             (tk["state"], jk["state"], jk32["state"])):
        assert mine.dtype == (torch.float32 if mine is tl
                              else torch.bfloat16)
        scale = float(np.abs(f32(ref)).max())
        assert err(mine, ref) <= BF16_REL * scale
        if mine is not tk["state"]:
            assert err(mine, ref32) <= BF16_VS_F32_FACTOR * err(ref, ref32)
    assert err(td, jd) <= BF16_REL * float(np.abs(f32(jd)).max())


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_ssm_bf16_rounds_where_the_reference_rounds(monkeypatch, impl):
    """With `silu` rounded as the reference's XLA rounds it, the port's
    bf16 prefill caches equal the reference's bit for bit and its logits
    agree within 2e-3 (max |logit| ~0.73): every other step rounds at the
    same points."""
    monkeypatch.setattr(torch.nn.functional, "silu", xla_cpu_silu)
    jx, tx = both(SSM, attention_impl=impl)
    (jl, jk, jd), (tl, tk, td) = ssm_prefill_decode(jx, tx,
                                                    tokens(jx[0], (2, 32)))
    for name in ("conv", "state"):
        assert err(tk[name], jk[name]) == 0.0, name
    assert err(tl, jl) < 2e-3 and err(td, jd) < 5e-3


def test_ssm_pallas_equals_chunked_in_f32():
    """K9's route (`pallas`: dt in f32, then `mamba_scan`) against the
    chunked scan, at the reference's model gate (1e-3), over several
    chunks (S 64 at scan_chunk 16); also at train mode's other impls."""
    cfg = get_smoke_config(SSM).replace(compute_dtype="float32")
    params = params_from_numpy(smoke_weights(SSM), device="cpu")
    layout = TM.make_layout(cfg, 1)
    batch = {"inputs": torch.as_tensor(tokens(cfg, (2, 64), seed=0))}
    fc, _, _ = TM.forward(params, batch, cfg, layout)
    for impl in ("pallas", "dense", "flash"):
        fp, _, _ = TM.forward(params, batch,
                              cfg.replace(attention_impl=impl), layout)
        assert err(fc, fp) < 1e-3, impl


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 5e-2),
                                       ("float32", 1e-4)])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_ssm_prefill_plus_decode_equals_forward(impl, dtype, tol):
    """Prefill S tokens then decode 8 one by one == the full forward's
    logits; the positions are not read. bf16 within the reference's own
    ssm tolerance (5e-2, `tests/test_decode_consistency.py`): prefill
    stores the state in bf16 where the forward keeps it in f32. f32 within
    the f32 logit tolerance."""
    cfg = get_smoke_config(SSM).replace(attention_impl=impl,
                                        compute_dtype=dtype)
    params = params_from_numpy(smoke_weights(SSM), device="cpu")
    layout = TM.make_layout(cfg, 1)
    B, S, T = 2, 24, 8
    toks = torch.as_tensor(tokens(cfg, (B, S + T), seed=3))
    full, _, _ = TM.forward(params, {"inputs": toks}, cfg, layout)
    _, _, caches = TM.forward(params, {"inputs": toks[:, :S]}, cfg, layout,
                              mode="prefill")
    caches = t_p2d(cfg, caches, S, S + T + 2)
    errs = []
    for t in range(T):
        logits, caches = TM.decode_step(
            params, caches, {"token": toks[:, S + t],
                             "pos": torch.full((B,), 10 ** 6)}, cfg, layout)
        errs.append(float((logits - full[:, S + t]).abs().max()))
    assert max(errs) < tol, errs


def test_ssm_short_prompt_conv_cache_keeps_the_zero_padding():
    """A prompt shorter than conv_k - 1 leaves zero rows at the head of the
    conv cache, as the reference's `xp[:, -(K-1):]` does."""
    jx, tx = both(SSM, compute_dtype="float32")
    toks = tokens(jx[0], (1, 3))
    (jl, jk, jd), (tl, tk, td) = ssm_prefill_decode(jx, tx, toks)
    assert tk["conv"].shape[2] == 3
    assert not tk["conv"][:, :, :1].any()
    assert err(tk["conv"], jk["conv"]) < F32_CACHE_REL * float(
        np.abs(f32(jk["conv"])).max())
    assert err(td, jd) < F32_LOGIT_TOL


def test_ssm_lengths_the_chunked_scan_refuses():
    """S = 20 at scan_chunk 16 (one chunk of 20) runs; S = 34 (two chunks
    of 17) runs; S = 33 does not split into 2 equal chunks: ValueError
    naming it, on both routes (the reference asserts)."""
    cfg = get_smoke_config(SSM).replace(compute_dtype="float32")
    params = params_from_numpy(smoke_weights(SSM), device="cpu")
    layout = TM.make_layout(cfg, 1)
    for impl in ("chunked", "pallas"):
        c = cfg.replace(attention_impl=impl)
        for S in (20, 34):
            TM.forward(params, {"inputs": torch.as_tensor(
                tokens(cfg, (1, S)))}, c, layout)
        with pytest.raises(ValueError, match="33 tokens"):
            TM.forward(params, {"inputs": torch.as_tensor(
                tokens(cfg, (1, 33)))}, c, layout)


def test_ssm_skip_core_raises_naming_g2():
    """The ssm skip_core lowering, which raised until slice G2b, now runs
    and gives the reference's skip_core logits (within 2e-5 of the
    largest)."""
    (jc, jlo, jp), (tc, tlo, tp) = both(SSM, compute_dtype="float32",
                                        attention_impl="skip_core")
    toks = tokens(tc, (1, 12))
    jl = JM.forward(jp, {"inputs": jnp.asarray(toks)}, jc, jlo)[0]
    tl = TM.forward(tp, {"inputs": torch.as_tensor(toks)}, tc, tlo)[0]
    assert err(tl, jl) <= 2e-5 * max(1.0, float(np.abs(f32(jl)).max()))


def test_softplus_is_logaddexp_above_the_torch_threshold():
    """`jax.nn.softplus` is logaddexp(x, 0); `F.softplus` returns x above
    20. The port's matches JAX on both sides of that threshold."""
    from repro_torch.models import blocks as TB
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.9, 20.1, 25.0, 80.0], np.float32)
    got = TB._softplus(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    assert np.allclose(got, want, rtol=1e-6, atol=0.0)
