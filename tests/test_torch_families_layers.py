"""The layers and blocks of the port's other model families, each against
its JAX function: `attn_local`, the windowed `attn_decode`, `_to_ring`,
M-RoPE, `sincos_positions`, the RG-LRU scan's refusal, MoE routing (gate
choices, ties, capacity drops, aux loss), and the per-layer list layout
(`scan_layers=False`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch.configs import get_smoke_config
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine as TE
from test_torch_model import err, f32, flat, smoke_weights
from test_torch_families import ARCTIC, HYBRID, LLAMA4, MOE, jx_tree


# ---------------------------------------------------------------------------
# the new layers, each against its JAX function
# ---------------------------------------------------------------------------


def qkv(B, S, K, G, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype)
                 for s in ((B, S, K, G, D), (B, S, K, D), (B, S, K, D)))


@pytest.mark.parametrize("S,window", [(12, 16), (16, 16), (40, 16),
                                      (37, 16), (5, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_local_equals_reference(S, window, dtype):
    """S below, at, past and not a multiple of the window, and a window of
    one: f32 within 1e-5, bf16 (p rounded to bf16 before PV) within 2e-2
    of outputs of magnitude ~2; also == `attn_dense` with the window mask
    in f32."""
    q, k, v = qkv(2, S, 2, 3, 16, seed=S + window)
    ar = np.arange(S)
    jd = getattr(jnp, dtype)
    want = JL.attn_local(*(jnp.asarray(a, jd) for a in (q, k, v)),
                         q_pos=jnp.asarray(ar), kv_pos=jnp.asarray(ar),
                         scale=0.25, window=window)
    td = getattr(torch, dtype)
    got = TL.attn_local(*(torch.as_tensor(a).to(td) for a in (q, k, v)),
                        q_pos=torch.as_tensor(ar), kv_pos=torch.as_tensor(ar),
                        scale=0.25, window=window)
    assert got.shape == want.shape and got.dtype == td
    assert err(got, want) < (1e-5 if dtype == "float32" else 2e-2)
    if dtype == "float32":
        dense = JL.attn_dense(*(jnp.asarray(a) for a in (q, k, v)),
                              q_pos=jnp.asarray(ar), kv_pos=jnp.asarray(ar),
                              causal=True, scale=0.25, window=window)
        assert err(got, dense) < 1e-5


@pytest.mark.parametrize("window", [0, 4, 9])
def test_attn_decode_window_equals_reference(window):
    q, k, v = qkv(3, 12, 2, 2, 8, seed=window)
    q = q[:, :1]
    pos = np.array([0, 5, 11])
    want = JL.attn_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pos=jnp.asarray(pos), scale=0.3, window=window)
    got = TL.attn_decode(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), pos=torch.as_tensor(pos),
                         scale=0.3, window=window)
    assert err(got, want) < 1e-6


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (13, 8), (24, 8), (3, 1)])
def test_to_ring_equals_reference(S, W):
    """S < W, S == W, S > W (one wrap and a whole number of windows):
    bitwise, on a stacked (L, B, S, K, D) cache and a listed layer's."""
    k = np.random.default_rng(S).normal(size=(2, 3, S, 1, 4)).astype(
        np.float32)
    for a in (k, k[0]):
        want = np.asarray(JE._to_ring(jnp.asarray(a), W))
        got = TE._to_ring(torch.as_tensor(a), W).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("D", [16, 128, 80])
def test_mrope_equals_reference(D):
    """`mrope_sections` and `apply_rope(mrope=True)` at positions whose t, h
    and w differ, on (B, S, K, G, D) and (B, S, K, D); with t = h = w,
    M-RoPE is RoPE."""
    assert TL.mrope_sections(D) == JL.mrope_sections(D)
    rng = np.random.default_rng(D)
    pos = rng.integers(0, 50, (2, 7, 3)).astype(np.int32)
    for shape in ((2, 7, 2, 3, D), (2, 7, 2, D)):
        x = rng.normal(size=shape).astype(np.float32)
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, True)
        got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                            True)
        assert err(got, want) < 1e-5
    same = np.broadcast_to(pos[..., :1], pos.shape)
    assert torch.equal(
        TL.apply_rope(torch.as_tensor(x), torch.as_tensor(same.copy()), 1e6,
                      True),
        TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[..., 0]), 1e6))


@pytest.mark.parametrize("S,E", [(1500, 1280), (32, 64), (7, 10)])
def test_sincos_positions_equal_reference(S, E):
    assert np.array_equal(TL.sincos_positions(S, E),
                          np.asarray(JL.sincos_positions(S, E)))


def test_rglru_scan_refuses_what_the_reference_refuses():
    """`_ssm_scan` over S = 33 at scan_chunk 16 (two chunks of 16.5): the
    reference asserts, the port raises ValueError; S = 34 runs and == one
    sequential recurrence."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 34, 5)))
    b = torch.as_tensor(rng.normal(size=(2, 34, 5)))
    hs, h = TB._ssm_scan(a, b, torch.zeros(2, 5), chunk=16)
    want, hw = [], torch.zeros(2, 5, dtype=torch.float64)
    for t in range(34):
        hw = a[:, t] * hw + b[:, t]
        want.append(hw)
    assert torch.allclose(hs, torch.stack(want, 1)) and torch.allclose(h, hw)
    with pytest.raises(AssertionError):
        JB._ssm_scan(jnp.asarray(a[:, :33].numpy()),
                     jnp.asarray(b[:, :33].numpy()), jnp.zeros((2, 5)),
                     chunk=16, unroll=False)
    with pytest.raises(ValueError, match="33 tokens"):
        TB._ssm_scan(a[:, :33], b[:, :33], torch.zeros(2, 5), chunk=16)


# ---------------------------------------------------------------------------
# MoE routing: gates, ties, capacity drops, aux
# ---------------------------------------------------------------------------


def moe_layer(arch, **moe_knobs):
    """(jax cfg, port cfg, the first MoE layer's weights as numpy)."""
    jc, tc = j_get_smoke(arch), get_smoke_config(arch)
    if moe_knobs:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe_knobs))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe_knobs))
    w = smoke_weights(arch)["layers"]
    p = (w[TM.layer_kinds(tc).index("moe")]["moe"] if isinstance(w, list)
         else jax.tree.map(lambda a: a[0], w["moe"]))
    return jc, tc, p


def j_route(p, x, cfg):
    """The reference's routing lines (`moe_apply`), on JAX arrays."""
    m = cfg.moe
    B, S, E = x.shape
    _, g_size, cap = TB.moe_groups(cfg, B, S)
    xg = x.reshape(-1, g_size, E)
    logits = jnp.einsum("gse,ex->gsx", xg, p["router"].astype(x.dtype)
                        ).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(gate_idx, m.n_experts, dtype=jnp.int32)
    flatoh = onehot.reshape(xg.shape[0], g_size * m.top_k, m.n_experts)
    pos = jnp.cumsum(flatoh, axis=1) - flatoh
    pos = (pos * flatoh).sum(-1).reshape(gate_idx.shape)
    return np.asarray(gate_idx), np.asarray(pos < cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_gates_drops_and_aux_equal_reference(arch, dtype):
    """128 tokens in two groups of 64: the port's gate choices and kept
    choices equal the reference's; output and aux loss equal the
    reference's `moe_apply` (f32 within 1e-5 x scale; bf16, same routes,
    within 2e-2 x scale)."""
    jc, tc, p = moe_layer(arch)
    jc, tc = (c.replace(compute_dtype=dtype) for c in (jc, tc))
    x = (np.random.default_rng(7).normal(size=(2, 64, jc.d_model)))
    jxx = jnp.asarray(x, getattr(jnp, dtype))
    txx = torch.as_tensor(x).to(getattr(torch, dtype))
    tp = params_from_numpy(p, device="cpu")
    want_idx, want_keep = j_route(jx_tree(p), jxx, jc)
    G, g, cap = TB.moe_groups(tc, 2, 64)
    assert (G, g) == (2, 64)
    _, _, gates, idx, _, keep = TB.moe_route(tp, txx.reshape(G, g, -1), tc,
                                             cap)
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(keep.numpy(), want_keep)
    assert bool((gates[~keep] == 0).all())
    jout, jaux = JB.moe_apply(jx_tree(p), jxx, JB.Ctx(
        cfg=jc, layout=JM.make_layout(jc, 1)))
    tout, taux = TB.moe_apply(tp, txx, TB.Ctx(cfg=tc,
                                              layout=TM.make_layout(tc, 1)))
    scale = float(np.abs(f32(jout)).max())
    assert err(tout, jout) <= (1e-5 if dtype == "float32" else 2e-2) * scale
    assert abs(float(taux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_drops_equal_reference(arch):
    """tests/test_serving.py's drop case on the port: capacity_factor 1e-6
    (cap 4, its floor): most choices dropped, as in the reference; the
    output differs from the full-capacity one and equals the reference's
    within 1e-5 of its scale, finite."""
    jc, tc, p = moe_layer(arch, capacity_factor=1e-6)
    x = np.random.default_rng(0).normal(size=(1, 64, jc.d_model))
    tp = params_from_numpy(p, device="cpu")
    f32c = dict(compute_dtype="float32")
    jc, tc = jc.replace(**f32c), tc.replace(**f32c)
    _, want_keep = j_route(jx_tree(p), jnp.asarray(x, jnp.float32), jc)
    _, _, _, _, _, keep = TB.moe_route(
        tp, torch.as_tensor(x).float(), tc, TB.moe_groups(tc, 1, 64)[2])
    assert np.array_equal(keep.numpy(), want_keep)
    assert keep.float().mean() <= 0.5
    jout, _ = JB.moe_apply(jx_tree(p), jnp.asarray(x, jnp.float32), JB.Ctx(
        cfg=jc, layout=JM.make_layout(jc, 1)))
    ctx = TB.Ctx(cfg=tc, layout=TM.make_layout(tc, 1))
    tout, _ = TB.moe_apply(tp, torch.as_tensor(x).float(), ctx)
    full_cfg = tc.replace(moe=dataclasses.replace(tc.moe,
                                                  capacity_factor=4.0))
    full, _ = TB.moe_apply(tp, torch.as_tensor(x).float(),
                           TB.Ctx(cfg=full_cfg, layout=ctx.layout))
    assert bool(torch.isfinite(tout).all())
    assert float((full - tout).abs().max()) > 1e-6
    assert err(tout, jout) <= 1e-5 * float(np.abs(f32(jout)).max())


def test_moe_top_k_breaks_ties_as_the_reference():
    """A router whose expert columns repeat in pairs gives exactly tied
    probabilities: both packages pick the lower expert first, in every
    row, and the routes equal the reference's."""
    jc, tc, p = moe_layer(ARCTIC)
    p = dict(p, router=np.repeat(p["router"][:, :4], 2, axis=1))
    x = np.random.default_rng(1).normal(size=(1, 64, jc.d_model))
    want_idx, _ = j_route(jx_tree(p), jnp.asarray(x, jnp.float32), jc)
    _, _, _, idx, _, _ = TB.moe_route(
        params_from_numpy(p, device="cpu"),
        torch.as_tensor(x).float().reshape(1, 64, -1), tc, 64)
    assert np.array_equal(idx.numpy(), want_idx)
    assert bool((idx[..., 0] % 2 == 0).all())
    assert bool((idx[..., 1] == idx[..., 0] + 1).all())
    vals, order = TB._top_k(torch.tensor([[0.2, 0.3, 0.3, 0.1, 0.3]]), 3)
    assert order.tolist() == [[1, 2, 4]]


# ---------------------------------------------------------------------------
# specs, lists, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-14b", HYBRID])
def test_scan_layers_false_lists_equal_stacked(arch):
    """`scan_layers=False` keeps per-layer lists (the reference's layout);
    a uniform stack listed computes what the stacked one does, bitwise,
    prefill caches and decode included."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    layout = TM.make_layout(cfg, 1)
    w = smoke_weights(arch)
    stacked = params_from_numpy(w, device="cpu")
    listed = cfg.replace(scan_layers=False)
    specs = TM.param_specs(listed, layout)
    assert isinstance(specs["layers"], list)
    jspecs = JM.param_specs(j_get_smoke(arch).replace(scan_layers=False),
                            JM.make_layout(cfg, 1))
    assert {k: v.shape for k, v in flat(specs).items()} == \
        {k: v.shape for k, v in flat(jspecs).items()}
    if not isinstance(stacked["layers"], list):
        as_list = dict(stacked, layers=[TM._layer(stacked["layers"], i)
                                        for i in range(cfg.n_layers)])
    else:
        as_list = stacked
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)))
    a, _, ca = TM.forward(stacked, {"inputs": toks}, cfg, layout,
                          mode="prefill")
    b, _, cb = TM.forward(as_list, {"inputs": toks}, listed, layout,
                          mode="prefill")
    assert torch.equal(a, b)
    assert isinstance(cb, list) and len(cb) == cfg.n_layers
    for i, c in enumerate(cb):
        for name, t in c.items():
            ref = ca[i][name] if isinstance(ca, list) else ca[name][i]
            assert torch.equal(t, ref)
    dec = {"token": toks[:, -1], "pos": torch.full((2,), 12)}
    da = TM.decode_step(stacked, TE.prefill_to_decode_cache(
        cfg, ca, 12, 16), dec, cfg, layout)[0]
    db = TM.decode_step(as_list, TE.prefill_to_decode_cache(
        listed, cb, 12, 16), dec, listed, layout)[0]
    assert torch.equal(da, db)


def test_mrope_on_a_dense_config_with_equal_positions_is_rope():
    cfg = get_smoke_config("qwen2.5-14b").replace(compute_dtype="float32")
    params = params_from_numpy(smoke_weights("qwen2.5-14b"), device="cpu")
    layout = TM.make_layout(cfg, 1)
    toks = torch.as_tensor([[1, 2, 3, 4, 5]])
    a = TM.forward(params, {"inputs": toks}, cfg, layout)[0]
    b = TM.forward(params, {"inputs": toks}, cfg.replace(pos="mrope"),
                   layout)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch,kinds", [
    (HYBRID, ("rec", "rec", "attn_mlp")), (LLAMA4, ("moe", "moe")),
    (ARCTIC, ("moe", "moe"))])
def test_layer_kinds_and_cache_specs_equal_reference(arch, kinds):
    cfg = get_smoke_config(arch)
    assert TM.layer_kinds(cfg) == JM.layer_kinds(j_get_smoke(arch)) == kinds
    for max_len in (8, 40):
        mine = flat(TM.cache_specs(cfg, TM.make_layout(cfg, 1), 3, max_len))
        ref = flat(JM.cache_specs(j_get_smoke(arch), JM.make_layout(cfg, 1),
                                  3, max_len))
        assert {k: (v.shape, v.dtype) for k, v in mine.items()} == \
            {k: (v.shape, v.dtype) for k, v in ref.items()}


def test_decode_refuses_bad_positions_before_writing():
    """A linear cache refuses positions outside it; a hybrid ring of the
    window takes any position from 0 (written at pos % length) and refuses
    a negative one, a ring below the window refuses one past its length;
    nothing is written by a refused step."""
    for arch, bad in ((LLAMA4, (36, -1)), (HYBRID, (-1,))):
        cfg = get_smoke_config(arch)
        params = params_from_numpy(smoke_weights(arch), device="cpu")
        layout = TM.make_layout(cfg, 1)
        caches = TE.init_decode_cache(cfg, layout, 1, 36, device="cpu")
        before = [{k: v.clone() for k, v in c.items()} for c in caches]
        for pos in bad:
            with pytest.raises(ValueError, match="decode positions"):
                TM.decode_step(params, caches, {"token": torch.tensor([3]),
                                                "pos": torch.tensor([pos])},
                               cfg, layout)
        assert all(torch.equal(c[k], b[k]) for c, b in zip(caches, before)
                   for k in c)
    # the hybrid ring: a position past its length is written at pos % 16
    TM.decode_step(params, caches, {"token": torch.tensor([3]),
                                    "pos": torch.tensor([100])}, cfg, layout)
    assert caches[2]["k"][0, 100 % 16].any()
    # a ring below the window (max_len 12) is a linear buffer: 12 raises
    short = TE.init_decode_cache(cfg, layout, 1, 12, device="cpu")
    with pytest.raises(ValueError, match="decode positions"):
        TM.decode_step(params, short, {"token": torch.tensor([3]),
                                       "pos": torch.tensor([12])}, cfg,
                       layout)


def test_encdec_refuses_a_prompt_past_max_dec_len():
    """The decoder's learned positions and self-attention cache hold
    max_dec_len (32 at smoke size): 33 tokens raise ValueError, 32 run
    and fill the cache."""
    cfg = get_smoke_config("whisper-large-v3").replace(
        compute_dtype="float32")
    params = params_from_numpy(smoke_weights("whisper-large-v3"),
                               device="cpu")
    layout = TM.make_layout(cfg, 1)
    enc = torch.zeros(1, 8, cfg.d_model)
    with pytest.raises(ValueError, match="exceeds max_dec_len 32"):
        TM.forward(params, {"enc_embeds": enc,
                            "dec_inputs": torch.zeros(1, 33, dtype=torch.long)},
                   cfg, layout, mode="prefill")
    _, _, caches = TM.forward(params, {"enc_embeds": enc, "dec_inputs":
                                       torch.zeros(1, 32, dtype=torch.long)},
                              cfg, layout, mode="prefill")
    assert caches["k"].shape[2] == 32 and caches["ck"].shape[2] == 8


@pytest.mark.parametrize("arch", ["qwen2.5-14b", HYBRID])
def test_local_impl_without_a_window_is_chunked(arch):
    """`attention_impl="local"` runs `attn_chunked` where a layer has no
    window (the reference's fall-through) and `attn_local` where it has
    one, as every impl does: its logits equal `chunked`'s bitwise."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    params = params_from_numpy(smoke_weights(arch), device="cpu")
    layout = TM.make_layout(cfg, 1)
    toks = {"inputs": torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 20)))}
    a = TM.forward(params, toks, cfg.replace(attention_impl="local"),
                   layout)[0]
    b = TM.forward(params, toks, cfg.replace(attention_impl="chunked"),
                   layout)[0]
    assert torch.equal(a, b)
