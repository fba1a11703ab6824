"""The port's other model families (hybrid, moe, vlm, encdec) against the
JAX package on the same smoke weights and inputs.

Tolerances are `test_torch_model.py`'s: f32 logits within 1e-4, caches
within 2e-5 of their largest value; bf16 within 10 % of the largest
reference value, and the port's bf16 error against the reference's f32
result within 1.25x the reference's own (in bf16 the logits are held
within the larger of 10 % and the reference's own bf16 error against its
f32 result, which whisper's smoke init makes 41 % of the scale). One
exception, with its basis:
whisper's f32 caches past the decoder's first self-attention carry the
encoder's output, and the smoke init (stacked weights of std 1/sqrt(2))
amplifies f32 rounding there so that a one-ulp change of the encoder's
input moves the reference's own caches by 1.7-3.8e-4 (1-2e-5 of their
scale). Those caches are held within the larger of 2e-5 of their scale
and `WITNESS_K` times that movement, measured in each test on the
reference alone.

The reference's `pallas` runs its Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE
from test_torch_model import F32_CACHE_REL, F32_LOGIT_TOL, both, err, f32, flat

HYBRID = "recurrentgemma-9b"
ARCTIC = "arctic-480b"
LLAMA4 = "llama4-maverick-400b-a17b"
VLM = "qwen2-vl-72b"
WHISPER = "whisper-large-v3"
FAMILIES = [HYBRID, ARCTIC, LLAMA4, VLM, WHISPER]
MOE = [ARCTIC, LLAMA4]
WITNESS_K = 4.0


def jx_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def case_inputs(cfg, B=2, S=32, seed=1):
    """The reference's decode-consistency inputs for `cfg`'s family, as
    numpy arrays: (prefill batch, decode batch, prompt length, max_len)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        enc = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        dec = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
        return ({"enc_embeds": enc, "dec_inputs": dec[:, :7]},
                {"token": dec[:, 7], "pos": np.full((B,), 7, np.int32)},
                7, cfg.encdec.max_dec_len)
    if cfg.embeds_input:
        emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        # M-RoPE positions of a 2 x 5 patch grid (t 0, h the row, w the
        # column), then text at t = h = w = 5 + i
        pos3 = np.zeros((B, S, 3), np.int32)
        pos3[:, :10, 1] = np.arange(10) // 5
        pos3[:, :10, 2] = np.arange(10) % 5
        pos3[:, 10:] = (5 + np.arange(S - 10))[None, :, None]
        return ({"embeds": emb[:, :S - 1], "positions": pos3[:, :S - 1]},
                {"embeds": emb[:, S - 1:], "token": np.zeros((B,), np.int32),
                 "pos": np.full((B,), S - 1, np.int32)}, S - 1, S + 4)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({"inputs": toks[:, :-1]},
            {"token": toks[:, -1], "pos": np.full((B,), S - 1, np.int32)},
            S - 1, S + 4)


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def prefill_decode(jx, tx, pre, dec, prompt_len, max_len):
    """Prefill then one decode step in both packages. The port's decode
    updates its caches in place, so the prefill caches are copied first."""
    (jc, jlo, jp), (tc, tlo, tp) = jx, tx
    jl, jaux, jk = JM.forward(jp, to_jax(pre), jc, jlo, mode="prefill")
    tl, taux, tk = TM.forward(tp, to_torch(pre), tc, tlo, mode="prefill")
    kept = jax.tree.map(lambda t: t.clone(), tk,
                        is_leaf=torch.is_tensor)
    jd, jdc = JM.decode_step(jp, JE.prefill_to_decode_cache(
        jc, jk, prompt_len, max_len), to_jax(dec), jc, jlo)
    td, tdc = TM.decode_step(tp, TE.prefill_to_decode_cache(
        tc, tk, prompt_len, max_len), to_torch(dec), tc, tlo)
    return (jl, jaux, jk, jd, jdc), (tl, taux, kept, td, tdc)


def cache_witness(jx, pre):
    """How far a one-ulp change of the encoder's input (each way) moves
    the reference's own f32 prefill caches, leaf by leaf."""
    jc, jlo, jp = jx
    _, _, base = JM.forward(jp, to_jax(pre), jc, jlo, mode="prefill")
    out = {}
    for side in (np.inf, -np.inf):
        moved = dict(pre, enc_embeds=np.nextafter(
            pre["enc_embeds"], np.float32(side)))
        _, _, c = JM.forward(jp, to_jax(moved), jc, jlo, mode="prefill")
        for path, a in flat(c).items():
            out[path] = max(out.get(path, 0.0), err(a, flat(base)[path]))
    return out


def cache_limits(jx, pre, ref_caches):
    """Each prefill cache leaf's f32 limit: 2e-5 of its scale, or for
    encdec the witness bound of the module docstring."""
    scale = {p: max(1.0, float(np.abs(f32(a)).max()))
             for p, a in flat(ref_caches).items()}
    limits = {p: F32_CACHE_REL * s for p, s in scale.items()}
    if jx[0].family == "encdec":
        for p, w in cache_witness(jx, pre).items():
            limits[p] = max(limits[p], WITNESS_K * w)
    return limits


# ---------------------------------------------------------------------------
# prefill and decode against the reference, each family, in f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_equal_reference_f32(arch, impl):
    """Logits (prefill and decode) within 1e-4; every prefill and decode
    cache leaf within its limit (`cache_limits`); the MoE aux loss within
    1e-6. The hybrid prompt (31 tokens) passes its window of 16, so
    `attn_local` pads and its ring wraps."""
    jx, tx = both(arch, compute_dtype="float32", attention_impl=impl)
    pre, dec, n, max_len = case_inputs(jx[0])
    (jl, jaux, jk, jd, jdc), (tl, taux, tk, td, tdc) = prefill_decode(
        jx, tx, pre, dec, n, max_len)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert err(tl, jl) < F32_LOGIT_TOL
    assert err(td, jd) < F32_LOGIT_TOL
    assert abs(float(taux) - float(jaux)) < 1e-6
    assert (float(jaux) > 0) == (jx[0].family == "moe")
    limits = cache_limits(jx, pre, jk)
    for caches, ref in ((tk, jk), (tdc, jdc)):
        mine, want = flat(caches), flat(ref)
        assert mine.keys() == want.keys()
        for path, a in mine.items():
            assert tuple(a.shape) == want[path].shape, path
            assert a.dtype == torch.float32, path
            assert err(a, want[path]) < limits[path], path
