"""The port's other model families in their default bf16 compute against
the JAX package, and each family's prefill + decode against its own full
forward (the reference's `tests/test_decode_consistency.py`), including
the hybrid family's ring past its window. Tolerances and their basis are
in `test_torch_families.py`'s docstring."""

import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine as TE
from test_torch_model import (BF16_REL, BF16_VS_F32_FACTOR, F32_LOGIT_TOL,
                              both, err, f32, flat, smoke_weights)
from test_torch_families import (FAMILIES, HYBRID, case_inputs,
                                 prefill_decode, to_jax, to_torch)

# the reference's prefill + decode == forward tolerances
# (tests/test_decode_consistency.py)
CONSISTENCY_TOL = {"hybrid": 5e-2, "encdec": 5e-2}


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_equal_reference_bf16(arch):
    """The default bf16 compute, `pallas`: caches within 10 % of the
    largest reference value; logits within the larger of that and the
    reference's own bf16 error against its f32 logits (whisper's smoke
    init makes that error 41 % of the scale: a bf16 result cannot be held
    closer to the reference's bf16 than the reference is to itself in
    f32), and the port's error against the reference's f32 logits within
    1.25x the reference's own."""
    jx, tx = both(arch, attention_impl="pallas")
    pre, dec, n, max_len = case_inputs(jx[0])
    (jl, _, jk, jd, _), (tl, _, tk, td, _) = prefill_decode(
        jx, tx, pre, dec, n, max_len)
    jx32 = (jx[0].replace(compute_dtype="float32"),) + jx[1:]
    jl32 = JM.forward(jx32[2], to_jax(pre), jx32[0], jx32[1],
                      mode="prefill")[0]
    assert tl.dtype == torch.float32
    assert err(tl, jl) <= max(BF16_REL * float(np.abs(f32(jl)).max()),
                              err(jl, jl32))
    assert err(tl, jl32) <= BF16_VS_F32_FACTOR * err(jl, jl32)
    assert err(td, jd) <= BF16_REL * float(np.abs(f32(jd)).max())
    mine, want = flat(tk), flat(jk)
    for path, a in mine.items():
        assert a.dtype == torch.bfloat16, path
        assert err(a, want[path]) <= BF16_REL * float(
            np.abs(f32(want[path])).max()), path


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_plus_decode_equals_forward(arch, impl):
    """tests/test_decode_consistency.py on the port, per family: the
    default (bf16) compute, within the reference's tolerance (5e-2 for
    hybrid and encdec, else 1e-3)."""
    cfg = get_smoke_config(arch).replace(attention_impl=impl)
    params = params_from_numpy(smoke_weights(arch), device="cpu")
    layout = TM.make_layout(cfg, 1)
    pre, dec, n, max_len = case_inputs(cfg)
    if cfg.family == "encdec":
        full_batch = dict(pre, dec_inputs=np.concatenate(
            [pre["dec_inputs"], dec["token"][:, None]], 1))
    elif cfg.embeds_input:
        full_batch = {"embeds": np.concatenate([pre["embeds"],
                                                dec["embeds"]], 1),
                      "positions": np.concatenate(
                          [pre["positions"], np.broadcast_to(
                              dec["pos"][:, None, None], (2, 1, 3))], 1)}
    else:
        full_batch = {"inputs": np.concatenate(
            [pre["inputs"], dec["token"][:, None]], 1)}
    full = TM.forward(params, to_torch(full_batch), cfg, layout)[0]
    _, _, caches = TM.forward(params, to_torch(pre), cfg, layout,
                              mode="prefill")
    caches = TE.prefill_to_decode_cache(cfg, caches, n, max_len)
    logits, _ = TM.decode_step(params, caches, to_torch(dec), cfg, layout)
    tol = CONSISTENCY_TOL.get(cfg.family, 1e-3)
    assert float((logits - full[:, -1]).abs().max()) < tol


@pytest.mark.parametrize("S,T", [(8, 16), (16, 8), (20, 10)])
def test_hybrid_decode_chain_through_the_ring(S, T):
    """recurrentgemma smoke in f32 (window 16): prefill S tokens, decode T
    one by one through the ring, == the full forward's logits within
    1e-4. (8, 16) fills then wraps the ring, (16, 8) starts at a full one,
    (20, 10) prefills past the window."""
    cfg = get_smoke_config(HYBRID).replace(compute_dtype="float32")
    params = params_from_numpy(smoke_weights(HYBRID), device="cpu")
    layout = TM.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, S + T)))
    full = TM.forward(params, {"inputs": toks}, cfg.replace(
        scan_chunk=S + T), layout)[0]
    _, _, caches = TM.forward(params, {"inputs": toks[:, :S]}, cfg, layout,
                              mode="prefill")
    caches = TE.prefill_to_decode_cache(cfg, caches, S, S + T + 2)
    assert caches[2]["k"].shape[1] == cfg.hybrid.window
    errs = []
    for t in range(T):
        logits, caches = TM.decode_step(
            params, caches, {"token": toks[:, S + t],
                             "pos": torch.full((2,), S + t)}, cfg, layout)
        errs.append(float((logits - full[:, S + t]).abs().max()))
    assert max(errs) < F32_LOGIT_TOL, errs
