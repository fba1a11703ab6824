"""`attention_impl="skip_core"`, the reference's phase-attribution lowering
(attention's S^2 core, the MoE one-hot dispatch and combine, the mamba scan
and the RG-LRU recurrence dropped, the projections kept), against JAX's
`skip_core` forward on the same smoke weights, one config a family, in f32.

Tolerance: `TOL_REL["float32"]` of the reference's stencil suite, 2e-5 of
the largest reference logit (at least 1): the lowering leaves products,
norms and gates, where the two frameworks differ by f32 rounding only."""
import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.models import model as TM
from test_torch_families import case_inputs, to_jax, to_torch
from test_torch_model import both, f32

TOL_REL_F32 = 2e-5
FAMILY_ARCHS = ["qwen2.5-14b", "falcon-mamba-7b", "recurrentgemma-9b",
                "arctic-480b", "llama4-maverick-400b-a17b", "qwen2-vl-72b",
                "whisper-large-v3"]


def skip_core_pair(arch, mode="train"):
    """(reference logits, aux), (port logits, aux) of a skip_core forward
    of `arch`'s smoke config in f32."""
    jx, tx = both(arch, compute_dtype="float32", attention_impl="skip_core")
    (jc, jlo, jp), (tc, tlo, tp) = jx, tx
    pre = case_inputs(jc)[0]
    jl, jaux, _ = JM.forward(jp, to_jax(pre), jc, jlo, mode=mode)
    with torch.no_grad():
        tl, taux, _ = TM.forward(tp, to_torch(pre), tc, tlo, mode=mode)
    return (jl, jaux), (tl, taux)


def within(got, want) -> bool:
    w = f32(want)
    tol = TOL_REL_F32 * max(1.0, float(np.abs(w).max()))
    return float(np.abs(f32(got) - w).max()) <= tol


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_skip_core_forward_equals_reference(arch):
    (jl, jaux), (tl, taux) = skip_core_pair(arch)
    assert tuple(tl.shape) == tuple(jl.shape)
    assert within(tl, jl)
    assert within(taux, jaux)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "falcon-mamba-7b"])
def test_skip_core_prefill_equals_reference(arch):
    (jl, _), (tl, _) = skip_core_pair(arch, mode="prefill")
    assert within(tl, jl)


def test_skip_core_drops_the_core():
    """The lowering changes the output (the core is gone) and dispatches
    none of the core's products: no attention logits of (S, S)."""
    from repro_torch.analysis.trace import record_ops
    from test_torch_model import both as both_
    _, (tc, tlo, tp) = both_("qwen2.5-14b", compute_dtype="float32")
    batch = {"inputs": torch.as_tensor(np.random.default_rng(1).integers(
        0, tc.vocab_size, (1, 24)))}
    full = TM.forward(tp, batch, tc, tlo)[0]
    skip_cfg = tc.replace(attention_impl="skip_core")
    skip = TM.forward(tp, batch, skip_cfg, tlo)[0]
    assert not torch.equal(full, skip)
    recs = record_ops(lambda p, b: TM.forward(p, b, skip_cfg, tlo), tp,
                      batch)
    assert not any(m.shape[-2:] == (24, 24) for r in recs
                   for m in r.results)
