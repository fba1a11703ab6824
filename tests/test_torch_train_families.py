"""The port's training loss and gradients against the JAX package's, for
every family at smoke width, under `chunked` and `flash` attention.

The reference's weights come across as numpy arrays
(`params_from_numpy`); both packages compute in f32. Tolerances: the loss
within 1e-5 x max(1, |loss|) (the two read 0-1.5e-6 apart at losses near
5); each gradient leaf within `GRAD_REL` of the reference leaf's largest
magnitude. The worst leaf seen is 1.4e-3 of its largest, at whisper's
first encoder layer, which takes the rounding of every layer above it
(the smoke init's stacked weights have std 1/sqrt(2)); the dense, moe,
vlm and ssm leaves read 2e-6 to 2.3e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pspec as JP
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro_torch import pspec as TP
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import step as TS

ARCHS = ["qwen3-32b", "falcon-mamba-7b", "recurrentgemma-9b", "arctic-480b",
         "qwen2-vl-72b", "whisper-large-v3"]
LOSS_REL = 1e-5
GRAD_REL = 3e-3


@functools.lru_cache(maxsize=None)
def weights(arch):
    cfg = j_smoke(arch)
    params = JP.init_params(JM.param_specs(cfg, JM.make_layout(cfg, 1)),
                            jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def train_batch(cfg, seed=0, B=2, S=32):
    """A batch of the family's inputs and targets, numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"enc_embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "dec_inputs": rng.integers(0, cfg.vocab_size, (B, 16)).astype(
                    np.int32),
                "targets": rng.integers(0, cfg.vocab_size, (B, 16)).astype(
                    np.int32)}
    if cfg.embeds_input:
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32)}
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def leaves_np(tree):
    return TP.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, (np.ndarray, torch.Tensor)))


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch, impl):
    jc = j_smoke(arch).replace(compute_dtype="float32", attention_impl=impl)
    tc = get_smoke_config(arch).replace(compute_dtype="float32",
                                        attention_impl=impl)
    p = weights(arch)
    batch = train_batch(jc)
    layout = JM.make_layout(jc, 1)
    (jl, jm), jg = jax.value_and_grad(
        lambda pp: JM.loss_fn(pp, jax.tree.map(jnp.asarray, batch), jc,
                              layout), has_aux=True)(p)
    tl, tm, tg = TS.loss_and_grads(
        params_from_numpy(p, device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()}, tc,
        TM.make_layout(tc, 1))
    assert abs(float(tl) - float(jl)) <= LOSS_REL * max(1.0, abs(float(jl)))
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-6
    want = leaves_np(TS.split_layers(jax.tree.map(np.asarray, jg)))
    got = leaves_np(tg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.max(np.abs(w))), 1e-30)
        assert float(np.max(np.abs(g.numpy() - w))) <= GRAD_REL * scale
