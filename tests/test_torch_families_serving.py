"""The serving engine and serve CLI on the port's other model families
against the JAX package: engine tokens equal to the reference engine's
where it writes batch rows (listed caches), else to the reference model's
greedy decode; the hybrid ring below the window, where the reference's
engine raises; the refusal of embedding-input families."""
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

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine as TE
from test_torch_model import smoke_weights
from test_torch_families import ARCTIC, HYBRID, LLAMA4, VLM, WHISPER, jx_tree

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(n)]


def port_engine(arch, batch_size, max_len, impl="pallas"):
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         attention_impl=impl)
    return TE.ServingEngine(cfg, params_from_numpy(smoke_weights(arch),
                                                   device="cpu"),
                            batch_size=batch_size, max_len=max_len)


def requests(ps, budgets, mod=TE):
    return [mod.Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(ps, budgets))]


@functools.lru_cache(maxsize=None)
def reference_model(arch):
    """The reference's smoke model in f32 and its jitted decode step."""
    cfg = j_get_smoke(arch).replace(compute_dtype="float32")
    layout = JM.make_layout(cfg, 1)
    step = jax.jit(functools.partial(JM.decode_step, cfg=cfg, layout=layout))
    return cfg, layout, jx_tree(smoke_weights(arch)), step


def reference_greedy(arch, prompt, max_new, max_len, cache_len=40):
    """The reference model's greedy tokens for one request, as the engine
    schedules them: the prefill's argmax, then one decode step per token
    until the budget or until pos + 2 reaches max_len. The reference's own
    decode caches are `cache_len` long (at least the hybrid window, where
    the reference serves); its greedy decode equals its greedy forward
    (`test_torch_families_bf16.py` holds decode to forward)."""
    cfg, layout, params, step = reference_model(arch)
    logits, _, caches = JM.forward(params, {"inputs": jnp.asarray(prompt)[None]},
                                   cfg, layout, mode="prefill")
    caches = JE.prefill_to_decode_cache(cfg, caches, len(prompt), cache_len)
    out = [int(jnp.argmax(logits[0, -1]))]
    pos = len(prompt) - 1
    while len(out) < max_new:
        pos += 1
        logits, caches = step(params, caches,
                              {"token": jnp.asarray([out[-1]], jnp.int32),
                               "pos": jnp.asarray([pos], jnp.int32)})
        out.append(int(jnp.argmax(logits[0])))
        if pos + 2 >= max_len:
            break
    return out


@pytest.mark.parametrize("arch", [HYBRID, LLAMA4])
def test_engine_tokens_equal_reference_engine(arch):
    """Listed caches (hybrid, interleaved MoE): the reference's engine
    writes each request into its batch row, so its tokens are the
    model's; five requests through two slots at max_len 40 (>= the
    hybrid window of 16, where the reference serves), f32: the port's
    engine gives the reference engine's tokens."""
    ps = prompts(5)
    budgets = [6, 1, 4, 5, 3]
    cfg, _, params, _ = reference_model(arch)
    ref = JE.ServingEngine(cfg, params, batch_size=2, max_len=40).run(
        requests(ps, budgets, JE))
    mine = port_engine(arch, 2, 40).run(requests(ps, budgets))
    assert mine == ref


def test_arctic_engine_tokens_equal_reference_greedy():
    """arctic's layers are uniform, so its caches are stacked and the
    reference engine writes a request into layer `slot` (ROADMAP Queue 3):
    the port's tokens are held to the reference model's greedy decode,
    and the slot lifecycle and first tokens to the reference engine."""
    ps = prompts(4, seed=1)
    budgets = [5, 1, 3, 4]
    cfg, _, params, _ = reference_model(ARCTIC)
    ref = JE.ServingEngine(cfg, params, batch_size=2, max_len=40).run(
        requests(ps, budgets, JE))
    mine = port_engine(ARCTIC, 2, 40).run(requests(ps, budgets))
    assert {u: len(t) for u, t in mine.items()} == \
        {u: len(t) for u, t in ref.items()}
    assert {u: t[0] for u, t in mine.items()} == \
        {u: t[0] for u, t in ref.items()}
    for i, (p, m) in enumerate(zip(ps, budgets)):
        assert mine[i] == reference_greedy(ARCTIC, p, m, 40), i


def test_hybrid_engine_below_the_window():
    """recurrentgemma smoke at max_len 12 < window 16: the reference's
    engine raises (its `_to_ring` makes a ring of the window, which does
    not fit the cache of 12); the port's ring of 12 serves, every token
    the reference model's greedy token (its decode on caches of 40, at
    the engine's schedule for max_len 12), one request stopped by the
    cache length."""
    ps = [np.arange(3, 8, dtype=np.int32), np.arange(9, 13, dtype=np.int32),
          np.arange(40, 49, dtype=np.int32)]
    budgets = [6, 4, 8]
    cfg, _, params, _ = reference_model(HYBRID)
    with pytest.raises(ValueError):
        JE.ServingEngine(cfg, params, batch_size=2, max_len=12).run(
            requests(ps, budgets, JE))
    eng = port_engine(HYBRID, 2, 12)
    assert eng.caches[2]["k"].shape[1] == 12
    done = eng.run(requests(ps, budgets))
    assert len(done[2]) == 12 - 9
    for i, (p, m) in enumerate(zip(ps, budgets)):
        assert done[i] == reference_greedy(HYBRID, p, m, 12), i


def test_ring_below_the_window_refuses_a_longer_prompt():
    cfg = get_smoke_config(HYBRID)
    k = torch.zeros(2, 14, 1, 16)
    with pytest.raises(ValueError, match="does not fit a ring"):
        TE.prefill_to_decode_cache(cfg, [{"k": k, "v": k}], 14, 12)
    ring = TE.prefill_to_decode_cache(cfg, [{"k": k, "v": k}], 14, 40)
    assert ring[0]["k"].shape == (2, 16, 1, 16)


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_engine_refuses_embedding_families(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match="token prompts"):
        TE.ServingEngine(cfg, {}, batch_size=2, max_len=16)


@pytest.mark.parametrize("arch", [HYBRID, LLAMA4, ARCTIC])
def test_serve_cli_families_on_the_cpu(arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--max-new", "4"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    name = get_smoke_config(arch).name
    assert f"[serve] {name} on cpu: 3 requests, 12 tokens" in out.stdout
