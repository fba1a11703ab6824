"""The port's serving engine and serve CLI against the JAX package.

The tokens are held to the reference model's greedy decode (prefill, then
one `decode_step` per token, each request alone) on the same weights in f32
compute, where rounding cannot flip an argmax at smoke size. They are not
held to the reference's `ServingEngine.run`: its `_prime` writes a
request's cache into layer `slot` of the stacked caches instead of batch
row `slot` (ROADMAP Queue 3), so only its first token per request is the
model's; its slot lifecycle (how many tokens each request gets) is still
compared."""
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
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as TSERVE
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine as TE

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-14b"
SSM = "falcon-mamba-7b"
MAX_LEN = 40


@functools.lru_cache(maxsize=None)
def weights(arch=ARCH):
    cfg = j_get_smoke(arch)
    params = JP.init_params(JM.param_specs(cfg, JM.make_layout(cfg, 1)),
                            jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(n)]


def port_engine(batch_size, impl="pallas", max_len=MAX_LEN, arch=ARCH):
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         attention_impl=impl)
    return TE.ServingEngine(cfg,
                            params_from_numpy(weights(arch), device="cpu"),
                            batch_size=batch_size, max_len=max_len)


@functools.lru_cache(maxsize=None)
def reference_model(arch=ARCH):
    """The reference's smoke model in f32 and its jitted decode step."""
    cfg = j_get_smoke(arch).replace(compute_dtype="float32")
    layout = JM.make_layout(cfg, 1)
    step = jax.jit(functools.partial(JM.decode_step, cfg=cfg, layout=layout))
    return cfg, layout, jax.tree.map(jnp.asarray, weights(arch)), step


def reference_greedy(prompt, max_new, max_len=MAX_LEN, arch=ARCH):
    """The reference model's greedy tokens for one request, as the engine
    schedules them: the prefill's argmax, then one decode step per token
    until the budget or the cache runs out."""
    cfg, layout, params, step = reference_model(arch)
    logits, _, caches = JM.forward(params, {"inputs": jnp.asarray(prompt)[None]},
                                   cfg, layout, mode="prefill")
    caches = JE.prefill_to_decode_cache(cfg, caches, len(prompt), max_len)
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


def requests(ps, max_new):
    return [TE.Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(ps, max_new))]


def test_engine_tokens_equal_reference_greedy():
    """Five requests through two slots (so slots are reused while others
    decode), budgets 1-6, f32 compute: every token is the reference's."""
    ps = prompts(5)
    budgets = [6, 1, 4, 5, 3]
    done = port_engine(2).run(requests(ps, budgets))
    assert sorted(done) == list(range(5))
    for i, (p, m) in enumerate(zip(ps, budgets)):
        assert done[i] == reference_greedy(p, m), i


@pytest.mark.parametrize("impl", ["chunked", "dense"])
def test_engine_tokens_do_not_depend_on_impl_or_batch(impl):
    ps = prompts(4, seed=1)
    reqs = lambda: requests(ps, [5] * 4)  # noqa: E731
    base = port_engine(4).run(reqs())
    assert port_engine(2, impl).run(reqs()) == base
    assert port_engine(1, impl).run(reqs()) == base


def test_slot_lifecycle_equals_reference_engine():
    """The same number of tokens per request as the reference's engine,
    including the stop at max_len, and the same first (prefill) token."""
    ps = prompts(5, seed=2) + [np.arange(30, dtype=np.int32)]
    budgets = [6, 1, 4, 12, 3, 12]
    cfg = j_get_smoke(ARCH).replace(compute_dtype="float32")
    ref = JE.ServingEngine(cfg, jax.tree.map(jnp.asarray, weights()),
                           batch_size=2, max_len=MAX_LEN).run(
        [JE.Request(uid=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(ps, budgets))])
    mine = port_engine(2).run(requests(ps, budgets))
    assert {u: len(t) for u, t in mine.items()} == \
        {u: len(t) for u, t in ref.items()}
    assert {u: t[0] for u, t in mine.items()} == \
        {u: t[0] for u, t in ref.items()}
    assert len(mine[5]) == MAX_LEN - 30   # stopped by the cache length


def test_complete_at_prime_never_occupies_a_slot():
    eng = port_engine(2)
    done = eng.run(requests(prompts(3, seed=3), [1, 1, 1]))
    assert all(len(v) == 1 for v in done.values()) and len(done) == 3
    assert not eng.slots.any_live()
    assert eng.stats["decode_steps"] == 0 and eng.stats["prefills"] == 3


def test_refusals_name_the_request():
    eng = port_engine(2)
    with pytest.raises(ValueError, match="request 7 has 40 tokens but "
                                         "max_len is 40"):
        eng.run([TE.Request(uid=7, prompt=np.zeros(MAX_LEN, np.int32))])
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1, got "
                                         "0 \\(request 3\\)"):
        eng.run([TE.Request(uid=3, prompt=np.zeros(4, np.int32),
                            max_new_tokens=0)])


def test_prefill_to_decode_cache_equals_reference():
    rng = np.random.default_rng(4)
    k = rng.normal(size=(2, 1, 9, 1, 16)).astype(np.float32)
    cfg = get_smoke_config(ARCH)
    mine = TE.prefill_to_decode_cache(cfg, {"k": torch.as_tensor(k),
                                            "v": torch.as_tensor(k)}, 9, 20)
    ref = JE.prefill_to_decode_cache(j_get_smoke(ARCH),
                                     {"k": jnp.asarray(k),
                                      "v": jnp.asarray(k)}, 9, 20)
    assert np.array_equal(mine["k"].numpy(), np.asarray(ref["k"]))
    with pytest.raises(ValueError, match="does not fit"):
        TE.prefill_to_decode_cache(cfg, {"k": torch.as_tensor(k),
                                         "v": torch.as_tensor(k)}, 9, 8)
    assert TE.prefill_to_decode_cache(cfg, None, 9, 20) is None


def test_serve_cli_smoke_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--smoke", "--device", "cpu", "--requests", "3",
                          "--max-new", "4"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] qwen3-32b-smoke on cpu: 3 requests, 12 tokens" in \
        out.stdout


@pytest.mark.parametrize("flag,slice_", [(["--ckpt-dir", "x"], "slice G2")])
def test_serve_cli_later_paths_name_their_slice(flag, slice_, tmp_path,
                                                capsys):
    """`--ckpt-dir`, ported with slice G2a: serve.py restores the params a
    port trainer checkpointed and serves them, the tokens those of an
    engine over the trained params (not the random ones); a directory
    without a checkpoint raises FileNotFoundError."""
    from repro_torch.launch.train import train_loop
    from repro_torch.training.optimizer import OptConfig
    cfg = get_smoke_config("qwen3-32b")
    d = tmp_path / flag[1]
    state, _, _ = train_loop(cfg, steps=3, batch=2, seq=16, ckpt_dir=d,
                             opt=OptConfig(peak_lr=3e-2, warmup_steps=0,
                                           total_steps=3),
                             log_every=0, device="cpu")
    TSERVE.main(["--smoke", "--device", "cpu", "--requests", "3",
                 "--max-new", "4", flag[0], str(d)])
    out = capsys.readouterr().out
    assert f"[serve] restored step 3 from {d}" in out
    want = TE.ServingEngine(cfg, state["params"], batch_size=4,
                         max_len=128).run(TSERVE.random_requests(cfg, 3, 4))
    random = TE.ServingEngine(cfg, TSERVE.random_params(cfg, "cpu"),
                           batch_size=4, max_len=128).run(
        TSERVE.random_requests(cfg, 3, 4))
    assert want != random
    for uid in range(3):
        assert f"  req {uid}: {want[uid][:10]}" in out
    with pytest.raises(FileNotFoundError):
        TSERVE.main(["--smoke", "--device", "cpu", flag[0],
                     str(tmp_path / "empty")])


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_ssm_engine_tokens_equal_reference_greedy(impl):
    """falcon-mamba smoke, f32 compute: five requests through two slots
    (slots reused while others decode, dead slots fed a fixed token),
    budgets 1-6 and one request stopped by the cache length: every token is
    the reference model's greedy token, on both scan routes."""
    ps = prompts(5, seed=4) + [np.arange(30, dtype=np.int32)]
    budgets = [6, 1, 4, 5, 3, 12]
    done = port_engine(2, impl, arch=SSM).run(requests(ps, budgets))
    assert sorted(done) == list(range(6))
    assert len(done[5]) == MAX_LEN - 30
    for i, (p, m) in enumerate(zip(ps, budgets)):
        assert done[i] == reference_greedy(p, m, arch=SSM), i


def test_ssm_prime_writes_the_slot_row_of_every_layer():
    """A primed request's conv and state caches land in batch row `slot`
    of every layer, equal to its own prefill's caches; the other rows are
    untouched."""
    eng = port_engine(3, arch=SSM)
    before = {k: v.clone() for k, v in eng.caches.items()}
    prompt = prompts(1, seed=5)[0]
    eng._prime(1, TE.Request(uid=0, prompt=prompt, max_new_tokens=4))
    _, _, own = TM.forward(eng.params, {"inputs": torch.as_tensor(
        prompt.astype(np.int64))[None]}, eng.cfg, eng.layout,
        mode="prefill")
    for name in ("conv", "state"):
        assert torch.equal(eng.caches[name][:, 1], own[name][:, 0])
        for row in (0, 2):
            assert torch.equal(eng.caches[name][:, row],
                               before[name][:, row])


def test_ssm_prefill_to_decode_cache_passes_through():
    cfg = get_smoke_config(SSM)
    caches = {"conv": torch.ones(2, 1, 3, 128),
              "state": torch.ones(2, 1, 128, 4)}
    assert TE.prefill_to_decode_cache(cfg, caches, 9, 20) is caches
    ref = JE.prefill_to_decode_cache(j_get_smoke(SSM), caches, 9, 20)
    assert ref is caches


def test_serve_cli_ssm_smoke_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", SSM, "--smoke", "--device", "cpu",
                          "--requests", "3", "--max-new", "4"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] falcon-mamba-7b-smoke on cpu: 3 requests, 12 tokens" \
        in out.stdout


def test_serve_traffic_is_the_references():
    """serve.py's prompts: 4-23 tokens from default_rng(0), in order."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    want = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 24)))
            for _ in range(8)]
    got = TSERVE.random_requests(cfg, 8, 16)
    assert all(np.array_equal(r.prompt, w) and r.max_new_tokens == 16
               and r.prompt.dtype == np.int32 for r, w in zip(got, want))
