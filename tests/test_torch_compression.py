"""The port's int8 gradient compression (`distributed.compression`)
against the JAX package's, on the CPU.

`quantize_int8` / `dequantize_int8` are elementwise and per-tensor, the
same f32 operations as the reference's under `jax.jit` (where XLA takes
the scale as max |x| times the f32 reciprocal of 127, and fuses the
residual's multiply and subtract into one rounding): bitwise against the
jitted reference. `compressed_psum` over 4 gloo ranks
against the reference's under `shard_map` on 4 forced host devices, two
steps of `compressed_tree_psum` with error feedback: the residuals are
computed rank-locally from the same f32 operations, so they agree
bitwise. The means agree to the order of the scale sum: the int32 payload
sums exactly, but the 4 f32 scales are summed in the collective's order,
and two orders of a sum of n positive f32 values differ by at most 2(n-1)
units of rounding (u = 2^-24) of the sum; (ssum / n) and the final / n
are exact for n = 4, and the product with the payload rounds once on each
side. So |port - reference| <= (2(n-1) + 2) u |reference| elementwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prop import given, settings, st
from test_torch_pipeline import run_ranks

from repro.distributed import compression as JC
from repro_torch.distributed import compression as TC

N_RANKS = 4
MEAN_REL = (2 * (N_RANKS - 1) + 2) * 2.0 ** -24
SHAPES = {"a": (64,), "b": (8, 16)}
STEPS = 2


def grads_of(rank: int, step: int) -> dict:
    rng = np.random.default_rng(1000 * step + rank)
    scale = 10.0 ** rng.uniform(-3, 2)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-6), (2, 1e4),
                                        (3, 0.37), (4, 0.0), (5, 3e-30)])
def test_quantize_int8_equals_reference_bitwise(seed, scale):
    x = (np.random.default_rng(seed).normal(size=(257,)) * scale).astype(
        np.float32)
    jq, js = jax.jit(JC.quantize_int8)(jnp.asarray(x))
    tq, ts = TC.quantize_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    jd = np.asarray(jax.jit(JC.dequantize_int8)(jq, js))
    td = TC.dequantize_int8(tq, ts).numpy()
    assert jd.tobytes() == td.tobytes()


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-6, 1e4))
def test_quantize_roundtrip_bound(seed, scale):
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(64,))
                        * scale, dtype=torch.float32)
    q, s = TC.quantize_int8(x)
    err = (TC.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-12  # half a step of the grid


def test_wire_bytes_ratio():
    w = TC.wire_bytes_saved({"a": torch.zeros(10, 10), "b": torch.zeros(7)})
    assert w == {"fp32_bytes": 4.0 * 107, "int8_bytes": 107.0, "ratio": 4.0}
    res = TC.init_residuals({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert res["a"].dtype == torch.float32 and not res["a"].any()


JAX_PSUM = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed.compression import compressed_tree_psum
from repro.launch.mesh import compat_make_mesh
mesh = compat_make_mesh((4,), ("pod",))
def body(g, r):
    means, res = compressed_tree_psum(jax.tree.map(lambda a: a[0], g),
                                      "pod", jax.tree.map(lambda a: a[0], r))
    return means, jax.tree.map(lambda a: a[None], res)
fn = shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
               out_specs=(P(), P("pod")), check_rep=False)
fn = jax.jit(fn)
data = np.load(IN)
res = {k: jnp.zeros((4,) + data[f"0_0_{k}"].shape, jnp.float32)
       for k in KEYS}
out = {}
for step in range(STEPS):
    g = {k: jnp.stack([data[f"{step}_{r}_{k}"] for r in range(4)])
         for k in KEYS}
    means, res = fn(g, res)
    for k in KEYS:
        out[f"mean_{step}_{k}"] = np.asarray(means[k])
        out[f"res_{step}_{k}"] = np.asarray(res[k])
np.savez(OUT, **out)
print("OK")
"""

PORT_PSUM = """
    from repro_torch.distributed.compression import (compressed_tree_psum,
                                                     init_residuals)
    data = np.load(os.environ["IN_NPZ"])
    keys = sorted(k.split("_", 2)[2] for k in data.files
                  if k.startswith("0_0_"))
    steps = len({k.split("_")[0] for k in data.files})
    res = None
    for step in range(steps):
        g = {k: torch.as_tensor(data[f"{step}_{RANK}_{k}"]) for k in keys}
        res = init_residuals(g) if res is None else res
        means, res = compressed_tree_psum(g, None, res)
        for k in keys:
            OUT[f"mean_{step}_{k}"] = means[k].numpy().tolist()
            OUT[f"res_{step}_{k}"] = res[k].numpy().tolist()
"""


def test_compressed_psum_equals_reference(tmp_path):
    import subprocess
    import sys
    inp = tmp_path / "grads.npz"
    np.savez(inp, **{f"{s}_{r}_{k}": v for s in range(STEPS)
                     for r in range(N_RANKS)
                     for k, v in grads_of(r, s).items()})
    out = tmp_path / "jax.npz"
    code = (f"IN = {str(inp)!r}\nOUT = {str(out)!r}\nSTEPS = {STEPS}\n"
            f"KEYS = {sorted(SHAPES)!r}\n" + JAX_PSUM)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    want = np.load(out)
    ranks = run_ranks(PORT_PSUM, N_RANKS, tmp_path, "psum",
                      env={"IN_NPZ": str(inp)})
    for rank, got in enumerate(ranks):
        for s in range(STEPS):
            for k, shape in SHAPES.items():
                res = np.asarray(got[f"res_{s}_{k}"], np.float32)
                assert res.tobytes() == want[f"res_{s}_{k}"][rank].tobytes(), \
                    (rank, s, k)
                mean = np.asarray(got[f"mean_{s}_{k}"], np.float32)
                ref = want[f"mean_{s}_{k}"]
                assert mean.shape == shape
                assert np.all(np.abs(mean - ref) <= MEAN_REL * np.abs(ref)), \
                    (rank, s, k, float(np.max(np.abs(mean - ref))))
    # every rank holds the same mean
    for s in range(STEPS):
        for k in SHAPES:
            assert all(r[f"mean_{s}_{k}"] == ranks[0][f"mean_{s}_{k}"]
                       for r in ranks)
