"""The port's plain PW oracle (`repro_torch.kernels.advection.ref`) against
the JAX reference's pure-jnp functions, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.advection import ref as JREF
from repro_torch.kernels.advection import ref as TREF

DT = 0.01
SHAPES = [(6, 10, 12), (5, 8, 8), (4, 9, 16)]


def np_fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(3)]


def to_jax(fields, Z):
    return ([jnp.asarray(f, jnp.float32) for f in fields],
            JREF.default_params(Z))


def to_torch(fields, Z):
    return (list(TREF.fields_from_numpy(*fields, device="cpu")),
            TREF.default_params(Z, device="cpu"))


def jax_f64(fn, fields, p):
    """Run `fn(u, v, w, p)` on genuinely f64 JAX inputs, on either JAX API
    (`jax.experimental.enable_x64` where it exists, else
    `jax.enable_x64(True)`)."""
    if hasattr(jax.experimental, "enable_x64"):
        return JREF._with_f64(fn, fields, p)
    f_np = [np.asarray(t, np.float64) for t in fields]
    p_np = [np.asarray(t, np.float64) for t in p]
    with jax.enable_x64(True):
        return fn(*(jnp.asarray(t) for t in f_np),
                  JREF.AdvectParams(*(jnp.asarray(t) for t in p_np)))


def jax_multistep_f64(fields, p, T, dt):
    def run(u, v, w, pp):
        for _ in range(T):
            u, v, w = JREF.pw_step_ref(u, v, w, pp, dt)
        return [np.asarray(t, np.float64) for t in (u, v, w)]
    return jax_f64(run, fields, p)


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


@pytest.mark.parametrize("Z", [4, 12, 64])
def test_default_params_equal(Z):
    jp = JREF.default_params(Z)
    tp = TREF.default_params(Z, device="cpu")
    for a, b in zip(jp, tp):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_params_from_numpy_takes_the_reference_params():
    jp = JREF.default_params(12)
    tp = TREF.params_from_numpy(jp, device="cpu")
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_pw_advect_ref_matches_jax(shape):
    fields = np_fields(shape, seed=1)
    (ju, jv, jw), jp = to_jax(fields, shape[2])
    (tu, tv, tw), tp = to_torch(fields, shape[2])
    want = JREF.pw_advect_ref(ju, jv, jw, jp)
    got = TREF.pw_advect_ref(tu, tv, tw, tp)
    assert max_diff(got, want) <= 1e-6


@pytest.mark.parametrize("dt", [1.0, DT])
def test_pw_step_ref_matches_jax(dt):
    shape = (6, 10, 12)
    fields = np_fields(shape, seed=2)
    (ju, jv, jw), jp = to_jax(fields, shape[2])
    (tu, tv, tw), tp = to_torch(fields, shape[2])
    want = JREF.pw_step_ref(ju, jv, jw, jp, dt)
    got = TREF.pw_step_ref(tu, tv, tw, tp, dt)
    assert max_diff(got, want) <= 1e-6


def test_batched_ref_equals_each_slot_bitwise():
    """A leading slot dimension, with per-slot params, computes each slot
    exactly as an unbatched call does."""
    shape = (5, 8, 8)
    slots = [np_fields(shape, seed=s) for s in range(3)]
    u, v, w = (torch.stack([torch.as_tensor(sl[i], dtype=torch.float32)
                            for sl in slots]) for i in range(3))
    base = TREF.default_params(8, device="cpu")
    scale = torch.tensor([1.0, 2.0, 0.5])
    p = TREF.AdvectParams(base.tcx * scale, base.tcy, base.tzc1,
                          base.tzc2[None] * scale[:, None])
    got = TREF.pw_advect_ref(u, v, w, p)
    for b in range(3):
        pb = TREF.AdvectParams(p.tcx[b], p.tcy, p.tzc1, p.tzc2[b])
        one = TREF.pw_advect_ref(u[b], v[b], w[b], pb)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


def test_pw_advect_ref_f64_matches_jax():
    shape = (6, 10, 12)
    fields = np_fields(shape, seed=3)
    jp = JREF.default_params(shape[2])
    want = jax_f64(lambda u, v, w, p: [np.asarray(t) for t in
                                       JREF.pw_advect_ref(u, v, w, p)],
                   fields, jp)
    got = TREF.pw_advect_ref_f64(*fields, TREF.params_from_numpy(
        jp, device="cpu"))
    assert all(g.dtype == torch.float64 for g in got)
    assert max_diff(got, want) <= 1e-12


@pytest.mark.parametrize("T", [1, 2, 4])
def test_multistep_f64_oracle_matches_jax(T):
    shape = (6, 10, 12)
    fields = np_fields(shape, seed=4)
    jp = JREF.default_params(shape[2])
    want = jax_multistep_f64(fields, jp, T, DT)
    got = TREF.pw_multistep_ref_f64(*fields, TREF.params_from_numpy(
        jp, device="cpu"), T, DT)
    assert max_diff(got, want) <= 1e-12


def test_flops_per_cell_equals_jax():
    assert TREF.flops_per_cell() == 63
    assert TREF.flops_per_cell() == JREF.flops_per_cell()
