"""The port's fused advection and finite guard (`repro_torch.kernels.
advection.advection`) against the JAX reference, on the same numpy inputs.

On the CPU the port's wrappers run their kernels' plain versions; those
are held here against a masked JAX `pw_step_ref` loop, the f64 oracle, the
JAX `finite_guard` (interpret mode) and, where the installed Pallas still
has `pl.Unblocked`, the JAX `advect_fused` kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels.advection import advection as JK
from repro.kernels.advection import ref as JREF
from repro_torch import _build
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF

DT = 0.01
HAS_UNBLOCKED = hasattr(pl, "Unblocked")
needs_unblocked = pytest.mark.skipif(
    not HAS_UNBLOCKED, reason="the installed Pallas has no pl.Unblocked, "
    "which the JAX advect_fused kernel needs (jax 0.4.x has it)")


def np_fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def tfields(fields):
    return list(TREF.fields_from_numpy(*fields, device="cpu"))


def tparams(jp):
    return TREF.params_from_numpy(jp, device="cpu")


def jax_masked_loop(fields, jp, T, xm=None, ym=None):
    """The reference's masked Euler loop (tests/test_advection_fused.py)."""
    X, Y, _ = fields[0].shape
    xm = np.ones(X, np.float32) if xm is None else xm
    ym = np.ones(Y, np.float32) if ym is None else ym
    m = (jnp.asarray(xm)[:, None, None] > 0) & (jnp.asarray(ym)[None, :, None]
                                                > 0)
    us, vs, ws = (jnp.asarray(f) for f in fields)
    for _ in range(T):
        su, sv, sw = JREF.pw_advect_ref(us, vs, ws, jp)
        us = us + DT * jnp.where(m, su, 0.0)
        vs = vs + DT * jnp.where(m, sv, 0.0)
        ws = ws + DT * jnp.where(m, sw, 0.0)
    return us, vs, ws


def jax_multistep_f64(fields, jp, T):
    if hasattr(jax.experimental, "enable_x64"):
        return JREF.pw_multistep_ref_f64(*fields, jp, T, DT)
    f_np = [np.asarray(t, np.float64) for t in fields]
    p_np = [np.asarray(t, np.float64) for t in jp]
    with jax.enable_x64(True):
        f = [jnp.asarray(t) for t in f_np]
        p64 = JREF.AdvectParams(*(jnp.asarray(t) for t in p_np))
        for _ in range(T):
            f = JREF.pw_step_ref(*f, p64, DT)
        return [np.asarray(t, np.float64) for t in f]


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("T", [1, 2, 4])
def test_plain_fused_matches_jax_masked_loop(T):
    shape = (6, 10, 12)
    fields = np_fields(shape)
    jp = JREF.default_params(shape[2])
    got = TK.advect_fused(*tfields(fields), tparams(jp), T=T, dt=DT)
    assert max_diff(got, jax_masked_loop(fields, jp, T)) <= 1e-6


def test_plain_fused_masks_match_jax_masked_loop():
    X, Y, Z, T = 8, 12, 10, 3
    fields = np_fields((X, Y, Z), seed=8)
    jp = JREF.default_params(Z)
    xm = np.ones(X, np.float32)
    xm[:3] = 0.0
    ym = np.ones(Y, np.float32)
    ym[7:] = 0.0
    got = TK.advect_fused(*tfields(fields), tparams(jp), T=T, dt=DT,
                          x_interior_mask=xm, y_interior_mask=ym)
    assert max_diff(got, jax_masked_loop(fields, jp, T, xm, ym)) <= 1e-6
    ones = TK.advect_fused(*tfields(fields), tparams(jp), T=T, dt=DT,
                           x_interior_mask=np.ones(X, np.float32))
    assert bitwise(ones, TK.advect_fused(*tfields(fields), tparams(jp), T=T,
                                         dt=DT))


def _batched_case():
    B, X, Y, Z, T = 3, 5, 9, 8, 2
    slots = [np_fields((X, Y, Z), seed=10 + b) for b in range(B)]
    jp = JREF.default_params(Z)
    scale = np.array([1.0, 1.5, 0.5], np.float32)
    pslots = [JREF.AdvectParams(jp.tcx * s, jp.tcy, jp.tzc1 * s, jp.tzc2)
              for s in scale]
    xm = np.ones((B, X), np.float32)
    xm[1, 2] = 0.0
    ym = np.ones((B, Y), np.float32)
    ym[2, 4:] = 0.0
    return B, T, slots, pslots, xm, ym


def test_plain_fused_batched_per_slot_matches_jax():
    B, T, slots, pslots, xm, ym = _batched_case()
    u, v, w = (torch.stack([torch.as_tensor(sl[i]) for sl in slots])
               for i in range(3))
    p = TREF.AdvectParams(
        torch.stack([torch.tensor(np.array(q.tcx)) for q in pslots]),
        torch.tensor(np.array(pslots[0].tcy)),
        torch.stack([torch.tensor(np.array(q.tzc1)) for q in pslots]),
        torch.tensor(np.array(pslots[0].tzc2)))
    got = TK.advect_fused_batched(u, v, w, p, T=T, dt=DT, x_interior_mask=xm,
                                  y_interior_mask=ym)
    for b in range(B):
        want = jax_masked_loop(slots[b], pslots[b], T, xm[b], ym[b])
        assert max_diff([g[b] for g in got], want) <= 1e-6, b
        seq = TK.advect_fused(*tfields(slots[b]), tparams(pslots[b]), T=T,
                              dt=DT, x_interior_mask=xm[b],
                              y_interior_mask=ym[b])
        assert bitwise([g[b] for g in got], seq), b


LEAVES = ("tcx", "tcy", "tzc1", "tzc2")


def _one_leaf_per_slot(jp, leaf, scale):
    """Per-slot JAX params for each slot, and the batched JAX params in
    which only `leaf` carries the slot axis."""
    pslots = [jp._replace(**{leaf: getattr(jp, leaf) * s}) for s in scale]
    stacked = jp._replace(**{leaf: jnp.stack([getattr(q, leaf)
                                              for q in pslots])})
    return pslots, stacked


@pytest.mark.parametrize("per_slot", [(), ("tcx",), ("tzc1",), ("tzc2",),
                                      LEAVES])
def test_param_table_rows(per_slot):
    """The fused kernel reads one table [tcx, tcy, tzc1, tzc2] with one slot
    stride: every slot's row holds its own value of each leaf."""
    B, Z = 3, 6
    base = TREF.default_params(Z, device="cpu")
    leaves = {n: (torch.stack([getattr(base, n) * (b + 1) for b in range(B)])
                  if n in per_slot else getattr(base, n)) for n in LEAVES}
    table, stride = TK._param_table(TREF.AdvectParams(**leaves), B)
    assert table.is_contiguous()
    assert stride == (0 if not per_slot else 2 + 2 * Z)
    assert table.shape == ((B if per_slot else 1), 2 + 2 * Z)
    for b in range(B):
        row = table.flatten()[b * stride:b * stride + 2 + 2 * Z]
        want = torch.cat([(leaves[n][b] if n in per_slot else leaves[n])
                          .reshape(-1) for n in LEAVES])
        assert torch.equal(row, want), b


@pytest.mark.parametrize("leaf", LEAVES)
def test_plain_fused_batched_one_per_slot_leaf_matches_jax(leaf):
    """Any single leaf may carry the slot axis while the others are shared."""
    B, T, slots, _, xm, ym = _batched_case()
    pslots, stacked = _one_leaf_per_slot(JREF.default_params(8), leaf,
                                         np.array([1.0, 1.5, 0.5],
                                                  np.float32))
    u, v, w = (torch.stack([torch.as_tensor(sl[i]) for sl in slots])
               for i in range(3))
    got = TK.advect_fused_batched(u, v, w, tparams(stacked), T=T, dt=DT,
                                  x_interior_mask=xm, y_interior_mask=ym)
    for b in range(B):
        want = jax_masked_loop(slots[b], pslots[b], T, xm[b], ym[b])
        assert max_diff([g[b] for g in got], want) <= 1e-6, b
        seq = TK.advect_fused(*tfields(slots[b]), tparams(pslots[b]), T=T,
                              dt=DT, x_interior_mask=xm[b],
                              y_interior_mask=ym[b])
        assert bitwise([g[b] for g in got], seq), b


@pytest.mark.parametrize("T", [1, 2, 4])
def test_plain_fused_within_f64_oracle(T):
    shape = (6, 10, 12)
    fields = np_fields(shape)
    jp = JREF.default_params(shape[2])
    got = TK.advect_fused(*tfields(fields), tparams(jp), T=T, dt=DT)
    assert max_diff(got, jax_multistep_f64(fields, jp, T)) < 1e-4


def test_plain_fused_boundary_cells_frozen():
    shape = (6, 9, 10)
    fields = np_fields(shape, seed=1)
    u0 = tfields(fields)
    out = TK.advect_fused(*u0, tparams(JREF.default_params(10)), T=3, dt=DT)
    for f0, fT in zip(u0, out):
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                   np.s_[:, :, 0], np.s_[:, :, -1]):
            assert torch.equal(fT[sl], f0[sl])


@needs_unblocked
@pytest.mark.parametrize("T,y_tile", [(1, None), (4, None), (2, None),
                                      (2, 5), (2, 7), (2, 64)])
def test_fused_matches_jax_advect_fused(T, y_tile):
    shape = (5, 17, 12)
    fields = np_fields(shape, seed=3)
    jp = JREF.default_params(shape[2])
    want = JK.advect_fused(*(jnp.asarray(f) for f in fields), jp, T=T, dt=DT,
                           y_tile=y_tile)
    got = TK.advect_fused(*tfields(fields), tparams(jp), T=T, dt=DT,
                          y_tile=y_tile)
    assert max_diff(got, want) <= 1e-5


@needs_unblocked
def test_fused_masks_match_jax_advect_fused():
    X, Y, Z, T = 8, 12, 10, 3
    fields = np_fields((X, Y, Z), seed=8)
    jp = JREF.default_params(Z)
    xm = np.ones(X, np.float32)
    xm[:3] = 0.0
    ym = np.ones(Y, np.float32)
    ym[7:] = 0.0
    want = JK.advect_fused(*(jnp.asarray(f) for f in fields), jp, T=T, dt=DT,
                           y_tile=4, x_interior_mask=jnp.asarray(xm),
                           y_interior_mask=jnp.asarray(ym))
    got = TK.advect_fused(*tfields(fields), tparams(jp), T=T, dt=DT,
                          y_tile=4, x_interior_mask=xm, y_interior_mask=ym)
    assert max_diff(got, want) <= 1e-5


@needs_unblocked
def test_fused_batched_matches_jax_advect_fused_batched():
    B, T, slots, pslots, xm, ym = _batched_case()
    ju, jv, jw = (jnp.stack([jnp.asarray(sl[i]) for sl in slots])
                  for i in range(3))
    jp = JREF.AdvectParams(jnp.stack([q.tcx for q in pslots]), pslots[0].tcy,
                           jnp.stack([q.tzc1 for q in pslots]),
                           pslots[0].tzc2)
    want = JK.advect_fused_batched(ju, jv, jw, jp, T=T, dt=DT,
                                   x_interior_mask=jnp.asarray(xm),
                                   y_interior_mask=jnp.asarray(ym))
    got = TK.advect_fused_batched(
        *(torch.tensor(np.array(a)) for a in (ju, jv, jw)),
        TREF.params_from_numpy(jp, device="cpu"), T=T, dt=DT,
        x_interior_mask=xm, y_interior_mask=ym)
    assert max_diff(got, want) <= 1e-5


@needs_unblocked
@pytest.mark.parametrize("leaf", LEAVES)
def test_fused_batched_one_per_slot_leaf_matches_jax(leaf):
    B, T, slots, _, xm, ym = _batched_case()
    _, jp = _one_leaf_per_slot(JREF.default_params(8), leaf,
                               np.array([1.0, 1.5, 0.5], np.float32))
    ju, jv, jw = (jnp.stack([jnp.asarray(sl[i]) for sl in slots])
                  for i in range(3))
    want = JK.advect_fused_batched(ju, jv, jw, jp, T=T, dt=DT,
                                   x_interior_mask=jnp.asarray(xm),
                                   y_interior_mask=jnp.asarray(ym))
    got = TK.advect_fused_batched(
        *(torch.tensor(np.array(a)) for a in (ju, jv, jw)), tparams(jp),
        T=T, dt=DT, x_interior_mask=xm, y_interior_mask=ym)
    assert max_diff(got, want) <= 1e-5


def _poisoned(shape, seed):
    fields = np_fields(shape, seed=seed)
    fields[0][2, 3, 5] = np.nan
    fields[2][5, 0, 0] = np.inf
    fields[1][-1, -1, -1] = -np.inf
    return fields


def test_guard_flags_match_jax_finite_guard():
    shape = (8, 6, 10)
    fields = _poisoned(shape, seed=5)
    want = np.asarray(JK.finite_guard(*(jnp.asarray(f) for f in fields),
                                      interpret=True))
    got = TK.finite_guard(*tfields(fields))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0]


def test_guard_flags_batched_match_jax_per_slot():
    shape = (8, 6, 10)
    slots = [np_fields(shape, seed=6), _poisoned(shape, seed=7)]
    stacked = [torch.stack([torch.as_tensor(sl[i]) for sl in slots])
               for i in range(3)]
    got = TK.finite_guard(*stacked)
    assert got.shape == (2, shape[0])
    for b, sl in enumerate(slots):
        want = np.asarray(JK.finite_guard(*(jnp.asarray(f) for f in sl),
                                          interpret=True))
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_guarded_outputs_equal_unguarded():
    shape = (6, 10, 12)
    fields = np_fields(shape, seed=9)
    p = tparams(JREF.default_params(12))
    plain = TK.advect_fused(*tfields(fields), p, T=2, dt=DT)
    gu, gv, gw, flags = TK.advect_fused(*tfields(fields), p, T=2, dt=DT,
                                        guard=True)
    assert bitwise((gu, gv, gw), plain)
    assert flags.tolist() == [1.0] * shape[0]


@pytest.mark.parametrize("Y,y_tile", [(10, None), (10, 3), (17, 5), (17, 7),
                                      (17, 64), (1024, 16), (1024, 17)])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_tile_geometry_matches_jax(Y, y_tile, T):
    geo = TK._grid_geometry(Y, y_tile, T)
    assert geo == JK._grid_geometry(Y, y_tile, T)
    TY, S, n_ty = geo
    for t in range(n_ty):
        assert TK._slab_lo(t, Y, TY, S, T) == int(JK._slab_lo(t, Y, TY, S, T))
        assert TK._out_lo(t, Y, TY) == int(JK._out_lo(t, Y, TY))
        assert TK._own_start(t, Y, TY, S, T) == int(
            JK._own_start(t, Y, TY, S, T))
        # the CUDA kernel's owned rows keep >= T rows of margin to any
        # slab edge that is not a domain edge
        lo = TK._slab_lo(t, Y, TY, S, T)
        own_lo, own_hi = t * TY, min((t + 1) * TY, Y)
        assert lo == 0 or own_lo - lo >= T
        assert lo + S == Y or lo + S - own_hi >= T


def test_fused_contract_errors():
    u, v, w = tfields(np_fields((4, 8, 8)))
    p = tparams(JREF.default_params(8))
    with pytest.raises(ValueError):
        TK.advect_fused(u, v, w, p, T=0)
    with pytest.raises(ValueError):
        TK.advect_fused(u, v, w, p, T=2, x_interior_mask=np.ones(5))
    with pytest.raises(ValueError):
        TK.advect_fused(u, v, w, p, T=2, y_interior_mask=np.ones(9))
    with pytest.raises(ValueError):
        TK.advect_fused(u[None], v[None], w[None], p, T=2)
    with pytest.raises(ValueError, match="slot-stacked"):
        TK.advect_fused_batched(u, v, w, p, T=2)
    with pytest.raises(ValueError):
        TK.advect_fused(u, v, w[:, :4].contiguous(), p, T=2)
    with pytest.raises(ValueError):
        TK.advect_fused(u, v, w, p, T=2, tiling="rows")
    with pytest.raises(ValueError):
        TK.advect_fused(u, v, w, p, T=2, y_tile=0)
    with pytest.raises(ValueError, match="grid-tiled"):
        TK.advect_fused(u, v, w, p, T=2, y_tile=4, tiling="host",
                        y_interior_mask=np.ones(8))
    with pytest.raises(ValueError, match="grid-tiled"):
        TK.advect_fused_batched(u[None], v[None], w[None], p, T=2, y_tile=4,
                                tiling="host")
    assert bitwise(TK.advect_fused(u, v, w, p, T=2, y_tile=4, tiling="host"),
                   TK.advect_fused(u, v, w, p, T=2))
    with pytest.raises(TypeError, match="float32"):
        TK.advect_fused(u.double(), v.double(), w.double(), p, T=2)
    with pytest.raises(ValueError, match="contiguous"):
        TK.advect_fused(u.transpose(1, 2), v.transpose(1, 2),
                        w.transpose(1, 2), p, T=2)
    with pytest.raises(ValueError, match="tzc1"):
        TK.advect_fused_batched(u[None], v[None], w[None],
                                p._replace(tzc1=torch.ones(2, 8)), T=2)
    with pytest.raises(ValueError):
        TK.finite_guard(u[0], v[0], w[0])


class _ReachedTheBuild(Exception):
    pass


def test_cuda_ring_budget_is_checked_before_any_build(monkeypatch):
    """K1's checks come before any build. A given tile whose shared planes
    exceed one block's budget even in the narrowest z window (Y = 1024
    untiled at T = 4, Z = 64: 884,816 B), one whose slab needs more threads
    than K1's builds run (y_tile 255: 263 rows, over 256 even at one thread
    a row) and a deep T whose pass of depth 8 at y_tile 230 needs more
    shared memory than one block has are no longer refused: each runs as
    the fewest equal sub-tiles that a build takes, so each call gets past
    the checks to the build. Slots beyond the grid's y limit are refused,
    naming the limit. Without a tile K1 plans one that fits, and T beyond
    the build runs as passes, so neither None nor T = 9 is refused."""
    def reached_the_build(*args, **kwargs):
        raise _ReachedTheBuild

    monkeypatch.setattr(_build, "load", reached_the_build)
    u, v, w = (torch.zeros((1, 3, 1024, 64)) for _ in range(3))
    p = TK._slot_params(TREF.default_params(64, device="cpu"), 1, 64, "cpu")
    ones = torch.ones(3), torch.ones(1024)
    for T, y_tile in ((4, 1024), (4, 255), (16, 230)):
        with pytest.raises(_ReachedTheBuild):
            TK._advect_fused_cuda(u, v, w, p, T, DT, *ones, y_tile)
    many = [f.expand(65536, 3, 1024, 64) for f in (u, v, w)]
    with pytest.raises(ValueError, match="65535"):
        TK._advect_fused_cuda(*many, p, 4, DT, *ones, None)
    assert TK.fused_launch_plan(3, 1024, 64, 4, 1, 132, 1).shared_bytes \
        <= 232448
    assert TK.fused_passes(9) == [5, 4]


def test_cuda_guard_grid_is_checked_before_any_build():
    """K4's (X, B) grid: slots beyond 65535 or slices beyond 2**31 - 1
    are refused, naming the limit, before any build."""
    one = torch.zeros((1, 1, 2, 2))
    for shape, limit in (((65536, 3, 2, 2), "65535"),
                         ((1, 2 ** 31, 2, 2), "2147483647")):
        f = one.expand(*shape)
        with pytest.raises(ValueError, match=limit):
            TK._finite_guard_cuda(f, f, f)


def test_largest_fitting_y_tile():
    assert TK.largest_fitting_y_tile(4, 1024, 64) == 16
    assert TK.fused_register_bytes(4, 1024, 64, 4, y_tile=16) == 221184
    assert TK.fused_register_bytes(4, 1024, 64, 4, y_tile=17) == 230400
    assert TK.fused_register_bytes(4, 1024, 64, 4, y_tile=18) > 232448
    assert TK.largest_fitting_y_tile(4, 1021, 64) == 17    # 1021 is prime
    assert TK.largest_fitting_y_tile(2, 12, 10) is None    # whole Y fits
    with pytest.raises(ValueError, match="no y_tile fits"):
        TK.largest_fitting_y_tile(7, 1024, 64)
