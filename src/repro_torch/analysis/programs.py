"""The port's programs the analysis passes audit, each with the claims its
analytic models make of its movement ledger.

A `Program` builds a fresh instance of one of the port's paths on a device
(`build(device) -> (fn, args)`: state, inputs and the callable, built on
the CPU and moved with `.to`, so that the same builder serves a live run
on the card and a fake trace of the CUDA route, where the inputs are fake
CUDA tensors and no card is touched) and prices what it moves
(`claims`: {ledger category: exact bytes}). A distributed program's claims
are per shard and per block (`per_block`), as the reference's trace-once
counters are. `scripts/torch_lint_movement.py` runs them small on fake
tensors, `chip_smoke.py`'s phases 32-34 at the paper's sizes on the card,
and the tests at probe sizes.

The programs: `advance` (`AdvectionDomain.advance` on K1, then K4 over the
result: the main path; `advance_bf16` on a bf16 domain), `grid_tiled` (K1
at a given y_tile), `ladder` (K3, K2 and K2 wide, f32 or bf16; linted, not
priced: the blocked rung re-reads its slices inside the kernel), `distributed` (a (2, 2) loopback
`make_distributed_run`: K1 with either exchange, K6 with the collective
one, verified or not), `serving` (the stencil serving engine's mega-step,
K5 then K4 over B slots; `serving_bf16` on bf16 slots), `spec_path` (K6, one call per shipped operator x
integrator pair), `attention` (K8) and `scan` (K9).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.analysis import trace as TR
from repro_torch.core import roofline as R
from repro_torch.kernels import library as L
from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.advection import ref as REF
from repro_torch.kernels.attention import attention as A
from repro_torch.kernels.ssm import ssm as SS

__all__ = ["Program", "place", "advance_program", "grid_tiled_program",
           "ladder_program", "distributed_program", "serving_program",
           "spec_path_program", "attention_program", "scan_program",
           "SPEC_PAIRS"]

# the spec path's operator x integrator pairs and their depths
SPEC_PAIRS = (("pw", "euler", 4), ("pw", "rk2", 2), ("tracer", "euler", 4),
              ("tracer", "rk2", 2), ("diffusion", "euler", 4),
              ("diffusion", "rk2", 2))


class Program(NamedTuple):
    """One audited program: `build(device) -> (fn, args)`, the claims of
    its models, whether they are per shard and block (`n_shards` shards),
    and the kernel ops it launches with their counts."""
    name: str
    build: Callable
    claims: Dict[str, int]
    per_block: bool = False
    n_shards: int = 1
    launches: Optional[Dict[str, int]] = None


def place(tree, device):
    """`tree`'s tensors (in tuples, lists and NamedTuples) moved to
    `device`: a live copy, or inside `analysis.trace.fake_mode` a fake
    tensor on that device."""
    if isinstance(tree, torch.Tensor):
        if TR._ACTIVE and not L.is_fake(tree):
            tree = TR._ACTIVE[-1].from_tensor(tree)
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(t, device) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(place(t, device) for t in tree)
    return tree


def _fields(shape, n: int = 3, seed: int = 0, dtype=torch.float32):
    """`n` fields of `dtype` on the CPU: normal draws from `seed`, or in a
    trace (whose values are never read) fake tensors."""
    if TR._ACTIVE:
        return tuple(torch.empty(shape, dtype=dtype) for _ in range(n))
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype) for _ in range(n))


def _fused_hbm(X, Y, Z, T, n_fields=3, itemsize=4):
    return K.hbm_bytes_model(X, Y, Z, itemsize, "fused", T=T,
                             n_fields=n_fields)


def _tag(dtype) -> str:
    """A program name's dtype suffix: none for f32, "_bf16" for bf16."""
    return "" if dtype == torch.float32 else "_bf16"


# ---- the single-card paths ---------------------------------------------

def advance_program(X: int, Y: int, Z: int, *, T: int = 4,
                    n_substeps: int = 16, dt: float = 0.01,
                    dtype=torch.float32) -> Program:
    """`AdvectionDomain(variant="fused", fuse_T=T, dtype=...)
    .advance(n_substeps)`, then `finite_guard` over the result (f32 or
    bf16 fields and coefficients: "advance" or "advance_bf16")."""
    from repro_torch.stencil.advection import AdvectionDomain
    passes = n_substeps // T
    item = K._itemsize(dtype)

    def build(device):
        dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=T, dt=dt,
                              device="cpu", dtype=str(dtype).split(".")[-1])
        object.__setattr__(dom, "device", device)
        object.__setattr__(dom, "params", place(dom.params, device))
        fields = place(_fields((X, Y, Z), dtype=dtype), device)

        def fn(u, v, w):
            out = dom.advance(u, v, w, n_substeps)
            return out, K.finite_guard(*out)
        return fn, fields

    parts = R.guard_bytes_model_parts(X, Y, Z, itemsize=item)
    return Program("advance" + _tag(dtype), build, {
        "pallas_hbm": passes * _fused_hbm(X, Y, Z, T, itemsize=item),
        "guard_field_reads": parts["field_reads"],
        "guard_flag_words": parts["flag_words"]},
        launches={"advect_fused": passes * len(K.fused_passes(T)),
                  "finite_guard": 1})


def grid_tiled_program(X: int, Y: int, Z: int, *, T: int = 4,
                       y_tile: int = 8, dt: float = 0.01) -> Program:
    """One K1 pass at a given in-grid y_tile."""
    def build(device):
        p = place(REF.default_params(Z, device="cpu"), device)

        def fn(u, v, w):
            return K.advect_fused(u, v, w, p, T=T, dt=dt, y_tile=y_tile)
        return fn, place(_fields((X, Y, Z)), device)

    passes = len(K.fused_passes(T))
    return Program("grid_tiled", build,
                   {"pallas_hbm": passes * _fused_hbm(X, Y, Z, T)},
                   launches={"advect_fused": passes})


def ladder_program(X: int, Y: int, Z: int, *, dt: float = 0.01,
                   dtype=torch.float32) -> Program:
    """K3, K2 and K2 `wide`, one Euler step each (`fuse_update`), on fields
    and coefficients of `dtype`: linted, not priced (no claims)."""
    def build(device):
        p = place(REF.default_params(Z, dtype=dtype, device="cpu"), device)

        def fn(u, v, w):
            return tuple(rung(u, v, w, p, fuse_update=True, dt=dt)
                         for rung in (K.advect_blocked, K.advect_dataflow,
                                      K.advect_wide))
        return fn, place(_fields((X, Y, Z), dtype=dtype), device)

    return Program("ladder" + _tag(dtype), build, {},
                   launches={"advect_blocked": 1, "advect_dataflow": 1,
                             "advect_wide": 1})


def serving_program(X: int, Y: int, Z: int, *, B: int = 4, T: int = 4,
                    dt: float = 0.01, dtype=torch.float32) -> Program:
    """One mega-step of `StencilServingEngine`, the engine `serve.py
    --stencil` runs: an engine of B (X, Y, Z) slots at depth T with a
    request admitted to each slot, and the step its launcher cache builds
    (`_build_step`: K5 with per-slot parameters and masks, then K4's
    flags), called on the engine's slot buffers as `_mega_step` calls it.
    That step is the counterpart of the reference's jitted mega-step;
    `_mega_step`'s host side (reading the flags back, the slot
    bookkeeping) is not recorded. A fake trace reads no values, so there
    the slots stay empty: the step's ops do not depend on them. `dtype`:
    the engine domain's (its slots and coefficients)."""
    from repro_torch.serving.stencil_engine import (StencilRequest,
                                                    StencilServingEngine)
    from repro_torch.stencil.advection import AdvectionDomain
    item = K._itemsize(dtype)

    def build(device):
        dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=T, dt=dt,
                              device="cpu", dtype=str(dtype).split(".")[-1])
        object.__setattr__(dom, "device", device)
        object.__setattr__(dom, "params", place(dom.params, device))
        engine = StencilServingEngine(dom, batch_size=B)
        if not TR._ACTIVE:
            for slot in range(B):
                u, v, w = _fields((X, Y, Z), seed=slot, dtype=dtype)
                engine._prime(slot, StencilRequest(slot, u, v, w, n_steps=1))
        step = engine.cache.get(engine._step_key(), engine._build_step)

        def fn():
            return step(engine.u, engine.v, engine.w,
                        REF.AdvectParams(*engine._p), engine.xm, engine.ym)
        return fn, ()

    parts = R.guard_bytes_model_parts(X, Y, Z, batch=B, itemsize=item)
    return Program("serving" + _tag(dtype), build, {
        "pallas_hbm": B * len(K.fused_passes(T)) * _fused_hbm(
            X, Y, Z, T, itemsize=item),
        "guard_field_reads": parts["field_reads"],
        "guard_flag_words": parts["flag_words"]},
        launches={"advect_fused": len(K.fused_passes(T)),
                  "finite_guard": 1})


def _spec(op: str, integrator: str):
    from repro_torch.stencil import spec as SP
    return {"pw": SP.pw_advection_spec, "tracer": SP.tracer_advection_spec,
            "diffusion": SP.diffusion_spec}[op](integrator)


def _spec_inputs(op: str, shape, seed: int = 0):
    """(params, fields) of one operator on the CPU."""
    from repro_torch.stencil import spec as SP
    Z = shape[2]
    if op == "diffusion":
        phi = _fields(shape, 1, seed)[0] + 300.0
        return SP.default_diffusion_params(Z, device="cpu"), (phi,)
    n = 4 if op == "tracer" else 3
    return REF.default_params(Z, device="cpu"), _fields(shape, n, seed)


def spec_path_program(X: int, Y: int, Z: int, *, pairs=SPEC_PAIRS,
                      dt: float = 0.01) -> Program:
    """K6 (`stencil_fused`): one call per operator x integrator pair, each
    at its depth, on K6's own plan."""
    hbm, launches = 0, 0
    for op, integrator, T in pairs:
        spec = _spec(op, integrator)
        passes = K.spec_passes(spec, T)
        hbm += len(passes) * K.hbm_bytes_model(
            X, Y, Z, 4, "fused", T=T, n_fields=spec.n_fields)
        launches += len(passes)

    def build(device):
        calls = []
        for op, integrator, T in pairs:
            params, fields = _spec_inputs(op, (X, Y, Z))
            calls.append((_spec(op, integrator), place(params, device),
                          place(fields, device), T))

        def fn():
            return [K.stencil_fused(f, p, spec, T=T, dt=dt)
                    for spec, p, f, T in calls]
        return fn, ()

    return Program("spec_path", build, {"pallas_hbm": hbm},
                   launches={"stencil_fused": launches})


def attention_program(B: int, H: int, Hkv: int, S: int, D: int, *,
                      dtype=torch.bfloat16) -> Program:
    """One causal K8 call on (B, H, S, D) q and (B, Hkv, S, D) k, v."""
    def build(device):
        q, k, v = (_fields((B, h, S, D), 1, seed)[0].to(dtype)
                   for seed, h in enumerate((H, Hkv, Hkv)))
        return (lambda q, k, v: A.flash_attention(q, k, v, causal=True),
                place((q, k, v), device))

    itemsize = torch.empty((), dtype=dtype).element_size()
    return Program("attention", build, {
        "pallas_hbm": A.hbm_bytes_model(B, H, Hkv, S, S, D, itemsize)},
        launches={"flash_attention": 1})


def scan_program(B: int, S: int, D: int, N: int = 16, *,
                 dtype=torch.bfloat16) -> Program:
    """One K9 call: x, dt, B, C in `dtype`, A and h0 in f32."""
    def build(device):
        xc, dt = (f.to(dtype) for f in _fields((B, S, D), 2))
        dt = (0.1 * dt.abs()).to(dtype)
        Bm, Cm = (f.to(dtype) for f in _fields((B, S, N), 2, seed=1))
        Am = -_fields((D, N), 1, seed=2)[0].abs() - 0.5
        h0 = torch.zeros((B, D, N))
        return SS.selective_scan, place((xc, dt, Bm, Cm, Am, h0), device)

    itemsize = torch.empty((), dtype=dtype).element_size()
    return Program("scan", build, {
        "pallas_hbm": SS.hbm_bytes_model(B, S, D, N, itemsize, itemsize)},
        launches={"selective_scan": 1})


# ---- the distributed path ----------------------------------------------

def distributed_program(X: int, Y: int, Z: int, *, exchange: str,
                        T: int = 4, n_blocks: int = 4, mesh=(2, 2),
                        verify: bool = False, spec: Optional[str] = None,
                        overlap: bool = False,
                        dt: float = 0.01) -> Program:
    """`make_distributed_run(n_blocks=...)` on a loopback mesh of `mesh`
    shards of the (X, Y, Z) grid with `local_kernel="fused"`: K1 (or K6
    for the spec operator `spec`, an ``"op/integrator"`` name) and either
    exchange engine, `verify` riding checksum words. Its claims are per
    shard and per block."""
    from repro_torch.launch.mesh import make_stencil_mesh
    from repro_torch.stencil import distributed as D
    nx, ny = mesh
    sp = None if spec is None else _spec(*spec.split("/"))
    n_fields = 3 if sp is None else sp.n_fields
    depth = T if sp is None else sp.halo(T)
    Xl, Yl = X // nx, Y // ny
    ext = (Xl + (2 * depth if nx > 1 else 0),
           Yl + (2 * depth if ny > 1 else 0))
    passes = K.fused_passes(T) if sp is None else K.spec_passes(sp, T)
    kw = dict(nx=nx, ny=ny, T=T, n_fields=n_fields, depth=depth)
    hbm = sum(K.hbm_bytes_model(*ext, Z, 4, "fused", T=Tk,
                                n_fields=n_fields) for Tk in passes)
    if overlap:
        hbm += sum(K.hbm_bytes_model(Xl, Yl, Z, 4, "fused", T=Tk,
                                     n_fields=n_fields) for Tk in passes)
    if exchange == "remote_dma":
        hbm += R.band_slab_bytes_model(X, Y, Z, 4, **kw)
    claims = {"ppermute_wire": R.halo_wire_bytes_model(X, Y, Z, 4, **kw),
              "pallas_hbm": hbm}
    if verify:
        claims["integrity_words"] = R.integrity_bytes_model(X, Y, Z, **kw)
    n = nx * ny
    calls = len(passes) * (2 if overlap else 1)
    launches = {("advect_fused" if sp is None else "stencil_fused"):
                n * n_blocks * calls}
    if exchange == "remote_dma":
        launches["band_exchange"] = n_blocks * ((nx > 1) + (ny > 1))

    def build(device):
        m = make_stencil_mesh(nx, ny, devices=[device] * n)
        if sp is None:
            p, fields = REF.default_params(Z, device="cpu"), _fields((X, Y, Z))
            kw_run = {}
        else:
            p, fields = _spec_inputs(spec.split("/")[0], (X, Y, Z))
            kw_run = dict(spec=sp, spec_params=place(p, device))
        run = D.make_distributed_run(
            m, place(p, device), n_blocks=n_blocks, T=T, dt=dt,
            local_kernel="fused", exchange=exchange, overlap=overlap,
            verify_integrity=verify, **kw_run)
        return run, (D.shard(m, *place(fields, device)),)

    name = (f"distributed_{exchange}" + ("" if sp is None else f"_{spec}")
            + ("_verified" if verify else ""))
    return Program(name, build, claims, per_block=True, n_shards=n,
                   launches=launches)


def shapes(small: bool) -> Dict[str, Tuple]:
    """The programs' grids: the paper's (chip) or probe sizes (CPU)."""
    if small:
        return {"grid": (8, 16, 32), "dist": (16, 16, 32),
                "serve": (8, 16, 32), "attn": (1, 4, 2, 128, 64),
                "scan": (1, 32, 64)}
    return {"grid": (1024, 1024, 64), "dist": (1024, 1024, 64),
            "serve": (512, 512, 64), "attn": (1, 40, 8, 2048, 128),
            "scan": (1, 2048, 8192)}


def programs(small: bool = True) -> Tuple[Program, ...]:
    """Every priced program, at probe sizes or the paper's."""
    s = shapes(small)
    X, Y, Z = s["grid"]
    Xd, Yd, Zd = s["dist"]
    out = [advance_program(X, Y, Z),
           advance_program(X, Y, Z, dtype=torch.bfloat16),
           grid_tiled_program(X, Y, Z, y_tile=4 if small else 64),
           serving_program(*s["serve"], B=4),
           serving_program(*s["serve"], B=4, dtype=torch.bfloat16),
           spec_path_program(X, Y, Z)]
    for exchange in ("collective", "remote_dma"):
        out.append(distributed_program(Xd, Yd, Zd, exchange=exchange))
    out.append(distributed_program(Xd, Yd, Zd, exchange="collective",
                                   verify=True))
    out.append(distributed_program(Xd, Yd, Zd, exchange="collective",
                                   spec="pw/euler", verify=True, n_blocks=2))
    out.append(attention_program(*s["attn"]))
    out.append(scan_program(*s["scan"]))
    return tuple(out)

