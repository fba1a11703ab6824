"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors
(the port of `repro.launch.dryrun`).

The reference lowers and compiles each cell with XLA on 512 forced host
devices. The port traces it instead: one process plays rank 0 of a world
of 256 (16 x 16) or 512 (2 x 16 x 16) under a `"fake"` process group, over
`launch.mesh.make_production_mesh`. The state, parameters, caches and batch
are DTensors whose local blocks are fake tensors, each rank's block of the
logical-axis rules (`pspec.param_shardings`), so no memory is allocated and
no card is needed. `trace_cell` runs the step (`make_train_step`,
`make_prefill_step` or `make_serve_step`) once under `FakeTensorMode`
through `core.profiler.trace_cost`, which sees each rank's local ops and
the collectives DTensor's redistributions dispatch. For each cell this
gives:

  * proof of shardability: the sharded step traces on the production mesh;
  * memory (`mem_record`): the rank's argument, output and aliased bytes,
    and the peak of its live bytes (`resident_bytes_per_dev`), against the
    card's 80 GB (`fits_80g`);
  * roofline terms from differential costing, as the reference: traces at
    1 and 2 layer units (`_cost_cfg`), and a `skip_core` pair that
    attributes FLOPs and bytes to the S^2 and scan cores. The port has no
    layer scan, so the costing configs differ from the full one only by
    `exec_policy(for_cost=True)`.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod-only|--singlepod-only]
  python -m repro_torch.launch.dryrun --all --skip-cost   # shardability only
Writes JSON records under experiments/dryrun_torch/ (`launch.report`
renders them). A fake trace, not a measurement: the FLOPs are
`FlopCounterMode`'s formulas, the bytes the dispatched ops' operands and
results (`core.profiler`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch import pspec
from repro_torch.analysis import trace as TR
from repro_torch.config import ALL_SHAPES, SHAPES, ArchConfig, RunShape, \
    supports
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import hlo as H
from repro_torch.core import profiler as P
from repro_torch.core import roofline as R
from repro_torch.distributed.sharding import (local_block, make_rules,
                                              sharding_for)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, tp_degree
from repro_torch.models import model as M
from repro_torch.training import step as TS

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
# the fake group's mesh and fake tensors live on the CPU: autograd refuses
# CUDA tensors, fake or not, in a build without CUDA. A CPU mesh would move
# shards with an all-gather and a chunk where the cards' NCCL group runs an
# all-to-all, so the fake group routes that move to the cards' op
# (`analysis.trace.dtensor_internals(card_alltoall=True)`)
MESH_DEVICE = "cpu"


def _divisor_near(n: int, target: int) -> int:
    best = 1
    for d in range(1, n + 1):
        if n % d == 0 and abs(d - target) < abs(best - target):
            best = d
    return best


def exec_policy(cfg: ArchConfig, shape: RunShape, *, for_cost: bool = False,
                overrides: dict | None = None) -> ArchConfig:
    """Execution knobs for the production dry run (the reference's)."""
    kw: dict = {}
    uniform = len(set(M.layer_kinds(cfg))) <= 1 and cfg.family != "encdec"
    if shape.kind == "train":
        kw["remat"] = "full"
        kw["seq_parallel"] = True
        if cfg.scan_layers and uniform:
            kw["scan_group"] = _divisor_near(cfg.n_layers,
                                             int(math.sqrt(cfg.n_layers)) + 2)
        elif not uniform:
            kw["scan_group"] = 3  # enables pattern-grouped scan (hybrid/moe)
    else:
        kw["remat"] = "none"
        kw["seq_parallel"] = shape.kind == "prefill"
    kw["attention_impl"] = "chunked"
    if for_cost:
        kw["scan_layers"] = False
        kw["scan_group"] = 0
        kw["attention_impl"] = "dense"  # exact-FLOP logits (chunked == dense math)
    if overrides:
        kw.update(overrides)
    if "expert_fsdp" in kw:  # nested MoE knob
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, expert_fsdp=bool(kw.pop("expert_fsdp"))))
    return cfg.replace(**kw)


def _cost_cfg(cfg: ArchConfig, n: int) -> ArchConfig:
    """Reduced-layer config for differential costing (n pattern-groups)."""
    if cfg.family == "encdec":
        e = dataclasses.replace(cfg.encdec, enc_layers=n, dec_layers=n)
        return cfg.replace(encdec=e)
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=3 * n)  # n pattern-groups of (rec,rec,attn)
    if cfg.family == "moe" and cfg.moe.moe_every > 1:
        return cfg.replace(n_layers=cfg.moe.moe_every * n)
    return cfg.replace(n_layers=n)


def _layer_multiplier(cfg: ArchConfig) -> float:
    """How many differential units the full config has."""
    if cfg.family == "encdec":
        return float(cfg.encdec.enc_layers)  # enc+dec pairs (equal counts)
    if cfg.family == "hybrid":
        return cfg.n_layers / 3.0
    if cfg.family == "moe" and cfg.moe.moe_every > 1:
        return cfg.n_layers / cfg.moe.moe_every
    return float(cfg.n_layers)


# ---------------------------------------------------------------------------
# the fake group and the fake DTensors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world: int):
    """A `"fake"` process group of `world` ranks, this process rank 0, for
    the duration: created when no group exists, with DTensor's internals
    patched for the trace (`analysis.trace.dtensor_internals`, the
    shard-to-shard move as the cards' all-to-all), and destroyed
    afterwards; an existing group of that world is used as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks exists; the dry run needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        with TR.dtensor_internals(card_alltoall=True):
            yield
    finally:
        dist.destroy_process_group()


def mesh_world(multi_pod: bool) -> int:
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    return math.prod(PRODUCTION_SHAPES[multi_pod][0])


def _local_dtensor(shape, dtype: torch.dtype, sharding):
    """A DTensor of global `shape` placed by `sharding` whose local block
    (this rank's) is a fresh tensor of the active fake mode."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    blk = local_block(shape, sharding.spec, mesh, mesh.get_coordinate())
    local = torch.empty(tuple(b.stop - b.start for b in blk), dtype=dtype,
                        device=MESH_DEVICE)
    stride = []
    acc = 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def fake_tree(specs, rules, mesh):
    """A ParamSpec tree as fake DTensors placed by the rules."""
    return pspec.tree_map(
        lambda s: _local_dtensor(s.shape, pspec.torch_dtype(s.dtype),
                                 sharding_for(s.shape, s.axes, rules, mesh)),
        specs)


def fake_batch(cfg: ArchConfig, shape: RunShape, rules, mesh):
    """The cell's inputs (`specs.input_specs`) as fake DTensors split over
    the batch rule, as the steps' `place_batch` splits them."""
    specs, _ = SP.input_specs(cfg, shape)
    return {k: _local_dtensor(s.shape, s.torch_dtype, sharding_for(
        s.shape, ("batch",) + (None,) * (len(s.shape) - 1), rules, mesh))
        for k, s in specs.items()}


def build_cell(cfg: ArchConfig, shape: RunShape, mesh):
    """(step, args, aliased): the cell's step, its fake arguments, and the
    argument trees it updates in place (the train state, the decode
    caches). Call inside a fake mode (`analysis.trace.fake_mode`)."""
    tp = tp_degree(mesh)
    multi = "pod" in mesh.mesh_dim_names
    layout = M.make_layout(cfg, tp)
    rules = make_rules(multi_pod=multi, shape_kind=shape.kind,
                       seq_parallel=cfg.seq_parallel)
    batch = fake_batch(cfg, shape, rules, mesh)
    if shape.kind == "train":
        state = fake_tree(TS.state_specs(cfg, layout), rules, mesh)
        fn = TS.make_train_step(cfg, layout, rules, mesh)
        return fn, (state, batch), (state,)
    params = fake_tree(M.param_specs(cfg, layout), rules, mesh)
    if shape.kind == "prefill":
        fn = TS.make_prefill_step(cfg, layout, rules, mesh)
        return fn, (params, batch), ()
    caches = fake_tree(SP.decode_cache_abstract(cfg, layout, shape), rules,
                       mesh)
    fn = TS.make_serve_step(cfg, layout, rules, mesh)
    return fn, (params, caches, batch), (caches,)


def _local_bytes(tree) -> int:
    seen, n = set(), 0
    for t in P.local_tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def trace_cell(cfg: ArchConfig, shape: RunShape, mesh) -> dict:
    """Trace the cell's step once on fake tensors: {"trace": the
    `profiler.Trace` (records, FLOPs, bytes, peak live bytes), "memory":
    `mem_record`'s dict}. Replaces the reference's `lower_compile`."""
    with TR.fake_mode():
        fn, args, aliased = build_cell(cfg, shape, mesh)
        tr = P.trace_cost(fn, *args)
        mem = mem_record(tr, aliased)
    return {"trace": tr, "memory": mem}


def mem_record(tr: "P.Trace", aliased=()) -> dict:
    """The reference's memory keys from a trace: the rank's argument bytes
    (state, parameters, caches and batch), output bytes, aliased bytes
    (what the step updates in place and returns), temp bytes (the peak of
    the live bytes less the arguments) and `resident_bytes_per_dev`, the
    peak itself (arguments, temporaries and the outputs alive at the end).
    `fits_80g` reads it against the card's `R.HBM_PER_CHIP`."""
    args_b = tr.args_bytes
    out_b = _local_bytes(tr.output)
    alias_b = _local_bytes(aliased)
    rec = {"argument_size_in_bytes": args_b,
           "output_size_in_bytes": out_b,
           "temp_size_in_bytes": max(tr.peak_bytes - args_b, 0),
           "alias_size_in_bytes": alias_b,
           "generated_code_size_in_bytes": None,
           "resident_bytes_per_dev": tr.peak_bytes}
    rec["fits_80g"] = rec["resident_bytes_per_dev"] <= R.HBM_PER_CHIP
    return rec


def _pod_size(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sizes.get("data", 16) * sizes.get("model", 16)


def _costs(tr: "P.Trace", pod: int) -> dict:
    ops = H.parse_collectives(tr.records, pod_size=pod)
    return {"flops": tr.flops, "bytes": tr.bytes,
            "pod": H.total_wire_bytes(ops, "pod"),
            "cross_pod": H.total_wire_bytes(ops, "cross_pod"),
            "census": H.op_census(tr.records)}


def _one_cost_trace(cfg, shape, mesh, pod) -> dict:
    return _costs(trace_cell(cfg, shape, mesh)["trace"], pod)


COST_KEYS = ("flops", "bytes", "pod", "cross_pod")


def cost_record(cfg, shape, mesh, *, attribute_core: bool = True,
                overrides=None) -> dict:
    """Differential costing: 1-unit and 2-unit traces, plus a skip-core
    pair that attributes bytes and FLOPs to the S^2 and scan cores (the
    paper's profiler-block method applied to the dispatched ops)."""
    pod = _pod_size(mesh)
    recs, skips = {}, {}
    for n in (1, 2):
        c = exec_policy(_cost_cfg(cfg, n), shape, for_cost=True,
                        overrides=overrides)
        recs[n] = _one_cost_trace(c, shape, mesh, pod)
        if attribute_core:
            cs = c.replace(attention_impl="skip_core")
            skips[n] = _one_cost_trace(cs, shape, mesh, pod)
    mult = _layer_multiplier(cfg)
    out = {}
    for key in COST_KEYS:
        out[key] = R.differential(recs[1], recs[2], mult, key)
    out["per_layer"] = {k: recs[2][k] - recs[1][k] for k in COST_KEYS}
    out["const"] = {k: max(recs[1][k] - out["per_layer"][k], 0.0)
                    for k in COST_KEYS}
    out["census_2l"] = recs[2]["census"]
    if skips:
        out["core"] = {}
        for key in ("flops", "bytes"):
            total_skip = R.differential(skips[1], skips[2], mult, key)
            out["core"][key] = max(out[key] - total_skip, 0.0)
            out["core"][f"{key}_rest"] = total_skip
    return out


def roofline_terms(cfg0: ArchConfig, shape: RunShape, cost: dict,
                   n_chips: int) -> R.RooflineTerms:
    """The cell's roofline on the card: the bf16 tensor-core peak for the
    bf16 models (f32's otherwise), within-pod wire bytes over NVLink and
    cross-pod bytes over `R.CROSS_POD_BW` (an assumption)."""
    peak = (R.PEAK_FLOPS_BF16 if cfg0.compute_dtype == "bfloat16"
            else R.PEAK_FLOPS_F32)
    return R.RooflineTerms(
        flops_per_dev=cost["flops"], hbm_bytes_per_dev=cost["bytes"],
        model_flops_global=R.model_flops(cfg0, shape), peak_flops=peak,
        wire_bytes=cost["pod"], wire_bw=R.NVLINK_BW, n_chips=n_chips,
        cross_wire_bytes=cost["cross_pod"])


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             skip_cost: bool = False, overrides=None, tag: str = "",
             get_cfg=get_config, mesh_shape=None,
             shape: RunShape | None = None) -> dict:
    """Trace one cell and return its record. `get_cfg`, `mesh_shape` (a
    (data, model) or (pod, data, model) shape for a smaller fake mesh) and
    `shape` (a `RunShape` in place of `SHAPES[shape_name]`) serve the
    tests; by default the production config, mesh and shape."""
    cfg0 = get_cfg(arch)
    shape = SHAPES[shape_name] if shape is None else shape
    if not supports(cfg0, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k requires sub-quadratic attention"}
    world = (math.prod(mesh_shape) if mesh_shape
             else mesh_world(multi_pod))
    with fake_group(world):
        mesh = _mesh(multi_pod, mesh_shape)
        n_chips = math.prod(mesh.shape)
        cfg = exec_policy(cfg0, shape, overrides=overrides)
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "x".join(str(v) for v in mesh.shape),
               "multi_pod": multi_pod, "n_chips": n_chips, "tag": tag,
               "exec": {"remat": cfg.remat, "scan_group": cfg.scan_group,
                        "seq_parallel": cfg.seq_parallel,
                        "attention_impl": cfg.attention_impl,
                        "param_dtype": cfg.param_dtype,
                        "opt_dtype": cfg.opt_dtype}}
        t0 = time.time()
        cell = trace_cell(cfg, shape, mesh)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["memory"] = cell["memory"]
        pod = _pod_size(mesh)
        records = cell["trace"].records
        rec["census_full"] = H.op_census(records)
        rec["collectives_full_unscaled"] = H.collective_summary(
            H.parse_collectives(records, pod_size=pod))
        del cell, records

        if not skip_cost and not multi_pod:
            cost = cost_record(cfg0, shape, mesh, overrides=overrides)
            terms = roofline_terms(cfg0, shape, cost, n_chips)
            rec["cost"] = cost
            rec["roofline"] = terms.as_dict()
            if "core" in cost:
                layout = M.make_layout(cfg0, tp_degree(mesh))
                mshape = dict(zip(mesh.mesh_dim_names, mesh.shape))
                core_io = R.kernel_core_io_bytes(cfg0, shape, layout, mshape)
                adj_bytes = cost["bytes"] - cost["core"]["bytes"] + core_io
                adj = dataclasses.replace(terms, hbm_bytes_per_dev=adj_bytes)
                rec["core_io_bytes"] = core_io
                rec["roofline_kernel_adjusted"] = adj.as_dict()
                stream_bytes = R.streaming_memory_bytes(
                    cfg, shape,
                    args_bytes_per_dev=rec["memory"]["argument_size_in_bytes"],
                    core_io_bytes=core_io, mesh_shape=mshape)
                stream = dataclasses.replace(terms,
                                             hbm_bytes_per_dev=stream_bytes)
                rec["roofline_streaming"] = stream.as_dict()
    return rec


def _mesh(multi_pod: bool, mesh_shape=None):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device=MESH_DEVICE)
    from torch.distributed.device_mesh import init_device_mesh
    names = (("pod", "data", "model") if len(mesh_shape) == 3
             else ("data", "model"))
    return init_device_mesh(MESH_DEVICE, tuple(mesh_shape),
                            mesh_dim_names=names)


def cell_name(arch: str, shape: str, multi: bool, tag: str) -> str:
    name = f"{arch}__{shape}__{'2x16x16' if multi else '16x16'}"
    return name if tag == "baseline" else f"{name}__{tag}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--singlepod-only", action="store_true")
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--override", action="append", default=[],
                    help="exec override key=value (e.g. param_dtype=bfloat16)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        elif v.isdigit():
            v = int(v)
        overrides[k] = v

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = []
    if not args.multipod_only:
        meshes.append(False)
    if not args.singlepod_only:
        meshes.append(True)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                cell = f"{arch}/{shape}/{'2x16x16' if multi else '16x16'}"
                try:
                    rec = run_cell(arch, shape, multi_pod=multi,
                                   skip_cost=args.skip_cost,
                                   overrides=overrides or None, tag=args.tag)
                    status = ("SKIP" if rec.get("skipped") else
                              f"ok trace={rec.get('trace_s')}s "
                              f"resident={rec.get('memory', {}).get('resident_bytes_per_dev', 0) / 1e9:.2f}GB"
                              + (f" bound={rec['roofline']['bound']}"
                                 if "roofline" in rec else ""))
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append(cell)
                    rec = {"arch": arch, "shape": shape, "multi_pod": multi,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:],
                           "tag": args.tag}
                    status = f"FAIL {type(e).__name__}: {str(e)[:120]}"
                name = cell_name(arch, shape, multi, args.tag)
                (OUT_DIR / f"{name}.json").write_text(json.dumps(rec,
                                                                 indent=1))
                print(f"[dryrun] {cell:60s} {status}", flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells passed")


if __name__ == "__main__":
    main()
