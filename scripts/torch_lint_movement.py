#!/usr/bin/env python
"""Static data-movement lint of the PyTorch port: every registered
analysis pass (`repro_torch.analysis`) driven over the port's programs on
fake CUDA tensors. The port's counterpart of `scripts/lint_movement.py`.

Nothing here runs a kernel or needs a card: each program is traced under
`FakeTensorMode` with its inputs on ``"cuda"`` (`analysis.trace`), every
hand kernel showing as its `repro_torch` op, so the lint runs on a CPU
machine and catches an unpriced byte category, a leaked per-block
rebuild, an over-budget shared-memory plan or a broken alignment or
tiling contract before anything launches.

Row families and their gates (every gate an explicit ``SystemExit``):

  * ``ledger[]``  — the movement ledger of each program
    (`analysis.programs`: fused `advance`, grid-tiled, distributed x
    {collective, remote_dma, K6 local}, verified, spec-driven verified,
    batched serving; the spec path, K8 and K9), with the analytic claims
    (`hbm_bytes_model`, `halo_wire_bytes_model`, `band_slab_bytes_model`,
    `integrity_bytes_model`, `guard_bytes_model_parts`) it is held to,
    per shard and block on the distributed runs. GATE:
    `check_model_coverage` passes (`pallas_control` unpriced) and the
    kernel ops launched are the program's.
  * ``retrace[]`` — the retrace detector over the distributed drivers
    (the block index 2-5 and `n_blocks` must share one block's op stream
    and grow no launch cache; `y_tile` must change it), and the fixture
    pair. GATE: the drivers clean, the red fixture flagged with a "leak",
    the green one clean.
  * ``smem[]``    — the shared-memory plans (`analysis.smem`) of each
    kernel's launch and driver at the paper's sizes. GATE: every shipped
    plan fits, and an oversized plan RAISES `SmemBudgetExceeded` naming
    its largest buffer.
  * ``tiling[]``  — `lint_tiling` over every program and the v1-v3
    ladder (K3, K2, K2 wide; linted, not priced: the blocked rung re-reads
    its slices inside the kernel, which its op's operands do not show).
    GATE: zero errors (warnings are recorded, not fatal).

``--quick`` runs the ledger and tiling families at probe sizes (the full
run also lints the paper's sizes, still on fake tensors); ``--list``
prints the pass registry. Prints one JSON object and writes no file.

    PYTHONPATH=src python scripts/torch_lint_movement.py [--quick|--list]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(_ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(_ROOT, "src"))

import torch  # noqa: E402

from repro_torch import analysis as AN  # noqa: E402
from repro_torch.analysis import programs as PR  # noqa: E402
from repro_torch.analysis import smem as SM  # noqa: E402
from repro_torch.analysis import trace as TR  # noqa: E402
from repro_torch.kernels.advection.ref import default_params  # noqa: E402
from repro_torch.launch.mesh import make_stencil_mesh  # noqa: E402
from repro_torch.stencil import distributed as D  # noqa: E402

DT = 0.01


def _record(prog):
    with TR.fake_mode():
        fn, args = prog.build("cuda")
        return TR.record_ops(fn, *args)


def _ledger_rows(progs):
    rows = []
    for prog in progs:
        records = _record(prog)
        led = AN.MovementLedger.from_ops(records)
        counted = (led.per_shard_block_totals(prog.n_shards)
                   if prog.per_block else led.totals())
        report = AN.check_model_coverage(counted, prog.claims)
        ops = {}
        for r in records:
            if r.op not in (None, "band_send"):
                ops[r.op] = ops.get(r.op, 0) + 1
        rows.append({"program": prog.name, "per_shard_block": prog.per_block,
                     "counted": {c: b for c, b in counted.items() if b},
                     "claims": prog.claims, "ops": ops, "ok": report.ok})
        if not report.ok:
            raise SystemExit(f"ledger[{prog.name}]: model coverage failed:\n"
                             + "\n".join(str(f) for f in report.failures))
        if ops != prog.launches:
            raise SystemExit(f"ledger[{prog.name}]: launched {ops}, the "
                             f"program's kernels are {prog.launches}")
    return rows


def _retrace_rows():
    rows = []
    mesh = make_stencil_mesh(2, 2, devices=["cuda:0"] * 4)
    with TR.fake_mode():
        p = PR.place(default_params(32, device="cpu"), "cuda")
        shards = D.shard(mesh, *PR.place(PR._fields((16, 16, 32)), "cuda"))
        for exchange in D.EXCHANGES:
            block = D._build_block(mesh, p, T=2, dt=DT, local_kernel="fused",
                                   y_tile=None, overlap=False,
                                   exchange=exchange, verify_integrity=False,
                                   corrupt_halo=None, spec=None,
                                   spec_params=None)
            for k in (0, 1):
                block(shards, k)
            reports = [AN.detect_retrace(
                lambda dma_block_index: (
                    (lambda sh: block(sh, dma_block_index)), (shards,)),
                [AN.Perturbation("dma_block_index", (2, 3, 4, 5))],
                caches=lambda: AN.launch_cache_sizes(block))]

            def run_of(n_blocks=3, y_tile=None):
                return D.make_distributed_run(
                    mesh, p, n_blocks=n_blocks, T=2, dt=DT,
                    local_kernel="fused", y_tile=y_tile,
                    exchange=exchange), (shards,)

            reports.append(AN.detect_retrace(
                run_of, [AN.Perturbation("n_blocks", (3, 5)),
                         AN.Perturbation("y_tile", (None, 4), "distinct")]))
            for report in reports:
                rows.append({"driver": f"distributed/{exchange}",
                             "knobs": sorted({k for k, _ in
                                              report.fingerprints}),
                             "ok": report.ok,
                             "findings": [str(f) for f in report.findings]})
                if not report.ok:
                    raise SystemExit(f"retrace[distributed/{exchange}]: "
                                     + "; ".join(rows[-1]["findings"]))
    red, green = {}, {}
    for name, factory, tables, want_ok in (
            ("static_parity (red)", AN.make_static_parity_driver, red,
             False),
            ("traced_parity (green)", AN.make_traced_parity_driver, green,
             True)):
        report = AN.detect_retrace(
            lambda block_index, f=factory, t=tables: f(block_index, tables=t),
            [AN.Perturbation("block_index", (0, 1, 2, 3))],
            caches=lambda t=tables: {"tables": len(t)}, execute=True)
        rows.append({"driver": name, "ok": report.ok,
                     "findings": [str(f) for f in report.findings]})
        if report.ok != want_ok or (not want_ok and report.findings[0].kind
                                    != "leak"):
            raise SystemExit(f"retrace[{name}]: expected "
                             f"{'clean' if want_ok else 'a leak'}, got "
                             f"{rows[-1]['findings']}")
    return rows


def _smem_rows():
    X, Y, Z = 1024, 1024, 64
    plans = {
        "K1 advance(16) pass": SM.fused_ring_plan(X, Y, Z, T=4),
        "K1 at y_tile 64": SM.fused_ring_plan(X, Y, Z, T=4, y_tile=64),
        "K5 serving 4 x (512, 512, 64)": SM.serving_ring_plan(
            512, 512, 64, batch=4, T=4),
        "distributed block (2, 2) remote_dma": SM.distributed_block_plan(
            (X // 2, Y // 2, Z), T=4, local_kernel="fused",
            exchange="remote_dma", nx=2, ny=2, shards_per_card=4),
        "K3 blocked": SM.rung_plan("advect_blocked", X, Y, Z),
        "K2 dataflow": SM.rung_plan("advect_dataflow", X, Y, Z),
        "K2 wide": SM.rung_plan("advect_wide", X, Y, Z),
        "K8 bf16 D=128": SM.attention_plan(128, torch.bfloat16),
        "K8 f32 D=128": SM.attention_plan(128, torch.float32),
        "K9 (1, 2048, 8192) bf16": SM.scan_plan(1, 2048, 8192, 16,
                                                x_itemsize=2, dt_itemsize=2),
    }
    for op, integrator, T in PR.SPEC_PAIRS:
        plans[f"K6 {op} {integrator} T={T}"] = SM.fused_ring_plan(
            X, Y, Z, T=T, spec=PR._spec(op, integrator))
    rows = []
    for name, plan in plans.items():
        rows.append({"plan": name, "shared_bytes": plan.total(),
                     "per_sm": plan.per_sm(),
                     "device_bytes": plan.device_total(),
                     "fits": plan.fits()})
        if not plan.fits():
            raise SystemExit(f"smem[{name}]: a shipped plan is over budget\n"
                             f"{plan.table()}")
    big = SM.distributed_block_plan((X, Y, Z), T=4, local_kernel="fused",
                                    exchange="remote_dma", nx=2, ny=2,
                                    shards_per_card=64)
    try:
        big.check()
    except SM.SmemBudgetExceeded as e:
        msg = str(e).splitlines()[0]
        if "largest buffer: 'K7 extended buffers (2 slots)'" not in msg:
            raise SystemExit(f"smem[oversized]: the refusal names another "
                             f"buffer: {msg}")
        rows.append({"plan": "oversized (64 shards a card)",
                     "refused": msg})
    else:
        raise SystemExit("smem[oversized]: an oversized plan did not raise")
    return rows


def _tiling_rows(progs):
    rows = []
    for prog in progs:
        report = AN.lint_records(_record(prog))
        rows.append({"program": prog.name, "kernels": report.kernels,
                     "errors": [str(i) for i in report.errors],
                     "warnings": sorted({f"{i.kind} {i.kernel}/{i.operand}"
                                         for i in report.warnings})})
        if report.errors:
            raise SystemExit(f"tiling[{prog.name}]: "
                             + "; ".join(rows[-1]["errors"]))
    return rows


def run(quick: bool) -> dict:
    small = PR.programs(small=True)
    out = {"ledger": _ledger_rows(small),
           "retrace": _retrace_rows(),
           "smem": _smem_rows(),
           "tiling": _tiling_rows(small + (PR.ladder_program(8, 16, 32),))}
    if not quick:
        paper = PR.programs(small=False)
        out["ledger"] += _ledger_rows(paper)
        out["tiling"] += _tiling_rows(
            paper + (PR.ladder_program(1024, 1024, 64),))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="probe sizes only")
    ap.add_argument("--list", action="store_true",
                    help="print the pass registry and exit")
    args = ap.parse_args(argv)
    if args.list:
        print(json.dumps([{"pass": n, "summary": s}
                          for n, s in AN.available()], indent=1))
        return 0
    out = run(args.quick)
    out["ok"] = True
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
