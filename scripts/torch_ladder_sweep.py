#!/usr/bin/env python3
"""Launch-shape sweep of the port's v1-v3 kernels on one NVIDIA GPU.

    python3 scripts/torch_ladder_sweep.py
    python3 scripts/torch_ladder_sweep.py --bf16 --cells 4,8

Times `advect_blocked` (K3) and `advect_dataflow` / `advect_wide` (K2) with
`fuse_update=True` at the paper's 67M grid (1024, 1024, 64) over y-tiles
(blocks per SM) and, for K2, x-chunk lengths (blocks per launch), with CUDA
events (median of 10 after warm-up; `--bf16` also device time by
`torch.profiler`). Each line prints the launch plan the
wrapper runs for the configuration (`rung_device_plan`: a tile taller than
the rung's own runs as equal sub-tiles, so several given tiles may run the
same plan), not the tile it was given. `--bf16` times bf16 fields with
bf16 coefficients (the pair builds) on each rung's own tile and at
`--cells` owned cells a thread (`RUNG_CELLS_PER_THREAD[2]`, the planner's
threads a block), printing each build's registers and resident blocks a
SM. Prints the card's name and power limit first. Correctness is
`chip_smoke.py`'s job; this script only measures. Exits nonzero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels.advection import advection as K  # noqa: E402
from repro_torch.kernels.advection import ref as REF  # noqa: E402

GRID = (1024, 1024, 64)
DT = 0.01
Y_TILES = (64, 32, 16, 8)
X_CHUNKS = (8, 32, 128)
RUNS, WARMUP = 10, 2


def time_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, match: str, runs: int = 10) -> float:
    """Device ms a launch of the kernels named like `match` that `fn`
    launches, by `torch.profiler` over `runs` calls, divided by the
    launches it saw (0.0 where it saw none)."""
    fn()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    seen = [e for e in prof.key_averages() if match in e.key
            and getattr(e, "device_type", None) == cuda]
    n = sum(e.count for e in seen)
    us = sum(getattr(e, "device_time_total", 0.0) for e in seen)
    return us / n / 1e3 if n else 0.0


def bf16_cells(cells) -> None:
    """The bf16 rungs on their own tiles at each count of owned cells a
    thread."""
    X, Y, Z = GRID
    u, v, w = (torch.randn(GRID, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    p = REF.default_params(Z, device="cuda", dtype=torch.bfloat16)
    for c in cells:
        K.RUNG_CELLS_PER_THREAD[2] = c
        K._rung_block.cache_clear()
        K.rung_launch_plan.cache_clear()
        for name in ("advect_blocked", "advect_dataflow", "advect_wide"):
            plan = K.rung_device_plan("cuda", name, X, Y, Z,
                                      dtype=torch.bfloat16, coef=True)
            a = K.rung_kernel_attrs("cuda", name, plan, dtype=torch.bfloat16,
                                    coef=True)
            def call():
                return getattr(K, name)(u, v, w, p, fuse_update=True, dt=DT)

            ms = time_ms(call)
            dev = device_ms(call, name.replace("wide", "dataflow"))
            print(f"{name} bf16 (bf16 coefficients) at {c} cells a thread: "
                  f"{ms:.4f} ms per launch by events, device {dev:.4f}; "
                  f"TY={plan.TY}, CX={plan.CX}, "
                  f"{plan.threads} threads, {plan.shared_bytes} B, "
                  f"{a['registers']} registers, {a['local_bytes']} B "
                  f"spilled, {a['blocks_per_sm']} resident per SM",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 fields and coefficients on the own tiles")
    ap.add_argument("--cells", default="4",
                    help="owned cells a thread for --bf16, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ladder_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.bf16:
        bf16_cells([int(c) for c in args.cells.split(",")])
        return 0
    X, Y, Z = GRID
    u, v, w = (torch.randn(GRID, device="cuda") for _ in range(3))
    p = REF.default_params(Z, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("advect_blocked", "advect_dataflow", "advect_wide"):
        for y_tile in Y_TILES:
            chunks = (None,) if name == "advect_blocked" else X_CHUNKS
            for x_chunk in chunks:
                plan = K.rung_device_plan("cuda", name, X, Y, Z,
                                          y_tile=y_tile, x_chunk=x_chunk)
                kw = {} if x_chunk is None else {"x_chunk": x_chunk}
                ms = time_ms(lambda: K._advect_rung_cuda(
                    name, u, v, w, p, y_tile, True, DT, **kw))
                print(f"{name} y_tile={y_tile} x_chunk={x_chunk}: {ms:.4f} "
                      f"ms per launch; runs TY={plan.TY} (slab {plan.S} "
                      f"rows), CX={plan.CX}, grid {plan.grid} "
                      f"({plan.grid[0] * plan.grid[1]} blocks of "
                      f"{plan.threads} threads, {plan.shared_bytes} B, "
                      f"{plan.blocks_per_sm} an SM) on {sms} SMs",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
