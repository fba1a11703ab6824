#!/usr/bin/env python3
"""Launch-shape sweep of the port's v1-v3 kernels on one NVIDIA GPU.

    python3 scripts/torch_ladder_sweep.py

Times `advect_blocked` (K3) and `advect_dataflow` / `advect_wide` (K2) with
`fuse_update=True` at the paper's 67M grid (1024, 1024, 64) over y-tiles
(blocks per SM) and, for K2, x-chunk lengths (blocks per launch), with CUDA
events (median of 10 after warm-up). Each line prints the launch plan the
wrapper runs for the configuration (`rung_device_plan`: a tile taller than
the rung's own runs as equal sub-tiles, so several given tiles may run the
same plan), not the tile it was given. Prints the card's name and power
limit first. Correctness is `chip_smoke.py`'s job; this script only
measures. Exits nonzero without a CUDA device.
"""
from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ladder_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
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
