#!/usr/bin/env python3
"""Where the serving path's time goes on the card: `torch.profiler` over
the prefills and over the decode steps of `qwen2.5-14b` at full width.

    python3 scripts/torch_serve_profile.py [--arch qwen2.5-14b] [--steps 10]

Builds `ServingEngine` with f32 weights drawn on the card (seed 0), bf16
compute and `attention_impl="pallas"`, runs serve.py's default traffic once
to warm up (kernel build, cuBLAS heuristics), then profiles two windows on
a fresh engine: the prefills of 4 requests (one per slot), and `--steps`
decode steps of the batch. For each window it prints the host wall time
(ending in a synchronise), the time of every kernel summed (kernel rows
only, not the operator rows that launched them), their ratio (the
device's busy share; kernels run on one stream), the share of the weight
casts, the matrix products, K8 (the bf16 tensor-core kernel
`flash_wgmma_kernel` and the f32 `flash_fwd_kernel`) and K9
(`selective_scan_chunk_kernel`, with `--arch falcon-mamba-7b`), and the
kernels that hold the most time; then the decode steps again without the
profiler. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import (random_params,  # noqa: E402
                                      random_requests)
from repro_torch.serving.engine import ServingEngine  # noqa: E402


CLASSES = (("bf16 casts of f32 weights", ("bfloat16_copy",)),
           ("matrix products", ("nvjet", "gemm", "gemv", "cutlass", "sm90")),
           ("flash attention (K8)", ("flash_wgmma_kernel",
                                     "flash_fwd_kernel")),
           ("selective scan (K9)", ("selective_scan_chunk_kernel",)))


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def report(title: str, prof, wall_s: float, top: int) -> None:
    """Kernel rows only (operator rows would count their kernels again)."""
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=device_us, reverse=True)
    total_us = sum(device_us(e) for e in kernels)
    share = lambda us: us / total_us if total_us else 0.0  # noqa: E731
    print(f"{title}: wall {wall_s * 1e3:.3f} ms, kernel time "
          f"{total_us / 1e3:.3f} ms in {sum(e.count for e in kernels)} "
          f"launches, busy share {total_us / 1e3 / (wall_s * 1e3):.4f}",
          flush=True)
    rest = total_us
    for what, keys in CLASSES:
        us = sum(device_us(e) for e in kernels
                 if any(k in e.key for k in keys))
        rest -= us
        print(f"  {what}: {us / 1e3:.3f} ms, {share(us):.4f} of the "
              f"kernel time", flush=True)
    print(f"  other kernels: {rest / 1e3:.3f} ms, {share(rest):.4f}",
          flush=True)
    for e in kernels[:top]:
        us = device_us(e)
        print(f"  {us / 1e3:10.3f} ms {share(us):7.4f}  {e.count:6d} x "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = get_config(args.arch).replace(attention_impl="pallas")
    params = random_params(cfg, "cuda")
    ServingEngine(cfg, params, batch_size=4, max_len=128).run(
        random_requests(cfg, 8, 16))
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name}, 4 slots, "
          f"max_len 128", flush=True)

    engine = ServingEngine(cfg, params, batch_size=4, max_len=128)
    reqs = random_requests(cfg, 4, args.steps + 1, seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for slot, req in enumerate(reqs):
            engine._prime(slot, req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lens = [len(r.prompt) for r in reqs]
    report(f"prefill of 4 prompts ({lens} tokens)", prof, wall, args.top)

    def decode():
        toks = torch.as_tensor(engine.next_token.astype(np.int64),
                               device="cuda")
        pos = torch.as_tensor((engine.pos + 1).astype(np.int64),
                              device="cuda")
        nxt = engine._decode(toks, pos)
        engine.pos += 1
        engine.next_token = nxt.astype(np.int32)

    decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            decode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"{args.steps} decode steps of 4 slots", prof, wall, args.top)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        decode()
    torch.cuda.synchronize()
    print(f"the same {args.steps} decode steps unprofiled: "
          f"{(time.perf_counter() - t0) / args.steps * 1e3:.3f} ms each",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
