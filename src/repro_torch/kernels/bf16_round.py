"""The bf16 rounding routes of `csrc/bf16_round.cu`, each alone on the card.

K1/K5 and K6 round a bf16 op's f32 result by the route `ROUTE`
(`rpk<true>` in `csrc/cells.cuh`: one `cvt.rn.bf16x2.f32` of the value and
0.0f, whose word is the value's bf16 widened), the v1-v3 rungs by "cvt"
(`rnd<true>`); the others are measured here and run in no kernel of a
path. Two measurements a route:

- `check_route`: how many of the 2^32 f32 bit patterns the route rounds as
  `__float2bfloat16_rn` does (the same bits, NaN to NaN);
- `route_rate`: its rounds a clock per SM, each round after one f32 add,
  from a launch's CUDA-event time and the SM clock that its first thread
  read.

Both need a card: the kernels are built with the rest (`_build.load`).
"""
from __future__ import annotations

import ctypes
import statistics

import torch

from repro_torch import _build

ROUTES = ("cvt", "pair", "split_round", "split_cell", "int_rne", "mix",
          "pack_hi")
ROUTE = "pack_hi"         # the route K1/K5 and K6 round by
PATTERNS = 1 << 32
CHECK_BLOCKS = 4096
RATE_THREADS = 256
RATE_BLOCKS_PER_SM = 8
RATE_ITERS = 4096
RATE_STEP = 2.0 ** -7     # d of the chains' v = round(v + d)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_route(route: str, device="cuda") -> int:
    """The bit patterns of all 2^32 that `route` rounds as the convert
    does."""
    lib = _build.load()
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(count.device):
        _build.check(lib.bf16_round_check(ROUTES.index(route),
                                          count.data_ptr(), CHECK_BLOCKS,
                                          _stream(count.device)),
                     "bf16_round_check")
    return int(count.item())


def route_rate(route: str, device="cuda", runs: int = 10) -> dict:
    """`route`'s throughput: rounds, median ms of `runs` launches by
    events, the SM clock (GHz) its first thread saw and the rounds a clock
    per SM."""
    lib = _build.load()
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * RATE_BLOCKS_PER_SM
    sink = torch.empty(blocks * RATE_THREADS, device=dev)
    clk = torch.zeros(2, dtype=torch.int64, device=dev)
    rounds = blocks * RATE_THREADS * RATE_ITERS * lib.bf16_round_chains()

    def launch():
        _build.check(lib.bf16_round_rate(
            ROUTES.index(route), blocks, RATE_THREADS, RATE_ITERS,
            ctypes.c_float(RATE_STEP), sink.data_ptr(), clk.data_ptr(),
            _stream(dev)), "bf16_round_rate")

    with torch.cuda.device(dev):
        for _ in range(2):
            launch()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    clocks, ns = (int(c) for c in clk.tolist())
    ghz = clocks / ns
    return {"route": route, "rounds": rounds, "ms": ms, "ghz": ghz,
            "per_clock_per_sm": rounds / (ms * 1e-3 * ghz * 1e9 * sms)}
