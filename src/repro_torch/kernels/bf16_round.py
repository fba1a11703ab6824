"""The bf16 rounding routes and bf16x2 ops of `csrc/bf16_round.cu`, each
alone on the card.

K1/K5, K6 and the v1-v3 rungs' one-cell build round a bf16 op's f32 result
by the route `ROUTE` (`rpk<true>` in `csrc/cells.cuh`: one
`cvt.rn.bf16x2.f32` of the value and 0.0f, whose word is the value's bf16
widened); the others are measured here and run in no kernel of a path. Two
measurements a route:

- `check_route`: how many of the 2^32 f32 bit patterns the route rounds as
  `__float2bfloat16_rn` does (the same bits, NaN to NaN);
- `route_rate`: its rounds a clock per SM, each round after one f32 add,
  from a launch's CUDA-event time and the SM clock that its first thread
  read.

The rungs' pair build computes two cells a 32-bit word, each bf16 op of
both by one bf16x2 instruction (`PAIR_OPS`: `b2_add`, `b2_sub`, `b2_mul`
of `csrc/cells.cuh`). Two measurements an op:

- `check_pair_op`: how many of the 2^32 pairs of bf16 operands the op
  computes as `rpk<true>` of the f32 op does (the same bits, the sign of
  zero included, NaN as NaN);
- `pair_op_rate`: its ops (two an instruction) a clock per SM.

All need a card: the kernels are built with the rest (`_build.load`).
"""
from __future__ import annotations

import ctypes
import statistics

import torch

from repro_torch import _build

ROUTES = ("cvt", "pair", "split_round", "split_cell", "int_rne", "mix",
          "pack_hi")
ROUTE = "pack_hi"         # the route K1/K5, K6 and the rungs round by
PAIR_OPS = ("add", "sub", "mul")   # the bf16x2 ops the rungs' pairs use
PAIR_STEP = {"add": 2.0 ** -7, "sub": 2.0 ** -7, "mul": 1.0}   # d of
#                         the chains' v = op(v, d): finite all the way
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


def check_pair_op(op: str, device="cuda") -> int:
    """The pairs of bf16 operands of all 2^32 that the bf16x2 op `op`
    computes as the f32 op rounded by `rpk<true>`."""
    lib = _build.load()
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(count.device):
        _build.check(lib.bf16_pair_check(PAIR_OPS.index(op),
                                         count.data_ptr(), CHECK_BLOCKS,
                                         _stream(count.device)),
                     "bf16_pair_check")
    return int(count.item())


def route_rate(route: str, device="cuda", runs: int = 10) -> dict:
    """`route`'s throughput: rounds, median ms of `runs` launches by
    events, the SM clock (GHz) its first thread saw and the rounds a clock
    per SM."""
    return _rate("bf16_round_rate", ROUTES.index(route), RATE_STEP, 1,
                 device, runs, {"route": route})


def pair_op_rate(op: str, device="cuda", runs: int = 10) -> dict:
    """The bf16x2 op `op`'s throughput, as `route_rate`'s: "rounds" and
    "per_clock_per_sm" count ops, two an instruction, each rounded once."""
    return _rate("bf16_pair_rate", PAIR_OPS.index(op), PAIR_STEP[op], 2,
                 device, runs, {"op": op})


def _rate(entry: str, which: int, step: float, lanes: int, device,
          runs: int, tag: dict) -> dict:
    """Time the rate kernel `which` of the C entry point `entry` at the
    fixed grid: the ops it runs (chains x `lanes`), the median ms of `runs`
    launches, the clock its first thread saw and the ops a clock per SM."""
    lib = _build.load()
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * RATE_BLOCKS_PER_SM
    sink = torch.empty(blocks * RATE_THREADS, device=dev)
    clk = torch.zeros(2, dtype=torch.int64, device=dev)
    rounds = (blocks * RATE_THREADS * RATE_ITERS * lib.bf16_round_chains()
              * lanes)

    def launch():
        _build.check(getattr(lib, entry)(
            which, blocks, RATE_THREADS, RATE_ITERS, ctypes.c_float(step),
            sink.data_ptr(), clk.data_ptr(), _stream(dev)), entry)

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
    return {**tag, "rounds": rounds, "ms": ms, "ghz": ghz,
            "per_clock_per_sm": rounds / (ms * 1e-3 * ghz * 1e9 * sms)}
