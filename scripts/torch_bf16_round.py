#!/usr/bin/env python3
"""Each bf16 rounding route of `csrc/bf16_round.cu` alone on the card.

    python3 scripts/torch_bf16_round.py [--no-check]

Needs the card. For each route (`repro_torch.kernels.bf16_round.ROUTES`)
it prints its rounds a clock per SM (8 chains a thread of
v = round(v + d), one f32 add a round; 8 blocks of 256 threads an SM,
4,096 steps: 8.9 G rounds on 132 SMs; median of 10 launches by CUDA
events, the SM clock read by the launch's first thread) and, unless
`--no-check`, how many of the 2^32 f32 bit patterns it rounds as
`__float2bfloat16_rn` does (NaN to NaN). The card's name and power limit
come first. Exits 1 when the route K1/K5 and K6 round by misses a pattern.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import bf16_round as BR  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-check", action="store_true",
                    help="skip the exhaustive checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bf16_round: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ok = True
    for route in BR.ROUTES:
        r = BR.route_rate(route)
        line = (f"route {route}: {r['per_clock_per_sm']:.2f} rounds a clock "
                f"per SM ({r['rounds']} rounds in {r['ms']:.4f} ms at "
                f"{r['ghz']:.3f} GHz)")
        if not args.no_check:
            n = BR.check_route(route)
            line += f"; exact on {n:,} of {BR.PATTERNS:,} bit patterns"
            ok &= route != BR.ROUTE or n == BR.PATTERNS
        print(line + f"; card {card}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
