#!/usr/bin/env python3
"""Repeat K8's f32 gqa-layout case to look for a run that differs.

    python3 scripts/torch_k8_repeat.py [--runs 3000]

Needs the card. Draws the inputs of `tests/test_torch_cuda.py::
test_flash_kernel_gqa_layout_equals_plain` (seed 1: q (2, 40, 2, 5, 64),
k and v (2, 40, 2, 64), f32, causal). First it prints the plain version's
distance from an f64 oracle at 1, 2, 4 and 8 CPU threads. Then it runs
`gqa_layout_attention` on the card `--runs` times on the same inputs.
Every third run first fills a fresh 16 MB block of the card with NaN and
frees it, so that a kernel reading memory it did not write would show.
It prints the first runs that differ bitwise from run 0 (flat index, card
value, run 0's and the f64 value), then the number of runs that differ,
the worst distance from the plain version and run 0's distance from f64.
The test's tolerance is 1e-5.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels.attention import ops as TOPS  # noqa: E402

SHAPES = ((2, 40, 2, 5, 64), (2, 40, 2, 64), (2, 40, 2, 64))


def f64_oracle(q5, k4, v4):
    """Causal GQA-layout attention in f64: (B, S, K, G, D)."""
    S, D = q5.shape[1], q5.shape[4]
    q = q5.double().permute(0, 2, 3, 1, 4)             # b k g s d
    k, v = (t.double().permute(0, 2, 1, 3) for t in (k4, v4))
    s = torch.einsum("bkgqd,bksd->bkgqs", q, k) * D ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                      float("-inf"))
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, -1), v)
    return o.permute(0, 3, 1, 2, 4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k8_repeat: needs a CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(1)
    q5, k4, v4 = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                  for s in SHAPES)
    exact = f64_oracle(q5, k4, v4)
    threads = torch.get_num_threads()
    for n in (1, 2, 4, 8):
        torch.set_num_threads(n)
        w = TOPS.gqa_layout_attention(q5, k4, v4)
        err = float((w.double() - exact).abs().max())
        print(f"cpu plain, {n} threads: {err:.3e} from f64", flush=True)
    torch.set_num_threads(threads)
    want = TOPS.gqa_layout_attention(q5, k4, v4)
    qc, kc, vc = q5.cuda(), k4.cuda(), v4.cuda()
    first = TOPS.gqa_layout_attention(qc, kc, vc).cpu()
    worst, differ = 0.0, 0
    for i in range(args.runs):
        if i % 3 == 1:
            junk = torch.full((1 << 22,), float("nan"), device="cuda")
            del junk
        got = TOPS.gqa_layout_attention(qc, kc, vc).cpu()
        worst = max(worst, float((got - want).abs().max()))
        if not torch.equal(got, first):
            differ += 1
            if differ <= 5:
                idx = int((got - first).abs().argmax())
                print(f"run {i}: differs from run 0 at flat index {idx}: "
                      f"{got.flatten()[idx].item()} against "
                      f"{first.flatten()[idx].item()} (f64 "
                      f"{exact.flatten()[idx].item()})", flush=True)
    print(f"card: {args.runs} runs, {differ} differ bitwise from run 0; "
          f"worst {worst:.3e} from plain; run 0 "
          f"{float((first.double() - exact).abs().max()):.3e} from f64; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
