#!/usr/bin/env python3
"""How far the port's two prefill scan paths drift apart with depth.

    PYTHONPATH=src python scripts/torch_scan_drift.py [--device cpu]

Runs `falcon-mamba-7b`'s architecture at a reduced width (d_model 256, so
d_inner 512; d_state 16, conv_k 4, dt_rank 16, vocab 2048, scan_chunk 256)
on one 2048-token prompt, with weights drawn by the reference's init rules
(seed 0), and prints max |Δ logit| between `attention_impl="pallas"` (the
selective scan K9 through `mamba_scan`) and `"chunked"` (the associative
scan of `_mamba_chunk_scan`) for 64 layers in f32, 2 layers in bf16 and 64
layers in bf16, beside the logits' scale and the share of argmaxes that
agree. On the CPU `pallas` runs K9's plain version. This is the basis of
the tolerances of `chip_smoke.py`'s full-width ssm prefill gates
(PERF.md).

    python3 scripts/torch_scan_drift.py --device cuda --full-width --per-layer

runs the full width instead (falcon-mamba-7b as configured; needs the
card) and, with `--per-layer`, walks the f32 layer stack with three
routes in lockstep: `chunked` (scan_chunk 256), `pallas` and `chunked` at
scan_chunk 2048 (one chunk, another association order of the same sums).
For each layer it prints the largest |difference| of each route's
residual stream from `chunked`'s, over its largest value, and the same
for one layer alone (each route fed `chunked`'s input to that layer), so
that the per-layer rounding difference and its growth through the stack
read apart.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.config import SSMConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import random_params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.blocks import Ctx  # noqa: E402

RUNS = ((64, "float32"), (2, "bfloat16"), (64, "bfloat16"))


def rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def per_layer(cfg, params, toks) -> None:
    """Lockstep residual streams of three routes, layer by layer (f32)."""
    layout = M.make_layout(cfg, 1)
    routes = {"chunked": cfg, "pallas": cfg.replace(attention_impl="pallas"),
              "chunked_2048": cfg.replace(scan_chunk=toks.shape[1])}

    def layer(c, p, x):
        return M._apply_block("mamba", p, x, Ctx(cfg=c, layout=layout))[0]

    x0 = M._embed(params, cfg, toks)
    xs = dict.fromkeys(routes, x0)
    for i in range(cfg.n_layers):
        p = M._layer(params["layers"], i)
        x_in = xs["chunked"]
        alone = {name: layer(c, p, x_in) for name, c in routes.items()}
        xs = {name: layer(c, p, xs[name]) for name, c in routes.items()}
        ref = xs["chunked"]
        print(f"layer {i:2d}: max |x| {ref.abs().max().item():.4e}; "
              f"stack: pallas {rel(xs['pallas'], ref):.3e}, chunked_2048 "
              f"{rel(xs['chunked_2048'], ref):.3e}; one layer: pallas "
              f"{rel(alone['pallas'], alone['chunked']):.3e}, chunked_2048 "
              f"{rel(alone['chunked_2048'], alone['chunked']):.3e}",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--per-layer", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("falcon-mamba-7b")
    if not args.full_width:
        base = base.replace(
            d_model=256, vocab_size=2048,
            ssm=SSMConfig(d_state=16, conv_k=4, expand=2, dt_rank=16))
    if args.per_layer:
        cfg = base.replace(compute_dtype="float32")
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, args.tokens)), device=args.device)
        with torch.no_grad():
            per_layer(cfg, random_params(cfg, args.device), toks)
        return
    for n_layers, dtype in RUNS:
        cfg = base.replace(n_layers=n_layers, compute_dtype=dtype)
        layout = M.make_layout(cfg, 1)
        params = random_params(cfg, args.device)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, args.tokens)), device=args.device)
        t0 = time.perf_counter()
        logits = {impl: M.forward(params, {"inputs": toks},
                                  cfg.replace(attention_impl=impl),
                                  layout)[0]
                  for impl in ("chunked", "pallas")}
        ref = logits["chunked"]
        agree = (logits["pallas"].argmax(-1) == ref.argmax(-1)).float().mean()
        print(f"{n_layers} layers, {dtype}: max |pallas - chunked| "
              f"{(logits['pallas'] - ref).abs().max().item():.4e}, max "
              f"|logit| {ref.abs().max().item():.4f}, std "
              f"{ref.std().item():.4f}, argmax agreement {agree.item():.4f}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
