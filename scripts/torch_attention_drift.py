#!/usr/bin/env python3
"""How far the port's two prefill attention paths drift apart with depth.

    PYTHONPATH=src python scripts/torch_attention_drift.py [--device cpu]

Runs `qwen2.5-14b`'s architecture at a reduced width (d_model 320, 5 q
heads over 1 kv head of 64, d_ff 864, vocab 2048, attn_chunk 128) on one
256-token prompt, with weights drawn by the reference's init rules (seed
0), and prints max |Δ logit| between `attention_impl="pallas"` and
`"chunked"` (and `"dense"`) for 48 layers in f32, 2 layers in bf16 and 48
layers in bf16, beside the logits' scale and the share of argmaxes that
agree. On the CPU `pallas` runs K8's plain version. This is the basis of
the tolerances of `chip_smoke.py`'s full-width prefill gates (PERF.md).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import random_params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

RUNS = ((48, "float32"), (2, "bfloat16"), (48, "bfloat16"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--tokens", type=int, default=256)
    args = ap.parse_args()
    base = get_config("qwen2.5-14b").replace(
        d_model=320, n_heads=5, n_kv_heads=1, head_dim=64, d_ff=864,
        vocab_size=2048, attn_chunk=128)
    for n_layers, dtype in RUNS:
        cfg = base.replace(n_layers=n_layers, compute_dtype=dtype)
        layout = M.make_layout(cfg, 1)
        params = random_params(cfg, args.device)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, args.tokens)), device=args.device)
        logits = {impl: M.forward(params, {"inputs": toks},
                                  cfg.replace(attention_impl=impl),
                                  layout)[0]
                  for impl in ("chunked", "pallas", "dense")}
        ref = logits["chunked"]
        agree = (logits["pallas"].argmax(-1) == ref.argmax(-1)).float().mean()
        print(f"{n_layers} layers, {dtype}: max |pallas - chunked| "
              f"{(logits['pallas'] - ref).abs().max().item():.4e}, max "
              f"|dense - chunked| {(logits['dense'] - ref).abs().max().item():.4e}"
              f", max |logit| {ref.abs().max().item():.4f}, std "
              f"{ref.std().item():.4f}, argmax agreement {agree.item():.4f}",
              flush=True)


if __name__ == "__main__":
    main()
