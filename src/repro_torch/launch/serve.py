"""Serving entry point: the continuous-batching token engine on random
weights.

    python -m repro_torch.launch.serve --arch qwen2.5-14b --requests 8
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --requests 8
    python -m repro_torch.launch.serve --smoke --device cpu

The port of the token path of `repro.launch.serve`: the same arguments and
defaults, the same random prompts (`np.random.default_rng(0)`), weights
drawn on the device from a seeded `torch.Generator` with the reference's
init rules. It runs on `cuda` unless `--device cpu` is given. The
reference's default `--arch qwen3-32b` needs about 131 GB of f32 weights,
more than one 80 GB card holds; `qwen2.5-14b` (59 GB) and `falcon-mamba-7b`
(28 GB) fit. The engine runs the config's `attention_impl` (`chunked` for
both), so the CLI launches neither flash attention (K8) nor the selective
scan (K9); `chip_smoke.py` serves with `attention_impl="pallas"`. `--stencil`
(forecast serving) waits for slice D and `--ckpt-dir` (trained weights)
for slice G2 (ROADMAP Queue 1).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import pspec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine


def random_requests(cfg, n_requests: int, max_new: int,
                    seed: int = 0) -> List[Request]:
    """The reference's traffic: prompts of 4-23 random tokens."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(4, 24))
                                        ).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n_requests)]


def random_params(cfg, device, seed: int = 0):
    """The model's weights drawn on `device` from a seeded generator."""
    layout = M.make_layout(cfg, tp=1)
    gen = torch.Generator(device=device).manual_seed(seed)
    return pspec.init_params(M.param_specs(cfg, layout), gen)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--stencil", action="store_true",
                    help="serve batched advection-forecast jobs instead of "
                         "tokens (waits for slice D)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve trained weights (waits for slice G2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.stencil:
        raise NotImplementedError("--stencil (forecast serving) waits for "
                                  "slice D (ROADMAP Queue 1)")
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir (checkpoint restore) waits for "
                                  "slice G2 (ROADMAP Queue 1)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = random_params(cfg, args.device)
    engine = ServingEngine(cfg, params, batch_size=args.batch_size,
                           max_len=args.max_len)
    reqs = random_requests(cfg, args.requests, args.max_new)
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    total = sum(len(v) for v in done.values())
    print(f"[serve] {cfg.name} on {engine.device}: {len(done)} requests, "
          f"{total} tokens in {dt:.1f}s ({total/dt:.1f} tok/s aggregate)")
    for uid in sorted(done)[:4]:
        print(f"  req {uid}: {done[uid][:10]}")


if __name__ == "__main__":
    main()
