"""Training driver (the port of `repro.launch.train`).

Config registry -> host mesh -> train step -> prefetching data pipeline
-> checkpoint and auto-resume -> NaN guard:

    python -m repro_torch.launch.train --arch qwen3-32b --smoke --device cpu
    python -m repro_torch.launch.train --arch qwen3-32b --smoke --steps 50

It runs on `cuda` unless `--device cpu` is given, and raises where CUDA is
asked for and no card is visible. At full width `qwen3-32b` needs about
131 GB of f32 params alone: one 80 GB card trains it cut in depth
(`chip_smoke.py` phase 29, 4 of 64 layers).

Fault tolerance, as in the reference:
  * auto-resume from the LATEST checkpoint,
  * deterministic per-step data (seeded), so a resumed run consumes exactly
    the batches it would have seen,
  * the NaN guard: a step whose loss or gradient norm is not finite leaves
    the state unchanged and is counted as skipped,
  * asynchronous checkpoints (`AsyncCheckpointer`): the host copy is taken
    at the call, the serialisation overlaps the next steps.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import pspec
from repro_torch.config import RunShape
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import Prefetcher, synth_batch, to_device
from repro_torch.launch.mesh import make_host_mesh, tp_degree
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as O
from repro_torch.training import step as TS


def _poisoned(batch):
    """The batch with every float input times NaN (a corrupt data shard),
    and whether it had one to poison."""
    out = {k: v * float("nan") if v.is_floating_point() else v
           for k, v in batch.items()}
    return out, any(v.is_floating_point() for v in batch.values())


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir=None,
               ckpt_every: int = 50, mesh=None, opt=None, log_every: int = 10,
               resume: bool = True, seed: int = 1234,
               inject_nan_at: int = -1, device: str = "cuda"):
    """Train `steps` steps (from the latest checkpoint under `ckpt_dir`
    where `resume`). Returns (state, the good steps' losses, info):
    info["skipped"] counts the steps the NaN guard skipped, info["step_s"]
    holds each step's wall seconds (the step and the read of its loss,
    which waits for the device). `inject_nan_at` poisons that step's batch
    (its float inputs times NaN; a batch of tokens only, the step's loss)."""
    mesh = mesh or make_host_mesh(device=device)
    dev = mesh.devices[0]
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: no CUDA device visible; pass "
                           "device='cpu' to train on the CPU")
    layout = M.make_layout(cfg, tp_degree(mesh))
    opt = opt or O.OptConfig(peak_lr=3e-3, warmup_steps=20, total_steps=steps)

    state = TS.init_state(cfg, layout,
                          torch.Generator(device=dev).manual_seed(seed))
    start_step = 0
    ckpt = None
    if ckpt_dir is not None:
        ckpt = CKPT.AsyncCheckpointer(ckpt_dir)
        if resume and CKPT.latest_step(ckpt_dir) is not None:
            restored, start_step = CKPT.restore(ckpt_dir, state, cfg=cfg,
                                                layout=layout)
            pspec.tree_map(lambda t, a: t.copy_(torch.from_numpy(a)),
                           state, restored, is_leaf=torch.is_tensor)
            print(f"[train] resumed from step {start_step}")

    shape = RunShape("adhoc", "train", seq, batch)
    step_fn = TS.make_train_step(cfg, layout, opt=opt)
    pf = Prefetcher(lambda s: synth_batch(cfg, shape, s, seed), start_step,
                    depth=2, put_fn=lambda b: to_device(b, dev))
    history: List[float] = []
    step_s: List[float] = []
    t0 = time.time()
    skipped = 0
    try:
        for i in range(start_step, steps):
            s, b = next(pf)
            assert s == i, (s, i)
            poison = False
            if i == inject_nan_at:   # fault injection (tests, chip_smoke)
                b, had_float = _poisoned(b)
                poison = not had_float
            # the step itself guards: non-finite loss -> state unchanged
            t_step = time.perf_counter()
            state, metrics = step_fn(state, b, poison=poison)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - t_step)
            if not bool(metrics["good"]):
                skipped += 1
                print(f"[train] step {i}: non-finite loss, update skipped "
                      f"in-graph")
                continue
            history.append(loss)
            if log_every and (i % log_every == 0 or i == steps - 1):
                dt = time.time() - t0
                print(f"[train] step {i:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
            if ckpt is not None and ((i + 1) % ckpt_every == 0
                                     or i == steps - 1):
                ckpt.save(state, i + 1, cfg=cfg, layout=layout)
    finally:
        pf.close()
        if ckpt is not None:
            ckpt.wait()
    return state, history, {"skipped": skipped, "step_s": step_s}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = O.OptConfig(peak_lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps)
    state, history, info = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, opt=opt,
        resume=not args.no_resume, device=args.device)
    print(f"[train] done: first loss {history[0]:.4f} -> last "
          f"{history[-1]:.4f} ({info['skipped']} skipped)")


if __name__ == "__main__":
    main()
