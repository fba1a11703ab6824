"""Training driver (the port of `repro.launch.train`).

Config registry -> host mesh -> train step -> prefetching data pipeline
-> checkpoint and auto-resume -> NaN guard:

    python -m repro_torch.launch.train --arch qwen3-32b --smoke --device cpu
    python -m repro_torch.launch.train --arch qwen3-32b --smoke --steps 50

It runs on `cuda` unless `--device cpu` is given, and raises where CUDA is
asked for and no card is visible. At full width `qwen3-32b` needs about
131 GB of f32 params alone: one 80 GB card trains it cut in depth
(`chip_smoke.py` phase 29, 4 of 64 layers).

`train_loop(mesh=...)` given a `DeviceMesh` (`launch.mesh.make_host_mesh`
under an initialised process group, one rank a card) trains sharded, as
the reference does under its mesh: the rules are `make_rules(multi_pod=
"pod" in the mesh)`, the state is drawn leaf by leaf and placed by them,
and every rank feeds the same batch, which the step splits over "data".
Rank 0 writes the checkpoints (the state gathered whole).

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
from repro_torch.distributed.sharding import (axis_sizes, is_device_mesh,
                                              make_rules)
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
    which waits for the device), info["grad_norm"] each good step's
    gradient norm. `inject_nan_at` poisons that step's batch (its float
    inputs times NaN; a batch of tokens only, the step's loss). Under a
    `DeviceMesh` the state comes back as DTensors (`pspec.gather_tree`
    makes it plain)."""
    mesh = mesh or make_host_mesh(device=device)
    sharded = is_device_mesh(mesh)
    if sharded:
        dev = torch.device(mesh.device_type, torch.cuda.current_device()
                           if mesh.device_type == "cuda" else None)
        rules = make_rules(multi_pod="pod" in axis_sizes(mesh))
    else:
        dev, rules = mesh.devices[0], None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: no CUDA device visible; pass "
                           "device='cpu' to train on the CPU")
    layout = M.make_layout(cfg, tp_degree(mesh))
    opt = opt or O.OptConfig(peak_lr=3e-3, warmup_steps=20, total_steps=steps)

    gen = torch.Generator(device=dev).manual_seed(seed)
    if sharded:
        state = TS.init_sharded_state(cfg, layout, gen, rules, mesh)
    else:
        state = TS.init_state(cfg, layout, gen)
    writer = not sharded or mesh.get_rank() == 0
    start_step = 0
    ckpt = None
    if ckpt_dir is not None:
        ckpt = CKPT.AsyncCheckpointer(ckpt_dir) if writer else None
        if resume and CKPT.latest_step(ckpt_dir) is not None:
            restored, start_step = CKPT.restore(
                ckpt_dir, pspec.gather_tree(state) if sharded else state,
                cfg=cfg, layout=layout)
            restored = pspec.tree_map(torch.as_tensor, restored,
                                      is_leaf=lambda a: hasattr(a, "dtype"))
            if sharded:
                restored = TS.place_state(restored, cfg, layout, rules, mesh)
            pspec.tree_map(_copy_into, state, restored,
                           is_leaf=torch.is_tensor)
            print(f"[train] resumed from step {start_step}")

    shape = RunShape("adhoc", "train", seq, batch)
    step_fn = TS.make_train_step(cfg, layout, rules, mesh, opt=opt)
    pf = Prefetcher(lambda s: synth_batch(cfg, shape, s, seed), start_step,
                    depth=2, put_fn=lambda b: to_device(b, dev))
    history: List[float] = []
    step_s: List[float] = []
    norms: List[float] = []
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
            norms.append(float(metrics["grad_norm"]))
            if log_every and (i % log_every == 0 or i == steps - 1):
                dt = time.time() - t0
                print(f"[train] step {i:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
            if ckpt_dir is not None and ((i + 1) % ckpt_every == 0
                                         or i == steps - 1):
                whole = pspec.gather_tree(state) if sharded else state
                if ckpt is not None:
                    ckpt.save(whole, i + 1, cfg=cfg, layout=layout)
                del whole
    finally:
        pf.close()
        if ckpt is not None:
            ckpt.wait()
    return state, history, {"skipped": skipped, "step_s": step_s,
                            "grad_norm": norms}


def _copy_into(dst, src):
    """Copy `src` into `dst` in place (each rank's own shard of DTensors)."""
    if hasattr(dst, "to_local"):
        dst, src = dst.to_local(), src.to_local()
    dst.copy_(src)


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
