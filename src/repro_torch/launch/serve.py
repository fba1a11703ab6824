"""Serving entry point: the continuous-batching token engine on random
weights, or forecast jobs through the stencil serving engine.

    python -m repro_torch.launch.serve --arch qwen2.5-14b --requests 8
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --requests 8
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --requests 8
    python -m repro_torch.launch.serve --arch arctic-480b --smoke
    python -m repro_torch.launch.serve --smoke --device cpu
    python -m repro_torch.launch.serve --stencil --smoke --device cpu \
        --fault-plan "nan_poison@1:slot=1;device_loss@2:reshard_to=1"

The port of the token path of `repro.launch.serve`: the same arguments and
defaults, the same random prompts (`np.random.default_rng(0)`), weights
drawn on the device from a seeded `torch.Generator` with the reference's
init rules. It runs on `cuda` unless `--device cpu` is given.

What fits one 80 GB card at full width, in the configs' f32 weights:
`qwen2.5-14b` (59 GB), `falcon-mamba-7b` (28 GB) and `recurrentgemma-9b`
(38.5 GB; it serves at the defaults, `--max-len` 128 below its window
of 2048, on rings of `min(window, max_len)` slots, where the reference's
engine raises). The reference's default `--arch qwen3-32b` needs about
131 GB. The MoE configs do not fit at full depth (`llama4-maverick-400b-
a17b` holds 74 GB of f32 weights at 2 of its 48 layers, `arctic-480b` 56
GB at 1 of 35), so the CLI serves them at `--smoke` size; `chip_smoke.py`
runs them at full width, cut in depth, with bf16 weights. The vlm and
encdec configs (`qwen2-vl-72b`, `whisper-large-v3`) take embeddings, not
token prompts: the engine refuses them, as the reference's serves tokens
only. The engine runs the config's `attention_impl` (`chunked` for every
config), so the CLI launches neither flash attention (K8) nor the
selective scan (K9); `chip_smoke.py` serves with `attention_impl="pallas"`.
`--ckpt-dir` serves trained weights instead: the params of the latest
train state under that directory (`launch.train`'s checkpoints, or the
reference's: the format is shared), re-laid-out for tp = 1.

`--stencil` serves forecast jobs instead of tokens
(`serving.stencil_engine`): slots of (64, 256, 64) at T = 4, or (12, 16, 64)
at T = 2 with `--smoke`, dt 0.005, the reference's requests (extents and
budgets from `np.random.default_rng(0)`, fields `stratus_fields(...,
seed=i)`), `--max-new` bounding each job's fused steps and `--fault-plan`
injecting a `serving.faults.FaultPlan` (``kind@step[:key=val,...]``
clauses joined by ``;``) whose recovery counters print as the health
surface. `--lose-device-at` is the deprecated one-fault alias.
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
from repro_torch.serving.faults import Fault, FaultPlan
from repro_torch.serving.stencil_engine import (StencilRequest,
                                                StencilServingEngine)
from repro_torch.stencil.advection import AdvectionDomain, stratus_fields
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import step as TS

STENCIL_SHAPES = {True: (12, 16, 64, 2), False: (64, 256, 64, 4)}  # smoke?
STENCIL_DT = 0.005


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


def restored_params(cfg, ckpt_dir, device):
    """(the params of the latest train state under `ckpt_dir`, laid out
    for tp = 1 on `device`, its step)."""
    layout = M.make_layout(cfg, tp=1)
    like = pspec.abstract_params(TS.state_specs(cfg, layout))
    state, step = CKPT.restore(ckpt_dir, like, cfg=cfg, layout=layout)
    params = pspec.tree_map(lambda a: torch.from_numpy(a).to(device),
                            state["params"],
                            is_leaf=lambda x: isinstance(x, np.ndarray))
    return params, step


def stencil_requests(X: int, Y: int, Z: int, n_requests: int,
                     max_new: int, seed: int = 0) -> List[StencilRequest]:
    """The reference's forecast traffic: extents in [4, X] x [4, Y] and
    budgets in [1, max_new] from `np.random.default_rng(seed)`, the fields
    of job i `stratus_fields(Xr, Yr, Z, seed=i)` on the host."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        Xr = int(rng.integers(4, X + 1))
        Yr = int(rng.integers(4, Y + 1))
        u, v, w = (f.numpy() for f in stratus_fields(Xr, Yr, Z, seed=i,
                                                     device="cpu"))
        reqs.append(StencilRequest(
            uid=i, u=u, v=v, w=w,
            n_steps=int(rng.integers(1, max_new + 1))))
    return reqs


def stencil_plan(fault_plan: Optional[str],
                 lose_device_at: Optional[int]) -> Optional[FaultPlan]:
    """`--fault-plan`, or the deprecated `--lose-device-at` alias."""
    if fault_plan is not None:
        if lose_device_at is not None:
            raise SystemExit("--lose-device-at is a deprecated alias for "
                             "--fault-plan; pass only one")
        return FaultPlan.parse(fault_plan)
    if lose_device_at is not None:
        print("[serve] --lose-device-at is deprecated; use --fault-plan "
              f'"device_loss@{lose_device_at}"')
        return FaultPlan((Fault("device_loss", at_step=lose_device_at),))
    return None


def _run_stencil(args) -> None:
    X, Y, Z, T = STENCIL_SHAPES[args.smoke]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=T, dt=STENCIL_DT,
                          device=args.device)
    plan = stencil_plan(args.fault_plan, args.lose_device_at)
    engine = StencilServingEngine(dom, batch_size=args.batch_size,
                                  fault_plan=plan)
    reqs = stencil_requests(X, Y, Z, args.requests, args.max_new)
    t0 = time.time()
    done = engine.run(reqs)
    dt_s = time.time() - t0
    steps = sum(len(r.states) for r in done.values() if r.states)
    stats = engine.cache_stats()
    print(f"[serve] {len(done)} forecast domains, {steps} fused steps "
          f"(T={T}) in {dt_s:.1f}s; executable cache "
          f"hits={stats['hits']} misses={stats['misses']} "
          f"evictions={stats['evictions']}")
    # the model prices one fused step of every slot a mega-step, so its
    # "domains/s" are domain-steps a second: the measured figure beside it
    # is the same unit, fused steps over the wall time
    print(f"[serve] modelled serving throughput at batch={engine.B}: "
          f"{engine.modelled_throughput():.1f} domains/s; measured "
          f"{steps / dt_s:.1f} domains/s (both domain-steps/s; "
          f"{len(done) / dt_s:.1f} finished jobs/s) on {engine.device}")
    h = engine.health()
    print(f"[serve] health: faults={h['faults_injected']} "
          f"retries={h['retries']} quarantines={h['quarantines']} "
          f"rollbacks={h['rollbacks']} degradations={h['degradations']} "
          f"reshards={h['reshards']} exchange={h['exchange']}")
    for t_line in h["transitions"]:
        print(f"  [health] {t_line}")
    for uid in sorted(done)[:4]:
        r = done[uid]
        if r.status == "quarantined":
            print(f"  job {uid}: QUARANTINED ({r.error})")
            continue
        print(f"  job {uid}: extent {r.out[0].shape}, {len(r.states)} "
              f"streamed states, |u|max={float(np.abs(r.out[0]).max()):.3f}")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--stencil", action="store_true",
                    help="serve batched advection-forecast jobs instead of "
                         "tokens")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest train state there")
    ap.add_argument("--fault-plan", default=None,
                    help="(--stencil) deterministic fault schedule, e.g. "
                         "'nan_poison@1:slot=1;device_loss@2:reshard_to=1' "
                         "(serving.faults.FaultPlan.parse grammar)")
    ap.add_argument("--lose-device-at", type=int, default=None,
                    help="(--stencil) deprecated alias for --fault-plan "
                         "'device_loss@K': a device loss after this many "
                         "mega-steps, resharding to half the slots")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.stencil:
        _run_stencil(args)
        return
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.ckpt_dir:
        params, step = restored_params(cfg, args.ckpt_dir, args.device)
        print(f"[serve] restored step {step} from {args.ckpt_dir}")
    else:
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
