"""AdamW with warmup + cosine schedule and global-norm clipping (the port
of `repro.training.optimizer`).

The arithmetic is the reference's, in f32 and in its order: the bias
corrections `c1`, `c2` from `step + 1`, `delta = mhat / (sqrt(vhat) +
eps) + weight_decay * p` on every leaf. The update runs in place, leaf by
leaf, and each leaf in slices of at most `SLICE_ELEMS` elements
(`slices`), so its f32 temporaries stay near a gigabyte even for the 778M
elements of qwen3-32b's embedding. Where the caller passes `good` (the
train step's NaN guard), each slice is written as `torch.where(good, new,
old)`: a step that is not good leaves the params and moments unchanged,
bitwise, with no wait for the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator

import torch

from repro_torch.pspec import torch_dtype, tree_leaves, tree_map

SLICE_ELEMS = 1 << 26     # elements an in-place update step touches at once


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(step, oc: OptConfig):
    """The learning rate at `step` (an int, or a 0-dim tensor on the
    state's device): linear warmup, then cosine down to `min_lr_frac`, in
    f32 (a tensor in, a 0-dim f32 tensor out)."""
    step = torch.as_tensor(step).float()
    warm = oc.peak_lr * (step + 1) / max(oc.warmup_steps, 1)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = oc.peak_lr * (oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5
                        * (1 + torch.cos(math.pi * t)))
    return torch.where(step < oc.warmup_steps, warm, cos)


def _leaves(tree) -> list:
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def init_opt_state(params, opt_dtype: str = "float32") -> Dict[str, Any]:
    """Zero moments of each param's shape in `opt_dtype`, on its device,
    and the step count (int32)."""
    dt = torch_dtype(opt_dtype)

    def zeros(tree):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device),
                        tree, is_leaf=torch.is_tensor)
    device = _leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """sqrt of the sum over the leaves of each leaf's f32 sum of squares."""
    sq = sum(torch.sum(torch.square(g.float())) for g in _leaves(tree))
    return torch.sqrt(sq)


def _clip_scale(gnorm, clip: float):
    return torch.clamp(clip / torch.clamp_min(gnorm, 1e-9), max=1.0)


def clip_by_global_norm(grads, clip: float):
    """(grads scaled so their global norm is at most `clip`, in each
    grad's dtype; the norm before)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, clip)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads,
                    is_leaf=torch.is_tensor), gn


def slices(t: torch.Tensor, limit: int = SLICE_ELEMS) -> Iterator:
    """Views of `t` along its leading axes, each of at most `limit`
    elements where one row allows (a leaf of fewer is itself)."""
    if t.numel() <= limit or t.ndim == 0:
        yield t
        return
    row = t[0].numel()
    if row > limit and t.ndim > 1:
        for r in t:
            yield from slices(r, limit)
        return
    per = max(limit // max(row, 1), 1)
    yield from torch.split(t, per)


@torch.no_grad()
def adamw_update(params, grads, opt_state, oc: OptConfig, *, gnorm=None,
                 good=None, regather=None):
    """One AdamW step, in place. Returns (params, opt_state, {"lr",
    "grad_norm"}), the same trees as given, updated.

    `grads` has the params' structure. `gnorm` is their global norm where
    the caller has it. Where `good` (a bool 0-dim tensor) is given, the
    new params, moments and step are written only where it is true.

    `regather` (the sharded train step's) holds per leaf None, or (block,
    gather) where the moments cover only `block`, a copy of a part of the
    param (and the gradient is given for that part too): the update then
    runs on `block`, and `gather(block)` is copied into the param."""
    step = opt_state["step"]
    lr = lr_at(step, oc)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, oc.clip_norm)
    b1, b2 = oc.b1, oc.b2
    t = step.float() + 1
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)

    def put(dst, new):
        dst.copy_(new if good is None else torch.where(good, new, dst))

    leaves = list(zip(*(_leaves(x) for x in (
        params, grads, opt_state["m"], opt_state["v"]))))
    for i, (p, g, m, v) in enumerate(leaves):
        re = regather[i] if regather is not None else None
        dst = p if re is None else re[0]
        for ps, gs, ms, vs in zip(slices(dst), slices(g), slices(m),
                                  slices(v)):
            gf = (gs.float() * scale).to(gs.dtype).float()
            m_new = b1 * ms.float() + (1 - b1) * gf
            v_new = b2 * vs.float() + (1 - b2) * torch.square(gf)
            delta = (m_new / c1) / (torch.sqrt(v_new / c2) + oc.eps) \
                + oc.weight_decay * ps.float()
            put(ps, (ps.float() - lr * delta).to(ps.dtype))
            put(ms, m_new.to(ms.dtype))
            put(vs, v_new.to(vs.dtype))
        if re is not None:
            p.copy_(re[1](dst))
    put(step, step + 1)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
