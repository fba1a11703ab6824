"""Gradient compression for the data-parallel reduce: int8 with error
feedback (the port of `repro.distributed.compression`).

At many ranks the data-parallel gradient all-reduce dominates the
collective term. Each rank all-reduces an int8-quantised gradient and
keeps what the quantisation dropped as a residual, which it adds to the
next step's gradient: bias-free in the long run.

`compressed_psum` is the collective over a `torch.distributed` group (the
reference's `shard_map` body over its DP axis): the int8 payload is
all-reduced as int32, which cannot overflow, and the per-tensor scales
are summed and averaged, in the reference's order of operations.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.pspec import tree_leaves, tree_map


# 1 / 127 in f32: the reference runs under jit, where XLA turns its
# division by the constant 127 into a product with this reciprocal
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation. Returns (q, scale), scale a
    0-dim f32 tensor when x is f32: max |x| (at least 1e-30) / 127, taken
    as the reference's compiled code takes it (times `RECIP_127`)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-30) * RECIP_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group=None, residual=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with error feedback over `group` (default: the
    world). Returns (the mean gradient in x's dtype, the new residual).

    Wire cost: 1 byte an element (sent as int32 here; the sum needs its
    range) and one f32 scale a tensor, against 4 bytes an element. The
    scales are averaged (max |x| is near the same on every replica of one
    gradient; the residual absorbs the difference)."""
    n = dist.get_world_size(group)
    xf = x.float() + (0.0 if residual is None else residual)
    q, scale = quantize_int8(xf)
    new_residual = _residual(xf, q, scale)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = scale.clone()
    dist.all_reduce(ssum, group=group)
    mean = qsum.float() * (ssum / n) / n
    return mean.to(x.dtype), new_residual


def _residual(xf, q, scale):
    """xf - q * scale rounded once to f32: the reference's value under jit,
    where XLA fuses the multiply and the subtract. The difference is exact
    in f64 (q has 7 bits and the scale 24; where q != 0, |xf| >= scale / 2
    and |xf - q * scale| <= scale / 2, so about 32 bits span it)."""
    return (xf.double() - q.double() * scale.double()).float()


def init_residuals(grads) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device),
                    grads, is_leaf=torch.is_tensor)


def compressed_tree_psum(grads, group, residuals):
    """`compressed_psum` leaf by leaf over a gradient tree. Returns (the
    tree of means, the tree of new residuals)."""
    outs = iter([compressed_psum(g, group, r) for g, r in zip(
        tree_leaves(grads, is_leaf=torch.is_tensor),
        tree_leaves(residuals, is_leaf=torch.is_tensor))])
    pairs = tree_map(lambda _: next(outs), grads, is_leaf=torch.is_tensor)
    means = tree_map(lambda pr: pr[0], pairs, is_leaf=_is_pair)
    new_res = tree_map(lambda pr: pr[1], pairs, is_leaf=_is_pair)
    return means, new_res


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and torch.is_tensor(x[0])


def wire_bytes_saved(grads) -> Dict[str, float]:
    total = sum(g.numel() for g in tree_leaves(grads, is_leaf=torch.is_tensor))
    return {"fp32_bytes": 4.0 * total, "int8_bytes": 1.0 * total,
            "ratio": 4.0}
