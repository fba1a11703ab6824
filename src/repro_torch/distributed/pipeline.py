"""GPipe-style pipeline parallelism over a mesh axis (the port of
`repro.distributed.pipeline`).

A layer stack is split into S contiguous stages, one a rank of the axis;
micro-batches stream through, and stage boundaries move activations
point to point (`dist.batch_isend_irecv` around a ring), where a pure
data-parallel axis would need an all-reduce. The bubble fraction is the
usual (S-1)/(T+S-1).

`pipeline_apply` is schedule-exact GPipe: at step t, stage s computes
micro-batch t - s; the result equals the sequential layer stack bitwise
(each layer runs the same operations on the same inputs). Any per-layer
block fn plugs in.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.pspec import tree_leaves, tree_map


def _stage_group(mesh, axis: str):
    """(the group of `axis`, this rank's stage, the stage count): a
    `DeviceMesh` and one of its dimension names, or mesh None for the
    whole world."""
    if mesh is None:
        return None, dist.get_rank(), dist.get_world_size()
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def pipeline_apply(stacked_params, xs: torch.Tensor, block_fn: Callable,
                   mesh=None, axis: str = "pod"):
    """Run a layer stack as a pipeline over `axis` of `mesh` (default:
    the whole world, one stage a rank).

    stacked_params: tree with leading dim L (layers), the same on every
                    rank (L % n_stages == 0; stage s runs layers
                    s*L/S .. (s+1)*L/S - 1)
    xs:             (n_micro, micro_batch, ...) micro-batched activations,
                    the same on every rank
    block_fn:       (layer_params, x) -> x
    Returns (n_micro, micro_batch, ...) outputs on every rank (the last
    stage's, broadcast)."""
    group, s, n_stage = _stage_group(mesh, axis)
    L = len(tree_leaves(stacked_params, is_leaf=torch.is_tensor)[0])
    if L % n_stage:
        raise ValueError(f"{L} layers do not split into {n_stage} stages")
    per = L // n_stage
    local = tree_map(lambda a: a[s * per:(s + 1) * per], stacked_params,
                     is_leaf=torch.is_tensor)
    n_micro = xs.shape[0]
    peer = (lambda r: r) if group is None else \
        (lambda r: dist.get_global_rank(group, r))
    nxt, prv = peer((s + 1) % n_stage), peer((s - 1) % n_stage)

    def local_stack(x):
        for i in range(per):
            x = block_fn(tree_map(lambda a: a[i], local,
                                  is_leaf=torch.is_tensor), x)
        return x

    buf = torch.zeros_like(xs[0])                 # incoming activation
    outs = torch.zeros_like(xs)
    for t in range(n_micro + n_stage - 1):
        x_in = xs[min(max(t, 0), n_micro - 1)] if s == 0 else buf
        y = local_stack(x_in).contiguous()
        # forward the activation to the next stage (a ring; the wrap-around
        # edge's payload is never consumed)
        recv = torch.empty_like(y)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
        idx = t - (n_stage - 1)
        if s == n_stage - 1 and 0 <= idx < n_micro:
            outs[idx] = y
        buf = recv
    # every stage gets the last stage's collected outputs
    dist.broadcast(outs, src=peer(n_stage - 1), group=group)
    return outs


def bubble_fraction(n_stage: int, n_micro: int) -> float:
    return (n_stage - 1) / (n_micro + n_stage - 1)
