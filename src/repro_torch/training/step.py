"""Train, prefill and serve steps (the port of `repro.training.step`).

    step = make_train_step(cfg, layout, opt=OptConfig(...))
    state, metrics = step(state, batch)        # state updated in place

A train state is the reference's: {"params", "opt": {"m", "v", "step"}},
trees of tensors on one device. The gradients come from autograd over the
parameter tree: the leaves are marked `requires_grad` for the step only,
and each stacked layer tree (`layers`, `enc_layers`, `dec_layers`) is
split into per-layer views first (`split_layers`), so every layer's
weights are a leaf of their own. That gives the same gradients as the
stacked leaf, without the full-size zero buffer the backward of each
layer's index into a stacked leaf would fill. `cfg.grad_accum` micro-
batches are summed in f32, then divided, as the reference's scan does.
The NaN guard is the reference's, in-graph: `good = isfinite(loss) &
isfinite(grad_norm)`, and a step that is not good leaves the params and
moments unchanged, bitwise (`optimizer.adamw_update(good=)`), with no
wait for the host.

Under a `DeviceMesh` with rules (`make_train_step(cfg, layout, rules,
mesh)`) the params and moments are DTensors placed by `state_specs`'
logical axes (`place_state`, `init_sharded_state`), and each batch, given
as plain tensors the same on every rank, is split over the `batch` rule
(micro-batches first cut from the whole batch). The gradients are the
DTensors autograd returns, redistributed to their moments' placements
(the sum over "data"). The global norm is taken on those DTensors, so the
squares of a sharded leaf are summed over every shard and those of a
replicated one once. AdamW then runs in place on each rank's local
shards; a leaf whose moments are placed otherwise than the param
(`opt_expert_embed`: EP-resident experts replicated over "data", their
moments sharded over it) is updated on the moments' block and the new
block gathered over the mesh, once a step. The NaN guard stays in-graph.
The metrics come back as plain tensors, the same on every rank. On one
card a (1, 1) mesh runs the same operations as the plain path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import pspec
from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import (Rules, gather, is_device_mesh,
                                              is_dtensor, place,
                                              sharding_for)
from repro_torch.models import model as M
from repro_torch.training import optimizer as O

STACKS = ("layers", "enc_layers", "dec_layers")


def split_layers(tree):
    """`tree` with each stacked layer tree (a dict under `STACKS`, leaves
    of shape (n_layers, ...)) as a list of per-layer trees of views (a
    list stays as it is). Works on any tree of that structure: params,
    moments or gradients, tensors or numpy arrays."""
    out = dict(tree)
    for key in STACKS:
        sub = tree.get(key)
        if isinstance(sub, dict):
            n = len(pspec.tree_leaves(sub, is_leaf=lambda x: hasattr(
                x, "shape"))[0])
            out[key] = [pspec.tree_map(lambda a, i=i: a[i], sub,
                                       is_leaf=lambda x: hasattr(x, "shape"))
                        for i in range(n)]
    return out


def _as_leaves(params):
    """(`split_layers(params)` with every leaf a detached view that
    requires grad, the list of those leaves)."""
    split = pspec.tree_map(lambda a: a.detach().requires_grad_(True),
                           split_layers(params), is_leaf=torch.is_tensor)
    return split, pspec.tree_leaves(split, is_leaf=torch.is_tensor)


def loss_and_grads(params, batch, cfg: ArchConfig, layout, *,
                   poison: bool = False, rules: Optional[Rules] = None,
                   mesh=None):
    """(loss, metrics, grads): `M.loss_fn` and its gradient with respect
    to every parameter, the gradients in `split_layers(params)`'s
    structure (tensors of their own). `poison=True` multiplies the loss
    by NaN before differentiating (a step whose loss is not finite)."""
    split, leaves = _as_leaves(params)
    # the sharded context spans the backward too (remat recomputes there)
    with torch.enable_grad(), M.sharded_context(rules, mesh):
        loss, metrics = M.loss_fn(split, batch, cfg, layout, rules=rules,
                                  mesh=mesh)
        if poison:
            loss = loss * float("nan")
            metrics = {**metrics, "loss": loss}
        # a leaf the loss does not reach (k's projection under the
        # `skip_core` lowering) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    tree = pspec.tree_map(lambda _: next(it), split, is_leaf=torch.is_tensor)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree


def _micro(batch, accum: int, i: int):
    """Micro-batch i of `accum` along the leading (batch) axis."""
    def cut(a):
        n = a.shape[0] // accum
        return a[i * n:(i + 1) * n]
    return {k: cut(v) for k, v in batch.items()}


def place_batch(batch, rules: Rules, mesh):
    """A batch of plain tensors (the same on every rank) as DTensors split
    over the `batch` rule on their leading axis; a DTensor (a batch the
    caller placed, as the dry run does) stays as it is."""
    return {k: v if is_dtensor(v) else place(v, sharding_for(
        v.shape, ("batch",) + (None,) * (v.ndim - 1), rules, mesh))
        for k, v in batch.items()}


def accumulated_grads(params, batch, cfg: ArchConfig, layout, *,
                      poison: bool = False, rules: Optional[Rules] = None,
                      mesh=None):
    """(metrics, grads) of one step's batch: `loss_and_grads` over the
    whole batch, or with `cfg.grad_accum` > 1 over that many micro-
    batches, the gradients summed in f32 and divided, the loss averaged
    (metrics "aux" is then 0, as in the reference). Under a `DeviceMesh`
    each (micro-)batch is placed by `place_batch`."""
    def run(b):
        if rules and is_device_mesh(mesh):
            b = place_batch(b, rules, mesh)
        return loss_and_grads(params, b, cfg, layout, poison=poison,
                              rules=rules, mesh=mesh)

    accum = cfg.grad_accum
    if accum <= 1:
        _, metrics, grads = run(batch)
        return metrics, grads
    gsum = lsum = None
    for i in range(accum):
        loss, _, grads = run(_micro(batch, accum, i))
        grads = pspec.tree_map(lambda g: g.float(), grads,
                               is_leaf=torch.is_tensor)
        if gsum is None:
            gsum, lsum = grads, loss
        else:
            gsum = pspec.tree_map(torch.add, gsum, grads,
                                  is_leaf=torch.is_tensor)
            lsum = lsum + loss
    grads = pspec.tree_map(lambda g: g / accum, gsum, is_leaf=torch.is_tensor)
    loss = lsum / accum
    return {"loss": loss, "aux": torch.zeros_like(loss)}, grads


def make_train_step(cfg: ArchConfig, layout, rules: Optional[Rules] = None,
                    mesh=None, *, opt: O.OptConfig = O.OptConfig()):
    """Returns step(state, batch, poison=False) -> (state, metrics), the
    state updated in place. metrics: "loss", "aux", "lr", "grad_norm",
    "good" (0-dim tensors on the state's device). `poison=True` multiplies
    the loss by NaN before differentiating: a step with a non-finite loss
    (the train loop's fault injection for batches with no float input).
    With `rules` and a `DeviceMesh` the state is sharded (the module's
    docstring); else this is the single-device step."""
    if rules and is_device_mesh(mesh):
        return _sharded_train_step(cfg, layout, rules, mesh, opt)

    def step(state, batch, poison: bool = False):
        metrics, grads = accumulated_grads(state["params"], batch, cfg,
                                           layout, poison=poison)
        gnorm = O.global_norm(grads)
        good = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        _, _, om = O.adamw_update(split_layers(state["params"]), grads,
                                  split_opt(state["opt"]), opt,
                                  gnorm=gnorm, good=good)
        return state, {**metrics, **om, "good": good}

    return step


def _local(tree):
    return pspec.tree_map(lambda t: t.to_local(), tree,
                          is_leaf=torch.is_tensor)


def _sharded_train_step(cfg: ArchConfig, layout, rules: Rules, mesh,
                        opt: O.OptConfig):
    def step(state, batch, poison: bool = False):
        params = split_layers(state["params"])
        opt_state = split_opt(state["opt"])
        metrics, grads = accumulated_grads(state["params"], batch, cfg,
                                           layout, poison=poison,
                                           rules=rules, mesh=mesh)
        # each gradient as its moments are placed: summed over "data"
        # where they are replicated there, reduced to a shard where they
        # are sharded (the moments of EP-resident experts)
        grads = pspec.tree_map(
            lambda g, m: g.redistribute(m.device_mesh, m.placements),
            grads, opt_state["m"], is_leaf=torch.is_tensor)
        with M.sharded_context(rules, mesh):
            gnorm = gather(O.global_norm(grads))
        metrics = {k: gather(v) for k, v in metrics.items()}
        good = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        _, _, om = O.adamw_update(
            _local(params), _local(grads), _local(opt_state), opt,
            gnorm=gnorm, good=good,
            regather=_regathers(params, opt_state["m"]))
        return state, {**metrics, **om, "good": good}

    return step


def _regathers(params, moments) -> list:
    """Per leaf (in `tree_leaves` order), None where the moment is placed
    as its param, else (block, gather): the index block of the param's
    local shard the moment's shard covers, and a function from the updated
    block to the param's new local shard (gathered over the mesh)."""
    from torch.distributed.tensor import DTensor
    out = []
    for p, m in zip(pspec.tree_leaves(params, is_leaf=torch.is_tensor),
                    pspec.tree_leaves(moments, is_leaf=torch.is_tensor)):
        if tuple(p.placements) == tuple(m.placements):
            out.append(None)
            continue

        def regather(blk, p=p, m=m):
            d = DTensor.from_local(blk, m.device_mesh, m.placements,
                                   run_check=False, shape=m.shape,
                                   stride=m.stride())
            return d.redistribute(p.device_mesh, p.placements).to_local()
        # the moment's block of the param: redistributing the param to
        # the moment's placements only narrows it (Replicate -> Shard)
        probe = p.redistribute(m.device_mesh, m.placements).to_local()
        out.append((probe, regather))
    return out


def split_opt(opt_state):
    """An AdamW state with its moments `split_layers`'d (views)."""
    return {"m": split_layers(opt_state["m"]),
            "v": split_layers(opt_state["v"]), "step": opt_state["step"]}


def make_prefill_step(cfg: ArchConfig, layout, rules: Optional[Rules] = None,
                      mesh=None):
    """step(params, batch) -> (last position's logits, caches). Under a
    `DeviceMesh` with rules the params are DTensors, a batch of plain
    tensors is placed by `place_batch`, and the logits and caches come
    back as DTensors (`pspec.gather_tree` makes them plain)."""
    sharded = bool(rules) and is_device_mesh(mesh)

    @torch.no_grad()
    def step(params, batch):
        if sharded:
            batch = place_batch(batch, rules, mesh)
        logits, _, caches = M.forward(params, batch, cfg, layout,
                                      rules=rules, mesh=mesh, mode="prefill")
        return logits[:, -1], caches
    return step


def make_serve_step(cfg: ArchConfig, layout, rules: Optional[Rules] = None,
                    mesh=None):
    """step(params, caches, batch) -> (logits, caches), one decode step
    (the caches updated in place); under a `DeviceMesh` with rules as
    `make_prefill_step`."""
    sharded = bool(rules) and is_device_mesh(mesh)

    @torch.no_grad()
    def step(params, caches, batch):
        if sharded:
            batch = place_batch(batch, rules, mesh)
        return M.decode_step(params, caches, batch, cfg, layout, rules=rules,
                             mesh=mesh)
    return step


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def state_specs(cfg: ArchConfig, layout) -> Dict[str, Any]:
    """ParamSpec tree of the whole train state (params + AdamW moments in
    `cfg.opt_dtype` + the int32 step), the reference's. EP-resident
    expert weights (`expert_embed` axis) are replicated over `data`, but
    their moments ZeRO-1-shard over it (the `opt_expert_embed` rule; the
    update's new block is gathered once a step)."""
    ps = M.param_specs(cfg, layout)

    def moment(s):
        axes = tuple("opt_expert_embed" if a == "expert_embed" else a
                     for a in s.axes)
        return pspec.ParamSpec(s.shape, axes, cfg.opt_dtype, "zeros")
    return {"params": ps,
            "opt": {"m": pspec.tree_map(moment, ps),
                    "v": pspec.tree_map(moment, ps),
                    "step": pspec.ParamSpec((), (), "int32", "zeros")}}


def init_state(cfg: ArchConfig, layout, generator: torch.Generator,
               device=None) -> Dict[str, Any]:
    """Params drawn from `generator` on `device` (default: the
    generator's) by the reference's init rules, zero moments."""
    params = pspec.init_params(M.param_specs(cfg, layout), generator, device)
    return {"params": params, "opt": O.init_opt_state(params, cfg.opt_dtype)}


def tree_shardings(specs, rules: Rules, mesh):
    return pspec.param_shardings(specs, rules, mesh)


def tree_abstract(specs):
    return pspec.abstract_params(specs)


def place_state(state, cfg: ArchConfig, layout, rules: Rules, mesh):
    """A train state of plain tensors (the same on every rank) as DTensors
    placed by `state_specs`."""
    return pspec.place_tree(state, state_specs(cfg, layout), rules, mesh)


def init_sharded_state(cfg: ArchConfig, layout, generator: torch.Generator,
                       rules: Rules, mesh, device=None) -> Dict[str, Any]:
    """`init_state`'s params (the same draws) placed on `mesh` leaf by
    leaf, and zero moments placed by their own specs."""
    specs = state_specs(cfg, layout)
    params = pspec.init_sharded(specs["params"], generator, rules, mesh,
                                device)
    opt = pspec.init_sharded(specs["opt"], generator, rules, mesh, device)
    return {"params": params, "opt": opt}
