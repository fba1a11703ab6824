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

`tree_shardings` and `tree_abstract` wait for slice G2b (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import pspec
from repro_torch.config import ArchConfig
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
                   poison: bool = False):
    """(loss, metrics, grads): `M.loss_fn` and its gradient with respect
    to every parameter, the gradients in `split_layers(params)`'s
    structure (tensors of their own). `poison=True` multiplies the loss
    by NaN before differentiating (a step whose loss is not finite)."""
    split, leaves = _as_leaves(params)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(split, batch, cfg, layout)
        if poison:
            loss = loss * float("nan")
            metrics = {**metrics, "loss": loss}
        grads = torch.autograd.grad(loss, leaves)
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


def accumulated_grads(params, batch, cfg: ArchConfig, layout, *,
                      poison: bool = False):
    """(metrics, grads) of one step's batch: `loss_and_grads` over the
    whole batch, or with `cfg.grad_accum` > 1 over that many micro-
    batches, the gradients summed in f32 and divided, the loss averaged
    (metrics "aux" is then 0, as in the reference)."""
    accum = cfg.grad_accum
    if accum <= 1:
        _, metrics, grads = loss_and_grads(params, batch, cfg, layout,
                                           poison=poison)
        return metrics, grads
    gsum = lsum = None
    for i in range(accum):
        loss, _, grads = loss_and_grads(params, _micro(batch, accum, i), cfg,
                                        layout, poison=poison)
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


def make_train_step(cfg: ArchConfig, layout, *,
                    opt: O.OptConfig = O.OptConfig()):
    """Returns step(state, batch, poison=False) -> (state, metrics), the
    state updated in place. metrics: "loss", "aux", "lr", "grad_norm",
    "good" (0-dim tensors on the state's device). `poison=True` multiplies
    the loss by NaN before differentiating: a step with a non-finite loss
    (the train loop's fault injection for batches with no float input)."""

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


def split_opt(opt_state):
    """An AdamW state with its moments `split_layers`'d (views)."""
    return {"m": split_layers(opt_state["m"]),
            "v": split_layers(opt_state["v"]), "step": opt_state["step"]}


def make_prefill_step(cfg: ArchConfig, layout):
    """step(params, batch) -> (last position's logits, caches)."""
    @torch.no_grad()
    def step(params, batch):
        logits, _, caches = M.forward(params, batch, cfg, layout,
                                      mode="prefill")
        return logits[:, -1], caches
    return step


def make_serve_step(cfg: ArchConfig, layout):
    """step(params, caches, batch) -> (logits, caches), one decode step
    (the caches updated in place)."""
    @torch.no_grad()
    def step(params, caches, batch):
        return M.decode_step(params, caches, batch, cfg, layout)
    return step


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def state_specs(cfg: ArchConfig, layout) -> Dict[str, Any]:
    """ParamSpec tree of the whole train state (params + AdamW moments in
    `cfg.opt_dtype` + the int32 step), the reference's. Its logical axes
    (`opt_expert_embed` for the moments of EP-resident experts) wait for
    the sharding rules of slice G2b."""
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
