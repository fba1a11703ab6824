"""Parameter specs: one declaration -> initialised tensors / abstract shapes.

The port's counterpart of `repro.pspec`. A model declares a tree (nested
dicts and lists) of `ParamSpec`s. From that single source come
  * real initialised tensors, drawn on the device from a `torch.Generator`
    by the reference's init rules (`init_params`),
  * tensors on PyTorch's "meta" device, which carry shape and dtype and
    allocate nothing (`abstract_params`),
  * PartitionSpecs and shardings by the logical-axis rules
    (`param_pspecs`, `param_shardings`), and DTensors placed by them
    (`place_tree`, `init_sharded`; `gather_tree` is the inverse).

The two frameworks draw different numbers from the same seed, so the tests
carry the reference's initialised weights across as numpy arrays
(`models.convert.params_from_numpy`) instead of re-drawing them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (Rules, gather, place,
                                              sharding_for, spec_for)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    return DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "float32"
    init: str = "fan_in"      # fan_in | zeros | ones | normal | embed | recurrent
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


# ---------------------------------------------------------------------------
# trees of dicts and lists (jax.tree's order: dict keys sorted)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = is_spec):
    """Apply `fn` leaf by leaf over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not is_leaf(tree):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Callable = is_spec) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)) and not is_leaf(tree):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


# ---------------------------------------------------------------------------
# init / abstract / count
# ---------------------------------------------------------------------------


def _fan_in(spec: ParamSpec) -> int:
    # the reference's rule: the first axis, which for a stacked spec is the
    # layer axis (`repro/pspec.py:_init_leaf`, its prod line overwritten)
    if len(spec.shape) > 1:
        return spec.shape[0]
    return max(spec.shape[0], 1)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if spec.init == "recurrent":
        # RG-LRU Lambda init: a in (0.9, 0.999) via softplus parametrisation
        u = torch.empty(spec.shape, **f32).uniform_(0.9, 0.999, generator=gen)
        return (-torch.log(torch.expm1(-torch.log(u)))).to(dt) * spec.scale
    x = torch.randn(spec.shape, generator=gen, **f32)
    if spec.init == "embed":
        return x.mul_(spec.scale).to(dt)
    if spec.init == "normal":
        return x.mul_(0.02 * spec.scale).to(dt)
    return x.mul_(float(spec.scale / np.sqrt(_fan_in(spec)))).to(dt)


def init_params(specs, generator: torch.Generator, device=None):
    """Initialised tensors for a tree of specs, drawn leaf by leaf (sorted
    dict keys) in f32 on `device` (default: the generator's), then cast to
    each spec's dtype. Different numbers from the reference's for the same
    seed; the same distributions."""
    device = generator.device if device is None else torch.device(device)
    return tree_map(lambda s: _init_leaf(s, generator, device), specs)


def abstract_params(specs):
    """Meta-device tensors of each spec's shape and dtype: no allocation."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                          device="meta"), specs)


def param_shardings(specs, rules: Rules, mesh):
    return tree_map(lambda s: sharding_for(s.shape, s.axes, rules, mesh),
                    specs)


def param_pspecs(specs, rules: Rules, mesh):
    return tree_map(lambda s: spec_for(s.shape, s.axes, rules, mesh), specs)


def place_tree(tree, specs, rules: Rules, mesh):
    """A tree of plain tensors (the same on every rank) as DTensors on
    `mesh`, each placed by its spec's logical axes: each rank keeps its
    own block only."""
    return tree_map(lambda t, s: place(t, sharding_for(s.shape, s.axes,
                                                       rules, mesh)),
                    tree, specs, is_leaf=torch.is_tensor)


def gather_tree(tree):
    """The inverse of `place_tree`: every DTensor leaf as its full plain
    tensor (on every rank), any other leaf as it is."""
    return tree_map(gather, tree, is_leaf=torch.is_tensor)


def init_sharded(specs, generator: torch.Generator, rules: Rules, mesh,
                 device=None):
    """`init_params`' tensors (the same draws, leaf by leaf), each placed
    on `mesh` as soon as it is drawn and the full leaf freed, so a rank
    holds at most one full leaf beside its blocks."""
    device = generator.device if device is None else torch.device(device)
    return tree_map(lambda s: place(_init_leaf(s, generator, device),
                                    sharding_for(s.shape, s.axes, rules,
                                                 mesh)), specs)


def count_params(specs) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


def stack_specs(spec: ParamSpec, n: int) -> ParamSpec:
    """Add a leading stacked-layers dim (the reference's scan axis)."""
    return ParamSpec((n,) + spec.shape, ("layers",) + spec.axes,
                     spec.dtype, spec.init, spec.scale)
