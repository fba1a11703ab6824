"""Carry the reference's parameters into the port.

`params_from_numpy(tree, device=...)` turns the JAX package's parameter
tree, given as numpy arrays (`jax.tree.map(np.asarray, params)`), into the
port's tree of tensors, on the card unless the caller asks for "cpu" (as
the stencil side's `params_from_numpy` does). The two layouts are the same
leaf for leaf (the stacked `(n_layers, ...)` axis included), so both
packages then compute the same function on the same weights. bfloat16
arrays (numpy's `ml_dtypes` bfloat16) come across bit for bit.
`state_from_numpy` carries a whole train state ({"params", "opt": {"m",
"v", "step"}}) the same way, so both packages start a step from the same
state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.pspec import tree_map


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array as a tensor of the same dtype and bits."""
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, *, device="cuda"):
    """A tree (dicts and lists) of numpy arrays as a tree of tensors."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree,
                    is_leaf=lambda x: isinstance(x, np.ndarray))


def state_from_numpy(state, *, device="cuda"):
    """The reference's train state, as numpy arrays, as the port's: params
    and AdamW moments tensor for tensor, the step an int32 0-dim tensor."""
    opt = state["opt"]
    return {"params": params_from_numpy(state["params"], device=device),
            "opt": {"m": params_from_numpy(opt["m"], device=device),
                    "v": params_from_numpy(opt["v"], device=device),
                    "step": torch.tensor(int(opt["step"]), dtype=torch.int32,
                                         device=device)}}
