"""The port's kernels and their wrappers.

The kernel routes (K8's flash attention, K9's selective scan) are
forward-only, as the reference's Pallas calls are (`jax.grad` through
them fails in `_pallas_call_jvp_rule`): their CUDA outputs carry no
autograd history, so a wrapper refuses a call that would need one
(`refuse_grad`) on either device, rather than drop the gradient on the
card."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise RuntimeError when autograd is on and any of `tensors` requires
    grad: `name`'s kernel route has no backward."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: its kernel route has no backward and "
            f"returns outputs without autograd history; train with "
            f"attention_impl='flash' or 'chunked', or call it under "
            f"torch.no_grad()")
