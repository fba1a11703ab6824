"""The port's hand kernels as `torch.library` ops in the `repro_torch`
namespace, and the scope the drivers give the ops they dispatch.

Each kernel module defines its ops with `define`: a flat schema (tensors,
ints, floats, bools and lists of them), a CPU implementation (the kernel's
plain version), a CUDA implementation (the launch) and a fake one (outputs
of the real ones' shape, dtype, device and strides). A wrapper checks its
arguments, plans what needs no card and calls the op; the dispatcher picks
the implementation from the tensors' device, so a CUDA tensor never
reaches the plain version, and a trace under `FakeTensorMode` runs the
fake implementation and touches no card. The ops are the port's
counterpart of `pallas_call` in a jaxpr: `analysis.trace.record_ops` sees
each of them, with its operands, on either device.

`band_send` is not a kernel: it is the port's counterpart of `ppermute`,
one band (or checksum word) sent from shard `sender` to a device, through
which the collective exchange and K7's plain version send every message.
A recording sees the collective exchange's sends; K7's plain version sends
inside K7's op, where a dispatch mode is suspended, so a ledger prices
K7's messages from its table instead.

`OPS` keeps what the analysis passes read of each op: its movement class
(`field`, `guard`, `band` or `send`) and the integer arguments that are its
launch configuration (kept in a trace's fingerprint, where other scalars
are abstracted).

`scope(shard=..., block=...)` marks the ops dispatched inside it: the
distributed drivers run each substep-block in a fresh block scope and each
shard's compute in its shard scope, so that a ledger can count per shard
and per block (`analysis.ledger.MovementLedger.per_shard_block`).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


class OpInfo(NamedTuple):
    """What the analysis passes read of one op: `kind` is ``field`` (the
    operands and results are streams the kernel moves), ``guard`` (the
    finite guard's re-read), ``band`` (K7: its messages come from its
    table) or ``send`` (`band_send`); `static` names the integer arguments
    that configure the launch."""
    name: str
    kind: str
    static: Tuple[str, ...]


OPS: Dict[str, OpInfo] = {}


def define(name: str, schema: str, *, kind: str, cpu: Callable,
           cuda: Callable, fake: Callable, static: Tuple[str, ...] = ()):
    """Define ``repro_torch::<name>`` with `schema` (its arguments and
    results, without the name) and its three implementations; returns the
    op's default overload."""
    if name in OPS:
        raise ValueError(f"op {NAMESPACE}::{name} is already defined")
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    OPS[name] = OpInfo(name, kind, tuple(static))
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def op_name(func) -> Optional[str]:
    """The `OPS` name of a dispatched op overload, or None for another."""
    schema = getattr(func, "_schema", None)
    if schema is None or not schema.name.startswith(NAMESPACE + "::"):
        return None
    return schema.name.split("::", 1)[1]


# ---------------------------------------------------------------------------
# the ops' scope
# ---------------------------------------------------------------------------

_SCOPE = contextvars.ContextVar("repro_torch_scope", default=(None, None))
_BLOCKS = itertools.count()


def current_scope() -> Tuple[Optional[int], Optional[int]]:
    """(shard, block serial) of the ops dispatched now; None outside."""
    return _SCOPE.get()


@contextlib.contextmanager
def scope(*, shard: Optional[int] = None, block: bool = False):
    """Mark what is dispatched inside as shard `shard`'s work, and with
    `block=True` as one new substep-block (a fresh serial, so two calls at
    the same block index count as two blocks)."""
    shard_now, block_now = _SCOPE.get()
    if block:
        token = _SCOPE.set((shard, next(_BLOCKS)))
    else:
        token = _SCOPE.set((shard_now if shard is None else shard,
                            block_now))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def is_fake(t) -> bool:
    """Whether `t` is a fake tensor (a trace under FakeTensorMode)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


# ---------------------------------------------------------------------------
# band_send: the counterpart of ppermute
# ---------------------------------------------------------------------------


def _band_send_impl(band, device, sender):
    del sender
    return band.to(device, copy=True)


def _band_send_fake(band, device, sender):
    del sender
    return torch.empty_like(band, device=device)


_band_send = define(
    "band_send", "(Tensor band, Device device, int sender) -> Tensor",
    kind="send", cpu=_band_send_impl, cuda=_band_send_impl,
    fake=_band_send_fake)


def band_send(band: torch.Tensor, device, sender: int) -> torch.Tensor:
    """Shard `sender`'s `band` as a new tensor on `device`: one message of
    an exchange (a band of planes or rows, or its checksum word)."""
    return _band_send(band, torch.device(device), int(sender))
