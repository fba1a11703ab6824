"""The ops a program dispatches, recorded: the substrate of the analysis
passes. Counterpart of `repro.analysis.jaxpr`.

The reference walks the jaxpr `jax.make_jaxpr` returns, never running the
program. PyTorch runs eagerly, so the port records the program's dispatch
instead: `record_ops(fn, *args)` runs `fn` under a `TorchDispatchMode`
that logs every op reaching the dispatcher (each hand kernel is one
`repro_torch` op, `kernels.library`) with its operands, results and the
operands it writes, their shapes, dtypes, devices, strides and offsets.
With ``execute=False`` (the default) it runs `fn` under `FakeTensorMode`:
the tensor arguments are converted with `from_tensor` on their own device,
every op runs its fake implementation, and no kernel runs and no card is
touched. That is the port's `make_jaxpr`. With ``execute=True`` it records
a live run. Inside `fake_mode()` the caller builds fake inputs itself (on
"cuda", on a machine without a card) and `record_ops` traces within it.

Each record carries the scope the drivers gave it (`library.scope`): the
shard and the substep-block it belongs to, which the ledger's per-shard,
per-block counts read.

`tensor_bytes` is `aval_bytes`; `fingerprint_parts` and
`structural_fingerprint` hash a stream of records for the retrace
detector. Python scalars are abstracted ("lit"), as the reference
abstracts literals, except the integer arguments a `repro_torch` op
declares as its launch configuration (`library.OpInfo.static`: depth,
tile, plan), the counterpart of a `pallas_call`'s grid in its params.
"""
from __future__ import annotations

import contextlib
import hashlib
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import library as L

__all__ = [
    "TensorMeta", "OpRecord", "record_ops", "fake_mode", "tensor_bytes",
    "fingerprint_parts", "structural_fingerprint",
]


@dataclass(frozen=True)
class TensorMeta:
    """What a record keeps of one tensor: its shape, dtype, device, element
    strides, storage offset (elements), its storage's bytes and whether a
    kernel may read it as one dense block."""
    shape: Tuple[int, ...]
    dtype: str
    device: str
    stride: Tuple[int, ...]
    offset: int
    itemsize: int
    storage_nbytes: int
    contiguous: bool

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.itemsize

    @property
    def byte_offset(self) -> int:
        return self.offset * self.itemsize

    @property
    def device_type(self) -> str:
        return self.device.split(":")[0]

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorMeta":
        try:
            storage = t.untyped_storage().nbytes()
        except (RuntimeError, NotImplementedError):
            storage = -1
        return cls(tuple(int(s) for s in t.shape), str(t.dtype).split(".")[-1],
                   str(t.device), tuple(int(s) for s in t.stride()),
                   int(t.storage_offset()), t.element_size(), storage,
                   t.is_contiguous())


def tensor_bytes(t) -> int:
    """Bytes of a tensor or a `TensorMeta` (the reference's `aval_bytes`)."""
    if isinstance(t, TensorMeta):
        return t.nbytes
    return t.numel() * t.element_size()


@dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its qualified name (``repro_torch::advect_fused``,
    ``aten::add.Tensor``), its `library.OPS` name for a kernel op, its
    arguments by name (a `TensorMeta`, a tuple of them, or a scalar), its
    results, the arguments it writes, and its scope."""
    name: str
    op: Optional[str]
    args: Tuple[Tuple[str, Any], ...]
    results: Tuple[TensorMeta, ...]
    mutated: Tuple[str, ...]
    shard: Optional[int] = None
    block: Optional[int] = None
    extra: Any = field(default=None, compare=False)

    def arg(self, name: str):
        for key, value in self.args:
            if key == name:
                return value
        raise KeyError(f"{self.name} has no argument {name!r}")

    def tensors(self, name: str) -> Tuple[TensorMeta, ...]:
        value = self.arg(name)
        return value if isinstance(value, tuple) else (value,)

    def operands(self) -> List[Tuple[str, TensorMeta]]:
        """(argument name, meta) of every tensor argument, lists flattened."""
        out = []
        for key, value in self.args:
            if isinstance(value, TensorMeta):
                out.append((key, value))
            elif isinstance(value, tuple):
                out.extend((key, v) for v in value
                           if isinstance(v, TensorMeta))
        return out


def _meta(value):
    if isinstance(value, torch.Tensor):
        return TensorMeta.of(value)
    if isinstance(value, (list, tuple)):
        if any(isinstance(v, torch.Tensor) for v in value):
            return tuple(_meta(v) for v in value)
        return tuple(value)
    if isinstance(value, (torch.device, torch.dtype)):
        return str(value)
    return value


def _results(out) -> Tuple[TensorMeta, ...]:
    if isinstance(out, torch.Tensor):
        return (TensorMeta.of(out),)
    if isinstance(out, (list, tuple)):
        return tuple(m for o in out for m in _results(o))
    return ()


class _Recorder(TorchDispatchMode):
    """Logs every op that reaches the dispatcher under it."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        named, mutated = [], []
        for i, a in enumerate(schema.arguments):
            if i < len(args):
                value = args[i]
            elif a.name in kwargs:
                value = kwargs[a.name]
            else:
                continue
            named.append((a.name, _meta(value)))
            if a.alias_info is not None and a.alias_info.is_write:
                mutated.append(a.name)
        op = L.op_name(func)
        extra = None
        if op is not None and L.OPS[op].kind == "band":
            from repro_torch.kernels.advection import advection as K
            extra = K.band_movement(dict(named)["table"])
        name = schema.name + ("." + schema.overload_name
                              if schema.overload_name else "")
        self.records.append(OpRecord(
            name, op, tuple(named), _results(out), tuple(mutated),
            *L.current_scope(), extra))
        return out


# ---------------------------------------------------------------------------
# fake tensors on a machine without a card
# ---------------------------------------------------------------------------

_ACTIVE: List = []      # the fake modes `fake_mode` entered, innermost last


def _guard_free_methods():
    """On a build without CUDA the Python bindings of indexing, `copy_`,
    `contiguous`, `~` and `to` open a CUDA device guard for a fake CUDA
    tensor (or a move to one) and fail; these stand-ins dispatch the same
    aten ops without one."""
    aten = torch.ops.aten

    def index(t, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, (torch.Tensor, list)) for i in idx):
            return aten.index.Tensor(t, [i if isinstance(i, torch.Tensor)
                                         else torch.as_tensor(i, device=t.device)
                                         for i in idx])
        real = sum(i is not None and i is not Ellipsis for i in idx)
        out, d = t, 0
        for i in idx:
            if i is Ellipsis:
                d += t.dim() - real
            elif i is None:
                out, d = aten.unsqueeze.default(out, d), d + 1
            elif isinstance(i, bool):
                raise TypeError("bool indices are not traced")
            elif isinstance(i, int):
                out = aten.select.int(out, d, i)
            else:
                out = aten.slice.Tensor(out, d, i.start, i.stop, i.step or 1)
                d += 1
        return out

    def setitem(t, idx, value):
        dst = index(t, idx)
        if isinstance(value, torch.Tensor):
            aten.copy_.default(dst, value)
        else:
            aten.fill_.Scalar(dst, value)

    def copy_(t, src, non_blocking=False):
        return aten.copy_.default(t, src, non_blocking)

    def contiguous(t, memory_format=torch.contiguous_format):
        if t.is_contiguous(memory_format=memory_format):
            return t
        return aten.clone.default(t, memory_format=memory_format)

    def invert(t):
        return aten.bitwise_not.default(t)

    def to(t, *args, **kwargs):
        copy = kwargs.pop("copy", False)
        device, dtype, non_blocking = torch._C._nn._parse_to(
            *args, **kwargs)[:3]
        device = t.device if device is None else torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        dtype = t.dtype if dtype is None else dtype
        if device == t.device and dtype == t.dtype and not copy:
            return t
        return aten._to_copy.default(t, dtype=dtype, device=device,
                                     non_blocking=non_blocking)

    return {"__getitem__": index, "__setitem__": setitem, "copy_": copy_,
            "contiguous": contiguous, "__invert__": invert, "to": to}


@contextlib.contextmanager
def fake_mode():
    """A `FakeTensorMode` to build fake inputs in (``device="cuda"`` works
    on a machine without a card) and trace in; `record_ops` inside it
    traces in it. Real tensors met inside are taken as constants."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    saved = {}
    if not torch.cuda.is_available():
        for name, fn in _guard_free_methods().items():
            saved[name] = FakeTensor.__dict__.get(name)
            setattr(FakeTensor, name, fn)
    _ACTIVE.append(mode)
    try:
        with mode:
            yield mode
    finally:
        _ACTIVE.pop()
        for name, fn in saved.items():
            if fn is None:
                delattr(FakeTensor, name)
            else:
                setattr(FakeTensor, name, fn)


# ---------------------------------------------------------------------------
# DTensor's private internals, patched in one place
# ---------------------------------------------------------------------------

_PLANNING = [0]          # DTensor planning calls in progress
_PATCHED: dict = {}      # (owner, name) -> the original, while patched


def dtensor_planning() -> bool:
    """Whether a DTensor planning call is in progress: sharding propagation
    or strided-shard geometry, which run ops on fake tensors of the global
    shapes to learn metadata, not on a rank's data."""
    return _PLANNING[0] > 0


def _planning(orig, unfaked: bool = False):
    """`orig` counted as planning; with `unfaked`, run outside the ambient
    fake mode (`_StridedShard.local_shard_size_and_offset` builds an index
    tensor with `torch.arange` and reads it back, which a fake tensor
    cannot do)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def planning(*args, **kwargs):
        _PLANNING[0] += 1
        try:
            if not unfaked:
                return orig(*args, **kwargs)
            with unset_fake_temporarily():
                return orig(*args, **kwargs)
        finally:
            _PLANNING[0] -= 1
    return planning


def _card_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as the all-to-all it dispatches on a
    CUDA mesh (`_dtensor::shard_dim_alltoall`), whatever the mesh's
    device type."""
    from torch.distributed import _functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


_SHARDING_PROP = "torch.distributed.tensor._sharding_prop"
_PLACEMENTS = "torch.distributed.tensor.placement_types"
# (module, class in it or None for the module, attribute, its stand-in)
DTENSOR_SITES = (
    (_SHARDING_PROP, "ShardingPropagator",
     "_propagate_tensor_meta_non_cached", _planning),
    (_SHARDING_PROP, "ShardingPropagator",
     "propagate_op_sharding_non_cached", _planning),
    (_PLACEMENTS, "_StridedShard", "local_shard_size_and_offset",
     lambda orig: _planning(orig, unfaked=True)),
)
CARD_ALLTOALL_SITE = (_PLACEMENTS, None, "shard_dim_alltoall",
                      lambda orig: _card_alltoall)


def _site_owner(mod_name: str, cls_name: Optional[str], name: str):
    import importlib
    owner = importlib.import_module(mod_name)
    if cls_name is not None:
        owner = getattr(owner, cls_name, None)
    orig = None if owner is None else vars(owner).get(name)
    if orig is None or isinstance(orig, (staticmethod, classmethod)):
        where = ".".join(filter(None, (mod_name, cls_name, name)))
        raise RuntimeError(f"{where} is not a plain function in torch "
                           f"{torch.__version__}; the DTensor trace patches "
                           "it and cannot count ranks' work without it")
    return owner, orig


@contextlib.contextmanager
def dtensor_internals(*, card_alltoall: bool = False):
    """Every patch the port makes to DTensor's private internals, for the
    duration: its planning calls (`DTENSOR_SITES`) counted by
    `dtensor_planning` and the strided-shard geometry run outside the fake
    mode; with `card_alltoall`, the shard-to-shard move dispatched as the
    all-to-all of a CUDA mesh. Re-entrant: a site already patched by an
    enclosing call is left as it is. Raises where a site is missing."""
    sites = DTENSOR_SITES + ((CARD_ALLTOALL_SITE,) if card_alltoall else ())
    found = [(*_site_owner(m, c, name), name, wrap)
             for m, c, name, wrap in sites]
    mine = []
    try:
        for owner, orig, name, wrap in found:
            if (owner, name) not in _PATCHED:
                _PATCHED[(owner, name)] = orig
                mine.append((owner, name))
                setattr(owner, name, wrap(orig))
        yield
    finally:
        for owner, name in reversed(mine):
            setattr(owner, name, _PATCHED.pop((owner, name)))


def _to_fake(mode, value):
    if isinstance(value, torch.Tensor):
        return value if L.is_fake(value) else mode.from_tensor(value)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_to_fake(mode, v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_to_fake(mode, v) for v in value)
    if isinstance(value, dict):
        return {k: _to_fake(mode, v) for k, v in value.items()}
    return value


def record_ops(fn, *args, execute: bool = False, **kwargs) -> List[OpRecord]:
    """The op records of `fn(*args, **kwargs)`: traced on fake tensors,
    running no kernel (``execute=False``), or recorded live."""
    if execute:
        with _Recorder() as rec:
            fn(*args, **kwargs)
        return rec.records
    ctx = contextlib.nullcontext(_ACTIVE[-1]) if _ACTIVE else fake_mode()
    with ctx as mode:
        args = _to_fake(mode, args)
        kwargs = _to_fake(mode, kwargs)
        with _Recorder() as rec:
            fn(*args, **kwargs)
    return rec.records


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def _meta_str(m: TensorMeta) -> str:
    return f"{m.shape}:{m.dtype}:{m.device}"


def _value_str(value, keep: bool) -> str:
    if isinstance(value, TensorMeta):
        return _meta_str(value)
    if isinstance(value, tuple) and value and all(
            isinstance(v, TensorMeta) for v in value):
        return "[" + ",".join(_meta_str(v) for v in value) + "]"
    if isinstance(value, (bool, int, float)) or (
            isinstance(value, tuple) and all(isinstance(v, (int, float))
                                             for v in value)):
        return repr(value) if keep else "lit"
    return repr(value)


def fingerprint_parts(records) -> List[str]:
    """One line per record: the op, its arguments (tensors as shape, dtype
    and device; Python scalars abstracted, but for a kernel op's launch
    configuration) and its results. The retrace detector diffs two of these
    lists to name the first op where two streams diverge."""
    parts = []
    for r in records:
        static = L.OPS[r.op].static if r.op is not None else ()
        args = ";".join(f"{k}={_value_str(v, k in static)}"
                        for k, v in r.args)
        parts.append("|".join((r.name, args,
                               ",".join(_meta_str(m) for m in r.results))))
    return parts


def structural_fingerprint(records) -> str:
    """Hex digest of a record stream's structure: two streams with equal
    fingerprints dispatch the same ops on the same shapes, whatever the
    values of their scalars."""
    return hashlib.sha256(
        "\n".join(fingerprint_parts(records)).encode()).hexdigest()[:16]
