"""The collective inventory and op census of a program, over the ops it
dispatches (the port's counterpart of `repro.core.hlo`; the name is kept so
a reader finds it).

The reference walks compiled HLO text: each collective op's kind, output
shape and replica groups give the bytes it puts on the wire, the numbers
the roofline's collective term is built from. PyTorch compiles nothing
ahead, so the port reads the ops the program dispatches instead: the
`OpRecord`s of `analysis.trace.record_ops` (or of `core.profiler`'s
trace). DTensor's redistributions and the `torch.distributed` functional
collectives dispatch `_c10d_functional` ops (`all_reduce`,
`all_gather_into_tensor`, `reduce_scatter_tensor`, `all_to_all_single`,
and DTensor's own `shard_dim_alltoall` for a shard-to-shard move) that name
their process group; a permute is a `send`/`recv` pair of which
the send carries the bytes. The group's ranks give its size, and whether it
stays within one pod of `pod_size` ranks ("pod") or spans pods
("cross_pod"). A collective whose group cannot be resolved raises: read the
records while their process group exists.

The ring formulas are the reference's, exactly (`wire_bytes`). The census
counts products (`mm`, `bmm`, `addmm`, `baddbmm`, `linear`, `einsum`,
convolutions) as "dot", every `repro_torch` hand-kernel op as "fusion",
and the ops that move data only to change its layout (a copying `permute`,
`transpose`, `view` or `reshape`, which dispatch as `clone`, and `clone`
and `contiguous` themselves) as "layout_change", beside each collective
kind. XLA fuses elementwise chains into one op and eager PyTorch
dispatches each, so the port's counts are not comparable to the
reference's one to one.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

_COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# dispatched op name -> the reference's collective kind
_COLLECTIVE_OPS = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::_allgather_base_": "all-gather",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
}
# ops of a collective that carry no bytes of their own (the wait, and the
# receiving half of a permute, whose bytes the send counts)
_COLLECTIVE_QUIET = ("_c10d_functional::wait_tensor", "c10d::recv_")

_DOT_OPS = frozenset(
    f"aten::{n}" for n in ("mm", "bmm", "addmm", "baddbmm", "linear",
                           "einsum", "matmul", "convolution", "_convolution",
                           "conv1d", "conv2d", "conv3d",
                           "convolution_backward"))
_LAYOUT_OPS = frozenset(
    f"aten::{n}" for n in ("clone", "contiguous", "_reshape_copy",
                           "permute_copy", "transpose_copy", "view_copy"))


@dataclass
class CollectiveOp:
    name: str
    kind: str
    out_bytes: int          # output bytes (per participant)
    group_size: int         # participants per group
    group_span: str         # "pod" | "cross_pod"
    wire_bytes: float = 0.0  # est. bytes crossing each card's links (ring)


def wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Bytes one participant puts on the wire for a collective of `n`
    participants and `out_bytes` output bytes, by the reference's ring
    accounting:

      all-reduce      2 * (n-1)/n * bytes
      all-gather      (n-1)/n * bytes_out
      reduce-scatter  (n-1)/n * bytes_in  (~= (n-1) * bytes_out)
      all-to-all      (n-1)/n * bytes
      collective-permute  bytes
    """
    n = max(n, 1)
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * out_bytes
    if kind == "all-gather":
        return (n - 1) / n * out_bytes
    if kind == "reduce-scatter":
        return (n - 1) * out_bytes  # in_bytes ~= n * out_bytes
    if kind == "all-to-all":
        return (n - 1) / n * out_bytes
    return float(out_bytes)  # collective-permute


def _group_ranks(record) -> Tuple[int, ...]:
    """The global ranks of the process group a collective record names: a
    group name (the functional collectives) or a `ProcessGroup` script
    object (the `c10d::` ops). Raises where there is none or it cannot be
    resolved, since the op's wire bytes depend on it."""
    import torch.distributed as dist
    group = next((value for key, value in record.args
                  if key in ("group_name", "process_group", "group")), None)
    if group is None:
        raise ValueError(f"collective {record.name} names no process group")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"collective {record.name} names group {group!r}, "
                           "but no process group is initialized to "
                           "resolve it: read the records inside the group")
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        pg = _resolve_process_group(group)
    else:
        from torch.distributed import ProcessGroup
        pg = (group if isinstance(group, ProcessGroup)
              else ProcessGroup.unbox(group))
    return tuple(dist.get_process_group_ranks(pg))


def _span(ranks: Sequence[int], pod_size: int) -> str:
    if pod_size and max(ranks) // pod_size != min(ranks) // pod_size:
        return "cross_pod"
    return "pod"


def _out_bytes(record, kind: str) -> int:
    if kind == "collective-permute":
        return sum(m.nbytes for _, m in record.operands())
    if record.results:
        return sum(m.nbytes for m in record.results)
    # an in-place collective (c10d::allreduce_) returns its written operands
    return sum(m.nbytes for k, m in record.operands() if k in record.mutated)


def parse_collectives(records, *, pod_size: int = 0) -> List[CollectiveOp]:
    """Inventory of the collective ops among `records` (`OpRecord`s), with
    per-card wire-byte estimates (`wire_bytes`). `pod_size` is the ranks of
    one pod; 0 puts every group within one pod."""
    ops: List[CollectiveOp] = []
    for i, r in enumerate(records):
        kind = _COLLECTIVE_OPS.get(r.name)
        if kind is None:
            continue
        ranks = _group_ranks(r)
        n = len(ranks)
        out_b = _out_bytes(r, kind)
        ops.append(CollectiveOp(f"{r.name}.{i}", kind, out_b, n,
                                _span(ranks, pod_size),
                                wire_bytes(kind, out_b, n)))
    return ops


def collective_summary(ops: List[CollectiveOp]) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "wire_bytes": 0.0})
    for op in ops:
        key = f"{op.kind}/{op.group_span}"
        out[key]["count"] += 1
        out[key]["wire_bytes"] += op.wire_bytes
    return dict(out)


def total_wire_bytes(ops: List[CollectiveOp],
                     span: Optional[str] = None) -> float:
    return sum(o.wire_bytes for o in ops
               if span is None or o.group_span == span)


def op_census(records) -> Dict[str, int]:
    """How many dots, hand-kernel ops ("fusion"), layout changes and
    collectives of each kind the dispatched program has (the module's
    docstring says what each counts)."""
    census: Dict[str, int] = defaultdict(int)
    for r in records:
        if r.name in _DOT_OPS:
            census["dot"] += 1
        elif r.op is not None or r.name.startswith("repro_torch::"):
            census["fusion"] += 1
        elif r.name in _LAYOUT_OPS:
            census["layout_change"] += 1
        kind = _COLLECTIVE_OPS.get(r.name)
        if kind is not None:
            census[kind] += 1
    return dict(census)


def is_collective(record) -> bool:
    """Whether a record is part of a collective (its bytes on the wire,
    not in device memory)."""
    return record.name in _COLLECTIVE_OPS or record.name in _COLLECTIVE_QUIET
