"""Phase-attributing profiler over dispatched programs (the port of
`repro.core.profiler`).

"If you can't measure it you can't improve it" (§III-A). Vivado HLS gave
the authors no on-device profiling, so they attached a counter block that
attributed cycles to code blocks. The reference reads XLA's program totals
(`cost_analysis`) and recovers the phases by instrumenting variants; the
port does the same over the ops a program dispatches:

  * `profile(fn, *args)`      totals: FLOPs, bytes, wire bytes, census,
                              from one run on fake tensors (no kernel runs)
  * `attribute(full, without)` skip-block differentials: cost(full) minus
                              cost(without block) = the block's share
  * `wallclock(fn, *args)`    median seconds of real calls: CUDA events
                              on the card, `perf_counter` on the CPU

`trace_cost` is the trace both `profile` and the dry run use. It runs the
program once under `FakeTensorMode` and records every op at the level that
runs on a rank: where the program holds DTensors, their sharding
propagation runs and the recorder sees each rank's local ops and the
collectives the redistributions dispatch (a mode that returns
`NotImplemented` for DTensor lets DTensor unwrap first), so every count is
per device, as XLA's `cost_analysis` is on an SPMD program.

  * FLOPs are counted by `torch.utils.flop_counter`'s formulas (those of
    `FlopCounterMode`), op by op on the local ops. They count products,
    convolutions and attention only; XLA's `flops` also counts elementwise
    work, so the port's totals are lower by that.
  * `bytes` is the sum of every dispatched op's operand and result bytes,
    the counterpart of XLA's "bytes accessed", which also charges each
    op's operands. Views, which move nothing, and the collectives, whose
    bytes are on the wire, are left out.
  * The live bytes are the fake storages alive at each op: the tracked
    arguments' and every op result's storage, freed when the last tensor
    on it dies. `peak_bytes` is their most.
"""
from __future__ import annotations

import contextlib
import statistics
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.analysis import trace as TR
from repro_torch.core import hlo as H


@dataclass
class PhaseCost:
    flops: float = 0.0
    bytes: float = 0.0
    pod_bytes: float = 0.0
    cross_pod_bytes: float = 0.0
    census: Dict[str, int] = field(default_factory=dict)

    def minus(self, other: "PhaseCost") -> "PhaseCost":
        return PhaseCost(
            max(self.flops - other.flops, 0.0),
            max(self.bytes - other.bytes, 0.0),
            max(self.pod_bytes - other.pod_bytes, 0.0),
            max(self.cross_pod_bytes - other.cross_pod_bytes, 0.0),
        )


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


_VIEW_CACHE: Dict[Any, bool] = {}


def _is_view(func) -> bool:
    """Whether an op only makes views: it writes nothing and every result
    aliases an input."""
    hit = _VIEW_CACHE.get(func)
    if hit is None:
        schema = func._schema
        writes = any(a.alias_info is not None and a.alias_info.is_write
                     for a in schema.arguments)
        rets = schema.returns
        hit = bool(rets) and not writes and all(
            r.alias_info is not None for r in rets)
        _VIEW_CACHE[func] = hit
    return hit


def _tensors(value) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _tensors(v)]
    return []


def local_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists and tuples, each DTensor as
    its rank's local tensor."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


class _CostRecorder(TR._Recorder):
    """`analysis.trace`'s recorder at the rank's level (DTensor unwraps
    first), counting FLOPs, bytes and live storages as it goes. During
    DTensor's planning calls (`analysis.trace.dtensor_planning`: its
    sharding propagation runs each op once on fake tensors of the global
    shapes to learn its output's metadata) it passes ops through
    unrecorded."""

    def __init__(self, track=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        for t in track:
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if TR.dtensor_planning():
            return func(*args, **kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        rec = self.records[-1]
        formula = self._flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not _is_view(func) and not H.is_collective(rec):
            self.bytes += sum(m.nbytes for _, m in rec.operands())
            if not rec.mutated:
                self.bytes += sum(m.nbytes for m in rec.results)
        if not _is_view(func):
            for t in _tensors(out):
                self._hold(t)
        return out


@dataclass
class Trace:
    """What `trace_cost` returns: the records, the FLOPs, the bytes, the
    tracked arguments' bytes and the peak of the live bytes."""
    records: List[Any]
    flops: float
    bytes: float
    args_bytes: int
    peak_bytes: int
    output: Any = None


def trace_cost(fn: Callable, *args, track=None, **kwargs) -> Trace:
    """Run `fn(*args, **kwargs)` once under `FakeTensorMode` (the active
    `analysis.trace.fake_mode`, or a new one whose tensor arguments are
    converted first) and return its `Trace`. `track` (default: `args`)
    is the tree whose storages count as live from the start: the
    arguments' bytes."""
    ctx = (contextlib.nullcontext(TR._ACTIVE[-1]) if TR._ACTIVE
           else TR.fake_mode())
    with ctx as mode:
        args = TR._to_fake(mode, args)
        kwargs = TR._to_fake(mode, kwargs)
        held = local_tensors(args if track is None else track)
        seen, args_bytes = set(), 0
        for t in held:
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                args_bytes += st.nbytes()
        rec = _CostRecorder(held)
        with TR.dtensor_internals(), rec:
            out = fn(*args, **kwargs)
    return Trace(rec.records, float(rec.flops), float(rec.bytes),
                 args_bytes, rec.peak_bytes, out)


# ---------------------------------------------------------------------------
# the reference's API
# ---------------------------------------------------------------------------


def profile(fn: Callable, *args, pod_size: int = 0) -> PhaseCost:
    """Trace `fn` on fake tensors (`trace_cost`; no kernel runs) and return
    its cost totals."""
    tr = trace_cost(fn, *args)
    ops = H.parse_collectives(tr.records, pod_size=pod_size)
    return PhaseCost(
        flops=tr.flops,
        bytes=tr.bytes,
        pod_bytes=H.total_wire_bytes(ops, "pod"),
        cross_pod_bytes=H.total_wire_bytes(ops, "cross_pod"),
        census=H.op_census(tr.records),
    )


def attribute(full: PhaseCost, without: Dict[str, PhaseCost]) -> Dict[str, PhaseCost]:
    """Differential phase attribution: share of each skipped block."""
    out = {"total": full}
    for name, w in without.items():
        out[name] = full.minus(w)
    rest = full
    for name, w in without.items():
        rest = rest.minus(out[name])
    out["rest"] = rest
    return out


def _on_cuda(args) -> Optional[torch.device]:
    for t in local_tensors(args):
        if t.device.type == "cuda":
            return t.device
    return None


def wallclock(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median seconds of `fn(*args)` on real inputs. Where an argument lies
    on the card, each call is timed by CUDA events recorded around it on
    the current stream, after `warmup` calls; else by `perf_counter`."""
    dev = _on_cuda(args)
    for _ in range(warmup):
        fn(*args)
    if dev is not None:
        torch.cuda.synchronize(dev)
    ts = []
    for _ in range(iters):
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args)
            end.record(stream)
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)
