"""Retrace detector: flag config knobs that leak static Python values into
a driver's op stream, and launch caches that grow with every block.
Counterpart of `repro.analysis.retrace`.

The reference's bug class: `make_distributed_run`'s recv-slot parity was
once selected with static Python `block_index % 2`, so every block baked a
different trace, a silent recompile per block. PyTorch runs eagerly and
compiles nothing, so the port's counterpart is host work redone per block:
a driver whose op stream changes with a knob that should not change it, or
that rebuilds what it launches from (K7's `BandTable`s,
`_LocalBlock._shard_masks`, the planners' `lru_cache`s) at every block.

Mechanism: record one block's op stream (`analysis.trace`; the last block
scope of the program, or all of it where it has none) under each value of
a knob and compare `structural_fingerprint`s, Python scalars abstracted
but for the kernels' launch configuration. Each perturbation declares
what it expects:

  expect="shared"    the knob must NOT change the stream (block parity,
                     n_blocks): divergence is a leak, reported with the
                     first differing op — kind "leak". With `caches` (a
                     callable giving each launch cache's size), a cache
                     that grew while each of the last two values ran is a
                     leak too: it is rebuilt per block, not per layout.
  expect="distinct"  the knob MUST change the stream (y_tile changes K1's
                     launch): identical fingerprints mean the knob is
                     silently ignored — kind "inert".

Both verdicts are bugs; `RetraceReport.ok` is the gate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.trace import (fingerprint_parts, record_ops,
                                        structural_fingerprint)

__all__ = [
    "Perturbation", "RetraceFinding", "RetraceReport", "detect_retrace",
    "driver_fingerprint", "block_stream", "launch_cache_sizes",
    "make_static_parity_driver", "make_traced_parity_driver",
]


@dataclass(frozen=True)
class Perturbation:
    """Sweep `knob` over `values`; `expect` declares whether the streams
    must be shared (retrace-free) or distinct (the knob must matter)."""
    knob: str
    values: Tuple
    expect: str = "shared"

    def __post_init__(self):
        if self.expect not in ("shared", "distinct"):
            raise ValueError(f"expect must be 'shared' or 'distinct', "
                             f"got {self.expect!r}")
        if len(self.values) < 2:
            raise ValueError(f"perturbation {self.knob!r} needs >= 2 "
                             f"values to compare")


@dataclass(frozen=True)
class RetraceFinding:
    knob: str
    kind: str          # "leak" | "inert"
    values: Tuple
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] knob {self.knob!r} over {self.values}: " \
               f"{self.detail}"


@dataclass
class RetraceReport:
    ok: bool
    findings: Tuple[RetraceFinding, ...]
    fingerprints: Dict[Tuple[str, object], str] = field(default_factory=dict)

    def raise_if_failed(self) -> None:
        if not self.ok:
            lines = "\n  ".join(str(f) for f in self.findings)
            raise AssertionError(
                f"retrace detector failed ({len(self.findings)} "
                f"finding(s)):\n  {lines}")


def block_stream(records) -> list:
    """The records of the last substep-block a program ran (its block
    scope, `kernels.library.scope`), or all of them where it ran none."""
    blocks = [r.block for r in records if r.block is not None]
    if not blocks:
        return list(records)
    last = max(blocks)
    return [r for r in records if r.block == last]


def driver_fingerprint(fn, *args, execute: bool = False) -> str:
    """Structural fingerprint of one block of `fn(*args)` (traced on fake
    tensors, or run with ``execute=True``)."""
    return structural_fingerprint(
        block_stream(record_ops(fn, *args, execute=execute)))


def _first_divergence(parts_a: Sequence[str], parts_b: Sequence[str]) -> str:
    for i, (a, b) in enumerate(zip(parts_a, parts_b)):
        if a != b:
            return (f"first divergence at op #{i}: "
                    f"{a.strip()!r} vs {b.strip()!r}")
    return (f"streams differ in length: {len(parts_a)} vs {len(parts_b)} "
            f"ops")


def detect_retrace(factory: Callable,
                   perturbations: Sequence[Perturbation], *,
                   caches: Optional[Callable[[], Dict[str, int]]] = None,
                   execute: bool = False) -> RetraceReport:
    """`factory(**{knob: value}) -> (fn, args)` builds the driver under one
    config override; each perturbation's values are recorded in order (on
    fake tensors, or run with ``execute=True``) and one block's
    fingerprints compared against its expectation. `caches()`, where
    given, sizes the launch caches around each call."""
    findings = []
    fingerprints: Dict[Tuple[str, object], str] = {}
    for pert in perturbations:
        traces, grew = [], []
        for value in pert.values:
            fn, args = factory(**{pert.knob: value})
            before = caches() if caches is not None else {}
            stream = block_stream(record_ops(fn, *args, execute=execute))
            after = caches() if caches is not None else {}
            grew.append({k: (before.get(k, 0), n) for k, n in after.items()
                         if n > before.get(k, 0)})
            parts = fingerprint_parts(stream)
            fp = structural_fingerprint(stream)
            fingerprints[(pert.knob, value)] = fp
            traces.append((value, fp, parts))
        base_value, base_fp, base_parts = traces[0]
        for value, fp, parts in traces[1:]:
            if pert.expect == "shared" and fp != base_fp:
                findings.append(RetraceFinding(
                    pert.knob, "leak", (base_value, value),
                    "a static Python value leaked into the op stream — "
                    "the driver does other work per config; "
                    + _first_divergence(base_parts, parts)))
            elif pert.expect == "distinct" and fp == base_fp:
                findings.append(RetraceFinding(
                    pert.knob, "inert", (base_value, value),
                    "expected the knob to change the dispatched ops but "
                    "the fingerprints are identical — the config is "
                    "silently ignored"))
        if pert.expect == "shared" and len(grew) >= 2:
            for name in sorted(set(grew[-1]) & set(grew[-2])):
                findings.append(RetraceFinding(
                    pert.knob, "leak", tuple(pert.values[-2:]),
                    f"launch cache {name!r} grew at each of the last two "
                    f"values ({grew[-2][name]} and {grew[-1][name]}, before "
                    f"and after): it is rebuilt per block, keyed by a value "
                    f"that should not key it"))
    return RetraceReport(ok=not findings, findings=tuple(findings),
                         fingerprints=fingerprints)


def launch_cache_sizes(*blocks) -> Dict[str, int]:
    """Sizes of the caches a launch is planned from: the planners'
    `lru_cache`s, the K7 tables built so far and the specs K6 has taken,
    and for each `stencil.distributed._LocalBlock` given its K7 tables and
    shard masks."""
    from repro_torch.kernels.advection import advection as K
    from repro_torch.kernels.ssm import ssm as SS
    sizes = {}
    for name, fn in (("fused_block", K._fused_block),
                     ("ring_launch_plan", K._ring_launch_plan),
                     ("rung_block", K._rung_block),
                     ("rung_launch_plan", K.rung_launch_plan),
                     ("fused_attrs", K._fused_attrs_cached),
                     ("rung_attrs", K._rung_attrs_cached),
                     ("spec_attrs", K._spec_attrs_cached),
                     ("band_attrs", K._band_attrs_cached),
                     ("scan_attrs", SS._scan_attrs_cached),
                     ("scan_device_plan", SS._device_plan_cached)):
        sizes[name] = fn.cache_info().currsize
    sizes["band_tables_built"] = K.BAND_TABLES_BUILT
    sizes["spec_handles"] = len(K._SPECS)
    for i, block in enumerate(blocks):
        sizes[f"block{i}.band_tables"] = sum(
            len(s._tables) for s in block.slabs.values())
        sizes[f"block{i}.shard_masks"] = len(block._masks)
    return sizes


# ---- fixtures ----------------------------------------------------------

def _slot_table(Y: int, slot: int, device) -> torch.Tensor:
    """The rows a slot reads: the identity, or rolled by one (slot 1)."""
    return torch.arange(Y, device=device).roll(slot)


def make_static_parity_driver(block_index: int = 0,
                              shape: Tuple[int, int, int] = (4, 6, 8),
                              tables: Optional[dict] = None,
                              device: str = "cpu"):
    """Deliberately BROKEN fixture of the bug class: the driver rebuilds
    the table of its recv slot from the Python parity of every block,
    keyed by the block (`tables[block_index]`), so each block rebuilds
    what the previous one built and the cache grows by one a block. The
    detector must flag it — the red half of its gate. Returns `(fn,
    args)` for `detect_retrace`'s factory protocol; `tables` is the
    driver's state, kept across its blocks by the caller."""
    tables = {} if tables is None else tables
    slot = int(block_index) % 2   # the bug: parity resolved in Python

    def step(u):
        if block_index not in tables:
            tables[block_index] = _slot_table(shape[1], slot, u.device)
        return u.index_select(1, tables[block_index]) * 0.5

    return step, (torch.zeros(shape, dtype=torch.float32, device=device),)


def make_traced_parity_driver(block_index: int = 0,
                              shape: Tuple[int, int, int] = (4, 6, 8),
                              tables: Optional[dict] = None,
                              device: str = "cpu"):
    """The FIXED counterpart: both slots' tables are built once, when the
    driver is made, and each block selects its slot's by index, so every
    block dispatches the same ops and no cache grows. The detector must
    report it retrace-free — the green half of the fixture pair."""
    tables = {} if tables is None else tables
    if "slots" not in tables:
        tables["slots"] = torch.stack([_slot_table(shape[1], s, device)
                                       for s in (0, 1)])

    def step(u, k):
        return u.index_select(1, tables["slots"][k % 2]) * 0.5

    return step, (torch.zeros(shape, dtype=torch.float32, device=device),
                  int(block_index))
