"""Tiling-contract linter: check every kernel op of a recorded program
against what the card's kernels assume of their operands and plans —
statically, from the op records. Counterpart of
`repro.analysis.tiling`, whose checks were the TPU's (8, 128) tile,
`pl.Unblocked` windows and `input_output_aliases`; the card's are these.

Errors:

  align16        an operand base that is not 16-byte aligned where the
                 kernel moves 16 bytes at a time: K2 `wide` (16-byte loads
                 and stores of 4 f32 or 8 bf16 cells: a row of 2-byte cells
                 is whole vectors at Z % 8 == 0, on a 16-byte base), K7 (its 16-byte path), K8's tensor-core
                 kernel (TMA) and K9 (`cp.async`). A base is its byte
                 offset into its allocation, whose blocks the caching
                 allocator starts 512-byte aligned.
  tma-stride     a bf16 K8 operand whose (b, h, s) strides are not
                 multiples of 16 bytes, or whose head dim is not unit
                 stride: a layout TMA cannot take.
  contiguous     a non-contiguous operand of a kernel that reads it as one
                 dense block (K1-K7; K7's fields may be its slabs'
                 interior views, the in-place exchange).
  tile-oob       a planned tile whose slab window reaches outside its
                 operand: the kernel's own plan (`fused_launch_plan` /
                 `spec_launch_plan` / `rung_launch_plan` at the op's
                 arguments and the card's `n_sm`) evaluated over
                 the launch grid, every point up to `max_grid_points`,
                 then the corners — the counterpart of `unblocked-oob`.
  alias-shape    a written operand whose extent differs from what it
  alias-window   aliases (K8's `out` and q; K7's slabs and the extended
                 shape its table lands), or whose window reaches past its
                 allocation — the counterparts of the reference's aliasing
                 checks.

Warnings:

  line           a rank >= 3 operand whose z extent is not a whole number
                 of 128-byte lines: every row's last line is partly read,
                 the counterpart of the lane tile (the card's models
                 charge rows by 16-byte vectors, `hbm_bytes_model`).

`lint_tiling(fn, *args)` records the program (a fake trace by default)
and returns a `TilingReport`; `lint_records` lints records already made.
`scripts/torch_lint_movement.py` gates errors == 0 over the shipped
programs.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.analysis.trace import TensorMeta, record_ops
from repro_torch.kernels import library as L

__all__ = ["TilingIssue", "TilingReport", "lint_tiling", "lint_records",
           "LINE", "VECTOR"]

LINE, VECTOR = 128, 16      # bytes: a cache line, a 16-byte vector access
# kernel op -> the operands it moves 16 bytes at a time
_VECTOR_OPERANDS = {"band_exchange": ("fields", "regions"),
                    "selective_scan": ("xc", "dt", "Bmat", "Cmat", "A",
                                       "h0")}
# kernel ops that read every rank >= 3 operand as one dense block
_DENSE = ("advect_fused", "advect_blocked", "advect_dataflow",
          "finite_guard", "stencil_fused", "band_exchange")


@dataclass(frozen=True)
class TilingIssue:
    severity: str      # "error" | "warn"
    kind: str
    kernel: str
    operand: str
    detail: str

    def __str__(self) -> str:
        return (f"{self.severity.upper()} [{self.kind}] {self.kernel}"
                f" / {self.operand}: {self.detail}")


@dataclass
class TilingReport:
    issues: Tuple[TilingIssue, ...]
    kernels: int

    @property
    def errors(self) -> Tuple[TilingIssue, ...]:
        return tuple(i for i in self.issues if i.severity == "error")

    @property
    def warnings(self) -> Tuple[TilingIssue, ...]:
        return tuple(i for i in self.issues if i.severity == "warn")

    def raise_if_errors(self) -> None:
        if self.errors:
            lines = "\n  ".join(str(i) for i in self.errors)
            raise AssertionError(
                f"tiling contract violated ({len(self.errors)} "
                f"error(s)):\n  {lines}")


def _grid_points(sizes, max_grid_points):
    """Every launch-grid point when the grid is small, corners beyond —
    the tile geometry is monotone in each grid index, so corners bound its
    extrema."""
    sizes = [max(int(s), 1) for s in sizes]
    total = 1
    for s in sizes:
        total *= s
    if total <= max_grid_points:
        return list(itertools.product(*(range(s) for s in sizes)))
    return list(itertools.product(*(sorted({0, s - 1}) for s in sizes)))


def _window_end(m: TensorMeta) -> int:
    """One past the last element (in storage elements) `m` addresses."""
    return m.offset + 1 + sum((s - 1) * st for s, st in zip(m.shape, m.stride)
                              if s > 0)


def _ring_plan(r, n_sm, blocks_per_sm):
    """(plan, levels, shape) of a K1 or K6 record: the plan the wrapper's
    launch takes at the record's arguments on a card of `n_sm` SMs."""
    from repro_torch.kernels.advection import advection as K
    first = r.tensors("fields")[0] if r.op == "stencil_fused" \
        else r.arg("u")
    B, X, Y, Z = first.shape
    T, y_tile = r.arg("T"), r.arg("y_tile") or None
    if r.op == "stencil_fused":
        spec = K.spec_of(r.arg("spec"))
        if not K.spec_on_card(spec):
            return None, None, first.shape
        levels = spec.stages * T
        plan = K.spec_launch_plan(X, Y, Z, spec, T, B, n_sm, blocks_per_sm,
                                  y_tile=y_tile)
    else:
        levels = T
        plan = K.fused_launch_plan(X, Y, Z, T, B, n_sm, blocks_per_sm,
                                   y_tile=y_tile)
    return plan, levels, first.shape


def _check_ring(r, issues, n_sm, blocks_per_sm, max_grid_points):
    from repro_torch.kernels.advection import advection as K
    plan, levels, shape = _ring_plan(r, n_sm, blocks_per_sm)
    if plan is None:
        return
    _, X, Y, Z = shape
    for t, cz, cx in _grid_points((plan.n_ty, plan.n_cz, plan.n_cx),
                                  max_grid_points):
        slab_lo, own, zlo, cells, walk, owned = K._fused_block_geometry(
            plan, X, Y, Z, levels, t, cz, cx)
        bad = []
        if slab_lo < 0 or slab_lo + plan.S > Y:
            bad.append(f"slab rows [{slab_lo}, {slab_lo + plan.S}) of "
                       f"Y={Y}")
        if zlo < 0 or zlo + plan.W > Z:
            bad.append(f"z window [{zlo}, {zlo + plan.W}) of Z={Z}")
        if owned[0] >= X or own[0] >= Y or cells[0] >= Z:
            bad.append(f"a block owning slices [{owned[0]}, {owned[1]}), "
                       f"rows [{own[0]}, {own[1]}), cells [{cells[0]}, "
                       f"{cells[1]}) of {(X, Y, Z)}")
        if bad:
            issues.append(TilingIssue(
                "error", "tile-oob", r.op, "fields",
                f"grid point (t={t}, cz={cz}, cx={cx}) of plan TY={plan.TY} "
                f"S={plan.S} CZ={plan.CZ} W={plan.W} CX={plan.CX}: "
                + "; ".join(bad) + " — reaches outside the operand"))
            return   # one witness per op is enough


def _check_rung(r, issues, n_sm, max_grid_points):
    from repro_torch.kernels.advection import advection as K
    name = ("advect_blocked" if r.op == "advect_blocked"
            else "advect_wide" if r.arg("wide") else "advect_dataflow")
    u = r.arg("u")
    X, Y, Z = u.shape
    plan = K.rung_launch_plan(name, X, Y, Z, n_sm,
                              K._RUNG_KNOBS[name].blocks_per_sm,
                              y_tile=r.arg("y_tile") or None,
                              itemsize=u.itemsize)
    for t, cx in _grid_points((plan.n_ty, plan.n_cx), max_grid_points):
        slab_lo, own, owned = K._rung_block_geometry(plan, X, Y, t, cx)
        if slab_lo < 0 or slab_lo + plan.S > Y or owned[0] >= X:
            issues.append(TilingIssue(
                "error", "tile-oob", r.op, "u, v, w",
                f"grid point (t={t}, cx={cx}): slab rows [{slab_lo}, "
                f"{slab_lo + plan.S}) and slices [{owned[0]}, {owned[1]}) "
                f"of {(X, Y, Z)} — reaches outside the operand"))
            return


def _check_alias(r, issues):
    if r.op == "flash_attention":
        q, out = r.arg("q"), r.arg("out")
        if out.shape != q.shape:
            issues.append(TilingIssue(
                "error", "alias-shape", r.op, "out<->q",
                f"written output {out.shape} is not q's extent {q.shape} — "
                f"the kernel writes rows of q's shape"))
    elif r.op == "band_exchange" and r.extra is not None:
        want = tuple(r.extra["extended"])
        for i, m in enumerate(r.tensors("regions")):
            if m.shape != want:
                issues.append(TilingIssue(
                    "error", "alias-shape", r.op, f"regions[{i}]",
                    f"written slab {m.shape} is not the extended shape "
                    f"{want} the table lands — the bands land outside the "
                    f"slab they were planned for"))
                break
    for name in r.mutated:
        for i, m in enumerate(r.tensors(name)):
            if m.storage_nbytes >= 0 and \
                    _window_end(m) * m.itemsize > m.storage_nbytes:
                issues.append(TilingIssue(
                    "error", "alias-window", r.op, f"{name}[{i}]",
                    f"written window ends at element {_window_end(m)} of an "
                    f"allocation of {m.storage_nbytes // m.itemsize} — the "
                    f"in-place write lands past the buffer it aliases"))
                return


def _lint_record(r, issues, *, n_sm, blocks_per_sm, max_grid_points):
    op = r.op
    vector = dict(_VECTOR_OPERANDS)
    if op == "advect_dataflow" and r.arg("wide"):
        vector[op] = ("u", "v", "w")
    bf16_attention = (op == "flash_attention"
                      and r.arg("q").dtype == "bfloat16")
    if bf16_attention:
        vector[op] = ("q", "k", "v", "out")
    for name, m in r.operands():
        if name in vector.get(op, ()) and m.byte_offset % VECTOR:
            issues.append(TilingIssue(
                "error", "align16", op, name,
                f"base at byte {m.byte_offset} of its allocation is not "
                f"16-byte aligned; {op} moves it 16 bytes at a time"))
        if bf16_attention and name in vector[op]:
            strides = m.stride[:3]
            if m.stride[3] != 1 or any((st * m.itemsize) % VECTOR
                                       for s, st in zip(m.shape, strides)
                                       if s > 1):
                issues.append(TilingIssue(
                    "error", "tma-stride", op, name,
                    f"strides {m.stride} of {m.shape}: TMA takes a unit "
                    f"head-dim stride and 16-byte (b, h, s) strides"))
        if op in _DENSE and m.ndim >= 3 and not m.contiguous and not (
                op == "band_exchange" and r.extra is not None
                and (name == "regions" or r.extra["in_place"])):
            issues.append(TilingIssue(
                "error", "contiguous", op, name,
                f"strides {m.stride} of {m.shape} are not dense; the "
                f"kernel reads the operand as one block"))
        if m.ndim >= 3 and L.OPS[op].kind != "send" and \
                (m.shape[-1] * m.itemsize) % LINE:
            issues.append(TilingIssue(
                "warn", "line", op, name,
                f"z extent {m.shape[-1]} x {m.itemsize} B = "
                f"{m.shape[-1] * m.itemsize} B is not a whole number of "
                f"{LINE}-byte lines: each row's last line is partly read"))
    if op in ("advect_fused", "stencil_fused"):
        _check_ring(r, issues, n_sm, blocks_per_sm, max_grid_points)
    elif op in ("advect_blocked", "advect_dataflow"):
        _check_rung(r, issues, n_sm, max_grid_points)
    _check_alias(r, issues)


def lint_records(records, *, n_sm: int = 132, blocks_per_sm: int = 1,
                 max_grid_points: int = 4096) -> TilingReport:
    """Lint every kernel op among `records` (`analysis.trace` records);
    `n_sm` and `blocks_per_sm` are the card's, for the plans the kernels
    make themselves (132 SMs: an H100)."""
    issues: List[TilingIssue] = []
    kernels = 0
    for r in records:
        if r.op is None or L.OPS[r.op].kind == "send":
            continue
        kernels += 1
        _lint_record(r, issues, n_sm=n_sm, blocks_per_sm=blocks_per_sm,
                     max_grid_points=max_grid_points)
    return TilingReport(issues=tuple(issues), kernels=kernels)


def lint_tiling(fn, *args, execute: bool = False, n_sm: int = 132,
                blocks_per_sm: int = 1,
                max_grid_points: int = 4096) -> TilingReport:
    """Record `fn(*args)` (a fake trace, never running a kernel, unless
    ``execute=True``) and lint every kernel op in it. Returns a
    `TilingReport`; `raise_if_errors()` is the gate."""
    return lint_records(record_ops(fn, *args, execute=execute), n_sm=n_sm,
                        blocks_per_sm=blocks_per_sm,
                        max_grid_points=max_grid_points)
