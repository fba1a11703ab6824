"""MovementLedger: every byte a program's ops move, attributed to a
category. Counterpart of `repro.analysis.ledger`, with its categories,
names and order, so that one dict of claims serves both packages.

The reference walks a jaxpr; the port walks the op records of
`analysis.trace` (a fake trace, `MovementLedger.of`, or a live run,
`MovementLedger.record`). The categories, as the port counts them:

  ppermute_wire      rank >= 3 operands of `band_send` (the collective
                     exchange's messages), and the band messages of K7's
                     table (`band_exchange`: its plain version's sends run
                     inside its op, unseen by a recording), priced by
                     `roofline.halo_wire_bytes_model`.
  integrity_words    rank < 3 operands of `band_send`: the checksum words
                     a verified exchange sends beside each band, and one
                     a K7 message when its call declares `checksums`
                     (`roofline.integrity_bytes_model`).
  pallas_hbm         rank >= 3 operands and results of the field-moving
                     kernel ops: K1 and K5 (`advect_fused`), K3
                     (`advect_blocked`), K2 (`advect_dataflow`), K6
                     (`stencil_fused`), K8 (`flash_attention`), K9
                     (`selective_scan`); and K7's slabs, each band and
                     each shard's own planes read once and landed once
                     (`kernels.advection.hbm_bytes_model`, and
                     `roofline.band_slab_bytes_model` for K7).
  guard_field_reads  rank >= 3 operands of K4 (`finite_guard`).
  guard_flag_words   rank < 3 operands and results of K4; with the field
                     reads, `roofline.guard_bytes_model_parts`.
  pallas_control     rank < 3 operands and results of the field-moving
                     ops: coefficient vectors, interior masks, K9's A. The
                     models never charge them; the coverage pass treats
                     them as unpriced by design.
  all_gather         operands of the c10d functional collectives, should
  psum               any appear. No model prices them, so a nonzero total
  all_to_all         fails the coverage pass.
  host_transfer      copies between the host and a card inside the
                     program.

The reference counts per shard by construction (shapes inside `shard_map`)
and per block by walking a `fori_loop` body once. The port's drivers run
every shard in one process and loop over blocks in Python, so its records
carry the shard and block their driver scoped them to
(`kernels.library.scope`), and `per_shard_block` divides the counts by
them, raising unless every shard and block moved the same bytes: a driver
that rebuilds or retraces per block shows up as unequal blocks, and is
refused, never averaged.

`check_model_coverage` is the reference's gate, with its logic and
messages: every counted byte is claimed exactly by a model term or
declared unpriced, and every claim matches its count.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.analysis.trace import OpRecord, record_ops
from repro_torch.kernels import library as L

__all__ = [
    "CATEGORIES", "MovementRecord", "MovementLedger", "audit_movement",
    "count_ppermute_bytes",
    "CoverageFailure", "CoverageReport", "check_model_coverage",
    "ModelCoverageError",
]

CATEGORIES = (
    "ppermute_wire", "integrity_words", "pallas_hbm",
    "guard_field_reads", "guard_flag_words", "pallas_control",
    "all_gather", "psum", "all_to_all", "host_transfer",
)

# c10d functional collectives, recorded under the reference's names
_COLLECTIVES = {"all_gather_into_tensor": "all_gather",
                "all_reduce": "psum", "all_to_all_single": "all_to_all"}
_COPIES = ("aten::_to_copy", "aten::copy_", "aten::_copy_from",
           "aten::_copy_from_and_resize")
INTEGRITY_WORD_BYTES = 4   # a checksum word K7's table rides per message


@dataclass(frozen=True)
class MovementRecord:
    """One attributed operand: `nbytes` of `category` traffic moved by op
    `primitive` (its kernel name when it is one), in `shard` and `block`
    where its driver scoped it."""
    category: str
    primitive: str
    nbytes: int
    shape: Tuple[int, ...]
    dtype: str
    kernel: str = ""
    shard: Optional[int] = None
    block: Optional[int] = None

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _records_of(r: OpRecord):
    """The `MovementRecord`s of one op record."""
    out = []

    def add(category, meta, shard=None, kernel=""):
        out.append(MovementRecord(
            category, r.name, meta.nbytes, meta.shape, meta.dtype, kernel,
            r.shard if shard is None else shard, r.block))

    info = L.OPS.get(r.op) if r.op is not None else None
    if info is not None:
        if info.kind == "send":
            band = r.arg("band")
            add("ppermute_wire" if band.ndim >= 3 else "integrity_words",
                band, shard=r.arg("sender"))
        elif info.kind == "band":
            for sender, nbytes in r.extra["messages"]:
                out.append(MovementRecord("ppermute_wire", r.name, nbytes,
                                          (), "float32", r.op, sender,
                                          r.block))
                # read once from the sender's field, landed once
                out.append(MovementRecord("pallas_hbm", r.name, 2 * nbytes,
                                          (), "float32", r.op, sender,
                                          r.block))
                if r.arg("checksums"):
                    out.append(MovementRecord(
                        "integrity_words", r.name, INTEGRITY_WORD_BYTES,
                        (1,), "uint32", r.op, sender, r.block))
            for shard, nbytes in r.extra["own"]:
                if nbytes:
                    out.append(MovementRecord("pallas_hbm", r.name,
                                              2 * nbytes, (), "float32",
                                              r.op, shard, r.block))
        else:
            guard = info.kind == "guard"
            metas = [m for _, m in r.operands()] + list(r.results)
            for m in metas:
                if guard:
                    cat = ("guard_field_reads" if m.ndim >= 3
                           else "guard_flag_words")
                else:
                    cat = "pallas_hbm" if m.ndim >= 3 else "pallas_control"
                add(cat, m, kernel=r.op)
        return out
    base = r.name.split(".")[0]
    namespace, _, op = base.partition("::")
    if namespace in ("_c10d_functional", "c10d_functional") \
            and op in _COLLECTIVES:
        for _, m in r.operands():
            add(_COLLECTIVES[op], m)
    elif base in _COPIES:
        metas = [m for _, m in r.operands()] + list(r.results)
        if {m.device_type for m in metas} >= {"cpu", "cuda"}:
            moved = r.results[0] if r.results else metas[-1]
            if base == "aten::copy_":
                moved = r.arg("src")
            add("host_transfer", moved)
    return out


class MovementLedger:
    """The attributed byte records of one recorded program, and the
    substep-blocks its driver scoped."""

    def __init__(self, records=(), blocks: Iterable[int] = ()):
        self.records: list = list(records)
        self.blocks: Tuple[int, ...] = tuple(sorted(set(blocks)))

    # ---- construction -------------------------------------------------
    @classmethod
    def from_ops(cls, ops) -> "MovementLedger":
        records = [m for r in ops for m in _records_of(r)]
        return cls(records, {r.block for r in ops if r.block is not None})

    @classmethod
    def of(cls, fn, *args, **kwargs) -> "MovementLedger":
        """Trace `fn(*args)` on fake tensors (never running a kernel) and
        attribute every byte its ops move."""
        return cls.from_ops(record_ops(fn, *args, **kwargs))

    @classmethod
    def record(cls, fn, *args, **kwargs) -> "MovementLedger":
        """Run `fn(*args)` and attribute every byte its ops moved."""
        return cls.from_ops(record_ops(fn, *args, execute=True, **kwargs))

    # ---- queries ------------------------------------------------------
    def _check(self, categories) -> None:
        for c in categories:
            if c not in CATEGORIES:
                raise KeyError(f"unknown movement category {c!r}; "
                               f"one of {CATEGORIES}")

    def total(self, *categories: str) -> int:
        self._check(categories)
        return sum(r.nbytes for r in self.records if r.category in categories)

    def totals(self) -> Dict[str, int]:
        """Per-category byte totals — every category, zeros included."""
        out = {c: 0 for c in CATEGORIES}
        for r in self.records:
            out[r.category] += r.nbytes
        return out

    def grand_total(self) -> int:
        return sum(r.nbytes for r in self.records)

    def per_shard_block(self, *categories: str, n_shards: int) -> int:
        """The bytes of `categories` each of `n_shards` shards moved in each
        substep-block; raises RuntimeError unless every shard and block
        moved the same, or where the program ran no scoped block or a
        counted op lies in a block outside any shard."""
        self._check(categories)
        if not self.blocks:
            raise RuntimeError("the program ran no substep-block scope; "
                               "per-block counts need a driver that scopes "
                               "its blocks")
        counts = {(s, b): 0 for s in range(n_shards) for b in self.blocks}
        for r in self.records:
            if r.category not in categories or r.block is None:
                continue
            if r.shard is None or not 0 <= r.shard < n_shards:
                raise RuntimeError(f"{r.primitive} moved {r.nbytes} "
                                   f"{r.category} bytes in block {r.block} "
                                   f"outside any of {n_shards} shards")
            counts[r.shard, r.block] += r.nbytes
        values = set(counts.values())
        if len(values) != 1:
            table = {s: [counts[s, b] for b in self.blocks]
                     for s in range(n_shards)}
            raise RuntimeError(f"shards and blocks moved different "
                               f"{'+'.join(categories)} bytes (per shard, "
                               f"per block): {table}")
        return values.pop()

    def per_shard_block_totals(self, n_shards: int) -> Dict[str, int]:
        """`per_shard_block` of every category: the per-shard, per-block
        ledger the reference's trace-once walk gives a distributed run."""
        return {c: self.per_shard_block(c, n_shards=n_shards)
                for c in CATEGORIES}

    def __len__(self) -> int:
        return len(self.records)

    def __repr__(self) -> str:
        nz = {c: b for c, b in self.totals().items() if b}
        return f"MovementLedger({len(self.records)} records, {nz})"


def audit_movement(fn, *args) -> MovementLedger:
    """Convenience alias: `MovementLedger.of(fn, *args)`."""
    return MovementLedger.of(fn, *args)


def count_ppermute_bytes(fn, args, keep) -> int:
    """Summed sizes of the messages selected by `keep(record)` (a
    `MovementRecord`, with `shape`, `ndim` and `dtype`) among those `fn`'s
    fake trace sends: `band_send` operands and K7's table messages (their
    integrity words rank 1)."""
    ledger = MovementLedger.of(fn, *args)
    return sum(r.nbytes for r in ledger.records
               if r.category in ("ppermute_wire", "integrity_words")
               and keep(r))


# ---- model-coverage pass ----------------------------------------------

class ModelCoverageError(AssertionError):
    """The traced program moves bytes the analytic models do not claim
    (or a model claims bytes the trace contradicts). Raised by
    `CoverageReport.raise_if_failed`."""


@dataclass(frozen=True)
class CoverageFailure:
    category: str
    counted: int
    claimed: Optional[int]
    reason: str

    def __str__(self) -> str:
        return (f"[{self.category}] counted={self.counted} "
                f"claimed={self.claimed}: {self.reason}")


@dataclass
class CoverageReport:
    ok: bool
    failures: Tuple[CoverageFailure, ...]
    counted: Dict[str, int] = field(default_factory=dict)
    claims: Dict[str, int] = field(default_factory=dict)
    unpriced: Tuple[str, ...] = ()

    def raise_if_failed(self) -> None:
        if not self.ok:
            lines = "\n  ".join(str(f) for f in self.failures)
            raise ModelCoverageError(
                f"model coverage failed ({len(self.failures)} "
                f"failure(s)):\n  {lines}")


def check_model_coverage(ledger, claims: Dict[str, int], *,
                         unpriced: Tuple[str, ...] = ("pallas_control",),
                         ) -> CoverageReport:
    """Every counted byte must be claimed EXACTLY by an analytic model
    term, or appear in `unpriced` (categories documented as
    deliberately unpriced — default: the scalar-pipeline `pallas_control`
    traffic `count_pallas_hbm_bytes` always excluded). Conversely every
    claim must match the count exactly — a model pricing movement the
    trace does not perform is as wrong as unpriced movement. `ledger` is a
    `MovementLedger` or a dict of per-category counts (a per-shard,
    per-block ledger's `per_shard_block_totals`)."""
    counted = dict(ledger) if isinstance(ledger, dict) else ledger.totals()
    counted = {c: int(counted.get(c, 0)) for c in CATEGORIES}
    failures = []
    for cat in CATEGORIES:
        if cat in unpriced:
            if cat in claims:
                failures.append(CoverageFailure(
                    cat, counted[cat], claims[cat],
                    "category is both claimed and declared unpriced — "
                    "pick one"))
            continue
        have = counted[cat]
        if cat in claims:
            want = int(claims[cat])
            if have != want:
                reason = ("model claims bytes the trace never moves"
                          if have == 0 else
                          "counted bytes contradict the model claim")
                failures.append(CoverageFailure(cat, have, want, reason))
        elif have:
            failures.append(CoverageFailure(
                cat, have, None,
                "unclaimed movement: no analytic model term prices these "
                "bytes (add a model claim or an explicit unpriced entry)"))
    unknown = sorted(set(claims) - set(CATEGORIES))
    for cat in unknown:
        failures.append(CoverageFailure(
            cat, 0, claims[cat],
            f"claim names no ledger category (one of {CATEGORIES})"))
    return CoverageReport(ok=not failures, failures=tuple(failures),
                          counted=counted, claims=dict(claims),
                          unpriced=tuple(unpriced))
