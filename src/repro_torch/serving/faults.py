"""Deterministic fault injection and the recovery discipline of the
serving stack (the port's copy of `repro.serving.faults`).

This module describes faults and orchestrates recovery; detection and
repair live in the layers that own the data:

  * detection   - the finite guard (K4, `kernels.advection.finite_guard`)
                  after every mega-launch of the stencil serving engine: one
                  f32 flag per (slot, x-slice), priced by
                  `roofline.guard_bytes_model`;
  * rollback    - `StencilServingEngine` snapshots its in-flight state (a
                  device clone, or through `training.checkpoint`'s atomic
                  on-disk format) and replays from the last snapshot;
  * isolation   - a slot whose guard trips twice at the same step is
                  quarantined with an error status;
  * degradation - `retry_with_backoff` retries a stalled exchange and a
                  `DegradationLadder` walks `remote_dma` -> `collective`
                  -> reshard-down, each transition recorded;
  * the distributed run - `resilient_distributed_run` drives
                  `stencil.distributed.make_distributed_step` block by
                  block with every fault kind applied at the exchange
                  layer, rolling back to device or disk snapshots.

A `FaultPlan` is a frozen tuple of `Fault`s pinned to mega-step or
exchange-block indices, built by hand, parsed from a
``kind@step[:key=val,...]`` spec string, or drawn from
``numpy.random.default_rng(seed)``: the same seed gives the same plan, and
`describe()` round-trips through `parse()`. `FaultInjector` owns the
mutable side (which faults have fired, how many stall attempts remain) and
the `health()` counters. Plans, strings, counters and sleep sequences are
the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FAULT_KINDS", "DEFAULT_LADDER", "ELASTIC_LADDER", "MESH_SHRINK",
    "ExchangeStalled", "RecoveryExhausted",
    "Fault", "FaultPlan", "FaultInjector", "DegradationLadder",
    "retry_with_backoff", "resilient_distributed_run",
]

#: every fault kind the plan grammar accepts
FAULT_KINDS = ("device_loss", "nan_poison", "halo_corruption",
               "exchange_stall", "cache_evict")

#: the degradation ladder of the exchange engines, fastest first. The
#: serving engine appends an implicit last rung, reshard down to fewer
#: slots, once both transports are exhausted.
DEFAULT_LADDER = ("remote_dma", "collective")

#: the distributed run's elastic last resort: gather, rebuild a smaller
#: stencil mesh, re-shard, continue (`resilient_distributed_run`)
MESH_SHRINK = "mesh_shrink"

#: the distributed run's full ladder: both transports, then shrink
ELASTIC_LADDER = DEFAULT_LADDER + (MESH_SHRINK,)

_FIELDS = ("u", "v", "w")
_MODES = ("nan", "inf")

_COUNTERS = ("faults_injected", "faults_skipped", "device_losses",
             "quarantines", "rollbacks", "retries", "degradations",
             "reshards", "cache_evictions", "snapshots",
             "replayed_blocks")

class ExchangeStalled(RuntimeError):
    """An exchange attempt hung (injected or real); retryable."""


class RecoveryExhausted(RuntimeError):
    """Every rung of the degradation ladder failed."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. `at_step` is the mega-step (serving engine)
    or exchange-block (distributed run) boundary the fault fires at.

    Kind-specific knobs:
      nan_poison      — `slot`, `field`, `mode` ("nan"/"inf");
                        `persistent` defaults True: the poison source
                        re-fires on replay, so rollback alone cannot
                        clear it and the engine must quarantine.
      halo_corruption — `slot`, `field`, `depth` (band rows poisoned);
                        one-shot by default: rollback + replay is clean.
      device_loss     — `reshard_to` (None -> half the batch).
      exchange_stall  — `stalls` consecutive attempts hang, but only
                        while the engine's CURRENT rung == `rung`;
                        degrading past the faulted transport clears it.
      cache_evict     — evicts the current step's built launcher (one
                        recorded miss, a rebuild, on the next launch).
    """
    kind: str
    at_step: int
    slot: int = 0
    field: str = "u"
    mode: str = "nan"
    reshard_to: Optional[int] = None
    stalls: int = 1
    rung: str = "remote_dma"
    depth: int = 1
    persistent: Optional[bool] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {self.at_step}")
        if self.field not in _FIELDS:
            raise ValueError(f"field must be one of {_FIELDS}, "
                             f"got {self.field!r}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.stalls < 1:
            raise ValueError(f"stalls must be >= 1, got {self.stalls}")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.reshard_to is not None and self.reshard_to < 1:
            raise ValueError(f"reshard_to must be >= 1, "
                             f"got {self.reshard_to}")

    @property
    def is_persistent(self) -> bool:
        """Persistent faults re-fire every time execution re-crosses
        `at_step` (a poisoned SOURCE survives rollback); one-shot faults
        are consumed on first firing (a transient glitch replays clean).
        """
        if self.persistent is not None:
            return self.persistent
        return self.kind == "nan_poison"

    def value(self) -> float:
        """The poison value for nan_poison / halo_corruption."""
        return float("nan") if self.mode == "nan" else float("inf")

    def describe(self) -> str:
        parts = []
        defaults = {f.name: f.default for f in dataclasses.fields(Fault)}
        for name in ("slot", "field", "mode", "reshard_to", "stalls",
                     "rung", "depth", "persistent"):
            val = getattr(self, name)
            if val != defaults[name]:
                parts.append(f"{name}={val}")
        spec = f"{self.kind}@{self.at_step}"
        return spec + (":" + ",".join(parts) if parts else "")


def _parse_value(key: str, raw: str):
    if key in ("field", "mode", "rung"):
        return raw
    if key == "persistent":
        return raw.lower() in ("1", "true", "yes")
    if key == "reshard_to" and raw.lower() == "none":
        return None
    return int(raw)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, seed-reproducible schedule of faults.

    Build directly, `parse()` a spec string
    (``"nan_poison@1:slot=1,mode=inf;device_loss@2:reshard_to=1"``), or
    draw a `random(seed, ...)` plan. `describe()` round-trips through
    `parse()` so artifacts record exactly what ran.
    """
    faults: Tuple[Fault, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``kind@step[:key=val,...]`` clauses joined by ";".
        Malformed specs raise ValueError NAMING the offending token —
        the clause, the step, the option item, the key, or the value —
        so a typo'd plan string is diagnosable from the message alone."""
        option_keys = tuple(f.name for f in dataclasses.fields(Fault)
                            if f.name not in ("kind", "at_step"))
        faults = []
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            head, _, tail = clause.partition(":")
            kind, sep, step = head.partition("@")
            if not sep:
                raise ValueError(
                    f"bad fault clause {clause!r}: expected kind@step"
                    f"[:key=val,...]")
            try:
                at_step = int(step)
            except ValueError:
                raise ValueError(f"bad fault step {step!r} in {clause!r}: "
                                 f"expected an integer") from None
            kw = {}
            if tail:
                for item in tail.split(","):
                    key, sep, raw = item.partition("=")
                    if not sep:
                        raise ValueError(f"bad fault option {item!r} in "
                                         f"{clause!r}: expected key=val")
                    key = key.strip()
                    if key not in option_keys:
                        raise ValueError(
                            f"unknown fault option key {key!r} in "
                            f"{clause!r}; expected one of {option_keys}")
                    try:
                        kw[key] = _parse_value(key, raw.strip())
                    except ValueError:
                        raise ValueError(
                            f"bad fault option value {raw.strip()!r} for "
                            f"{key!r} in {clause!r}") from None
            faults.append(Fault(kind=kind.strip(), at_step=at_step, **kw))
        return cls(faults=tuple(faults))

    @classmethod
    def random(cls, seed: int, *, n_steps: int, batch: int,
               n_faults: int = 3,
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultPlan":
        """A reproducible plan: same seed, same faults, always."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            kw = dict(kind=kind,
                      at_step=int(rng.integers(max(1, n_steps))))
            if kind in ("nan_poison", "halo_corruption"):
                kw["slot"] = int(rng.integers(max(1, batch)))
                kw["field"] = _FIELDS[int(rng.integers(3))]
                kw["mode"] = _MODES[int(rng.integers(2))]
            elif kind == "device_loss":
                kw["reshard_to"] = max(1, batch // 2)
            elif kind == "exchange_stall":
                kw["stalls"] = int(rng.integers(1, 3))
            faults.append(Fault(**kw))
        faults.sort(key=lambda f: (f.at_step, f.kind))
        return cls(faults=tuple(faults), seed=seed)

    def at(self, step: int) -> List[Fault]:
        return [f for f in self.faults if f.at_step == step]

    def describe(self) -> str:
        return ";".join(f.describe() for f in self.faults)

    def max_step(self) -> int:
        return max((f.at_step for f in self.faults), default=-1)


class FaultInjector:
    """The mutable runtime side of a `FaultPlan`: which faults have
    fired, how many stall attempts remain, and the `health()` counters
    every recovery action reports into.

    The injection protocol (shared by `StencilServingEngine` and
    `resilient_distributed_run`): at each boundary the driver calls
    `due(step)` and applies the returned faults itself — the injector
    never touches engine state; it only schedules, arms stalls, and
    counts. One-shot faults are consumed by `mark_fired`; persistent
    faults re-fire every time execution re-crosses their step (that is
    what forces the quarantine path — rollback alone cannot out-run a
    poisoned source).
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self.counters: Dict[str, int] = {k: 0 for k in _COUNTERS}
        self.transitions: List[str] = []
        self._consumed: set = set()
        self._stalls: Dict[int, List] = {}   # fault idx -> [rung, left]

    # -- scheduling --------------------------------------------------------
    def due(self, step: int) -> List[Tuple[int, Fault]]:
        """Faults firing at this boundary (one-shot faults already
        consumed are skipped). The caller applies them, then
        `mark_fired(idx)`s each."""
        out = []
        for idx, f in enumerate(self.plan.faults):
            if f.at_step == step and idx not in self._consumed:
                out.append((idx, f))
        return out

    def mark_fired(self, idx: int) -> None:
        f = self.plan.faults[idx]
        self.counters["faults_injected"] += 1
        if not f.is_persistent:
            self._consumed.add(idx)

    def skip(self, idx: int, reason: str) -> None:
        """A due fault the driver cannot apply (e.g. a poison aimed at
        an empty slot) — consumed and counted, never silently dropped."""
        self._consumed.add(idx)
        self.counters["faults_skipped"] += 1
        self.transitions.append(f"skipped[{idx}]: {reason}")

    # -- stalls ------------------------------------------------------------
    def arm_stall(self, idx: int, fault: Fault) -> None:
        """Register an exchange_stall: the next `fault.stalls` attempts
        on rung `fault.rung` raise `ExchangeStalled`."""
        self._stalls[idx] = [fault.rung, fault.stalls]

    def poll_stall(self, rung: str) -> None:
        """Called immediately before each exchange attempt. Raises
        `ExchangeStalled` while an armed stall matches the CURRENT rung;
        an armed stall whose rung was degraded past is cleared — the
        whole point of the ladder is that the fallback transport does
        not share the faulted engine's failure."""
        for idx in list(self._stalls):
            srung, left = self._stalls[idx]
            if left <= 0:
                del self._stalls[idx]
                continue
            if srung == rung:
                self._stalls[idx][1] -= 1
                raise ExchangeStalled(
                    f"injected stall on rung {rung!r} "
                    f"({self._stalls[idx][1]} more)")
            del self._stalls[idx]

    def clear_stalls(self) -> None:
        """Drop every armed stall — the reshard path's reset (the lost
        devices took the stalled transport with them)."""
        self._stalls.clear()

    # -- counters ----------------------------------------------------------
    def record(self, counter: str, n: int = 1) -> None:
        if counter not in self.counters:
            raise KeyError(f"unknown health counter {counter!r}; "
                           f"expected one of {_COUNTERS}")
        self.counters[counter] += n

    def note(self, event: str) -> None:
        self.transitions.append(event)

    def health(self) -> Dict[str, object]:
        """The counters surface the launch CLI prints and the tests
        assert on."""
        out: Dict[str, object] = dict(self.counters)
        out["transitions"] = list(self.transitions)
        out["plan"] = self.plan.describe()
        return out


class DegradationLadder:
    """Walks the exchange transports fastest-first, recording every
    transition. `degrade()` past the last rung raises
    `RecoveryExhausted` — the serving engine catches that and takes the
    implicit final rung (reshard down); the raw distributed run
    propagates it."""

    def __init__(self, rungs: Sequence[str] = DEFAULT_LADDER,
                 start: Optional[str] = None):
        self.rungs = tuple(rungs)
        if not self.rungs:
            raise ValueError("ladder needs at least one rung")
        if start is None:
            self._i = 0
        else:
            if start not in self.rungs:
                raise ValueError(f"start rung {start!r} not in "
                                 f"{self.rungs}")
            self._i = self.rungs.index(start)
        self.transitions: List[str] = []

    @property
    def current(self) -> str:
        return self.rungs[self._i]

    def degrade(self, reason: str = "") -> str:
        was = self.current
        if self._i + 1 >= len(self.rungs):
            self.transitions.append(f"{was} -> EXHAUSTED ({reason})")
            raise RecoveryExhausted(
                f"degradation ladder exhausted at {was!r}: {reason}")
        self._i += 1
        self.transitions.append(f"{was} -> {self.current} ({reason})")
        return self.current


def retry_with_backoff(attempt: Callable[[], object], *,
                       max_retries: int = 3, backoff_s: float = 0.0,
                       max_backoff_s: Optional[float] = None,
                       jitter_seed: Optional[int] = None,
                       sleeper: Callable[[float], None] = time.sleep,
                       on_retry: Optional[Callable[[int, Exception],
                                                   None]] = None):
    """One initial try plus up to `max_retries` retries of `attempt`,
    sleeping `min(backoff_s * 2**k, max_backoff_s)` before retry k —
    the ceiling keeps a deep retry budget from sleeping for `2**k`-ever
    (`max_backoff_s=None` preserves the uncapped legacy behaviour).
    `jitter_seed` draws a DETERMINISTIC jitter factor in [0.5, 1.0) per
    retry from `numpy.random.default_rng(jitter_seed)` — seeded, so the
    de-synchronised sleep schedule is still reproducible (same seed,
    same sleeps; the tests pin the sequence through the injected
    `sleeper`). Only `ExchangeStalled` is retryable — anything else
    propagates immediately. Re-raises the last stall when the budget is
    spent (the caller degrades the ladder)."""
    if max_retries < 0:
        raise ValueError(f"max_retries must be >= 0, got {max_retries}")
    if max_backoff_s is not None and max_backoff_s < 0:
        raise ValueError(f"max_backoff_s must be >= 0, got {max_backoff_s}")
    rng = (None if jitter_seed is None
           else np.random.default_rng(jitter_seed))
    err: Optional[ExchangeStalled] = None
    for k in range(max_retries + 1):
        try:
            return attempt()
        except ExchangeStalled as e:
            err = e
            if k == max_retries:
                break
            if on_retry is not None:
                on_retry(k, e)
            if backoff_s > 0:
                delay = backoff_s * (2 ** k)
                if max_backoff_s is not None:
                    delay = min(delay, max_backoff_s)
                if rng is not None:
                    delay *= 0.5 + 0.5 * float(rng.random())
                sleeper(delay)
    assert err is not None
    raise err


def _snapshot(mesh, shards, block: int, checkpoint_dir, keep_last: int):
    """The resilient run's snapshot after `block` blocks: the global fields
    gathered on the mesh's first device (new tensors), or None after
    writing them, with the block and its parity, through
    `training.checkpoint` when `checkpoint_dir` is given."""
    from repro_torch.stencil import distributed as D
    from repro_torch.training import checkpoint as CKPT

    if checkpoint_dir is None:
        return D.gather(mesh, shards)
    CKPT.save(checkpoint_dir, D._run_state(mesh, shards, block, None), block,
              keep_last=keep_last)
    return None


def _resized_mesh(mesh, nx: int, ny: int):
    """`mesh` rebuilt at (nx, ny): a loopback mesh (every shard on one
    device) stays on that device; a mesh of distinct cards asks for
    distinct cards again."""
    from repro_torch.launch import mesh as LM

    devices = None
    if len(set(mesh.devices)) == 1:
        devices = [mesh.devices[0]] * (nx * ny)
    return LM.resize_stencil_mesh(nx, ny, devices=devices)


def _all_finite(shards) -> bool:
    """Whether every value of every shard is finite: one flag per field
    reduced on its device, one read back to the host."""
    dev = shards[0][0].device
    return bool(torch.stack([torch.isfinite(f).all().to(dev)
                             for trio in shards for f in trio]).all())


def resilient_distributed_run(mesh, params, u, v, w, *, n_blocks: int,
                              T: int = 1, dt: float = 1.0,
                              local_kernel: str = "reference",
                              y_tile: Optional[int] = None,
                              injector: Optional[FaultInjector] = None,
                              ladder: Optional[DegradationLadder] = None,
                              max_retries: int = 3,
                              backoff_s: float = 0.0,
                              max_backoff_s: Optional[float] = None,
                              jitter_seed: Optional[int] = None,
                              sleeper: Callable[[float], None] = time.sleep,
                              checkpoint_every: int = 1,
                              checkpoint_dir=None,
                              keep_last: int = 3,
                              max_replays: int = 2,
                              verify_integrity: Optional[bool] = None,
                              guard: bool = True):
    """`make_distributed_step` over the (nx, ny) `StencilMesh` `mesh`,
    driven block by block on the global (X, Y, Z) fields (u, v, w) with
    every `FaultPlan` kind applied at the exchange layer (none skipped),
    recovering through the whole stack, as the reference's run does:

      * exchange_stall  - armed stalls hang the attempt; `retry_with_backoff`
        absorbs transients; a persistent stall degrades the ladder and the
        block runs again on the next transport (both engines build the
        same extended slabs bitwise). The ELASTIC_LADDER's `mesh_shrink`
        rung halves ny instead of exhausting.
      * halo_corruption - one band of the field is damaged on the wire
        (`corrupt_halo`); the checksummed exchange flags it and the run
        rolls back to the last snapshot and replays. On a 1-shard mesh
        there is no wire, so the damage lands on the edge rows the band
        would have been.
      * nan_poison      - the first owned row of the field on y-shard
        `slot % ny` is poisoned before the block; the finite guard
        (`guard=True`: a device-side `isfinite` over the advanced shards,
        one read back a block) detects it after the block, and rollback
        and replay recover. A persistent poison fires again on every
        replay: after `max_replays` replays of one block the run raises
        `RecoveryExhausted`.
      * device_loss     - gather, rebuild the mesh at ny = `reshard_to`
        (default half; larger models devices coming back), re-shard,
        continue. A loopback mesh stays on its one device
        (`_resized_mesh`).
      * cache_evict     - drops the built steps; the next block builds
        again.

    A snapshot is taken every `checkpoint_every` blocks: the global fields
    on the mesh's first device, or through `training.checkpoint`'s atomic
    writes when `checkpoint_dir` is given (the reference's leaf dict).
    `verify_integrity=None` verifies on CPU shards only: K7 carries no
    checksum on the card, so a plan with `halo_corruption` there starts
    its ladder at `collective` with `verify_integrity=True`. On a clean
    plan the result is bitwise what `make_distributed_run` gives. Returns
    ``(u, v, w), injector``: the global fields on the mesh's first device
    and the injector, whose `health()` counters and notes are the
    reference's for the same plan."""
    from repro_torch.stencil import distributed as D
    from repro_torch.training import checkpoint as CKPT

    injector = injector or FaultInjector()
    ladder = ladder or DegradationLadder(ELASTIC_LADDER)
    if ladder.current not in D.EXCHANGES:
        raise ValueError(f"ladder must start on an exchange rung "
                         f"{D.EXCHANGES}, got {ladder.current!r}")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, "
                         f"got {checkpoint_every}")
    if max_replays < 0:
        raise ValueError(f"max_replays must be >= 0, got {max_replays}")
    verify = (not mesh.is_cuda if verify_integrity is None
              else verify_integrity)

    X, Y, _ = u.shape
    n_x, n_y = mesh.shape
    cur_mesh = mesh
    # private copies: poison writes into the shards in place
    shards = D.shard(mesh, *(torch.as_tensor(f).clone() for f in (u, v, w)))
    rung = ladder.current
    steps: Dict[Tuple[str, int], Callable] = {}

    def build_step(rng_, parity, corrupt):
        return D.make_distributed_step(
            cur_mesh, params, T=T, dt=dt, local_kernel=local_kernel,
            y_tile=y_tile, exchange=rng_, dma_block_index=parity,
            verify_integrity=verify, corrupt_halo=corrupt)

    def get_step(parity, corrupt):
        if corrupt is not None:           # one-off, never cached
            return build_step(rung, parity, corrupt)
        key = (rung, parity)
        if key not in steps:
            steps[key] = build_step(rung, parity, None)
        return steps[key]

    # -- snapshot / rollback (on the device, optionally on disk) ----------
    snap = None
    snap_block = 0

    def take_snapshot(b):
        nonlocal snap, snap_block
        snap = _snapshot(cur_mesh, shards, b, checkpoint_dir, keep_last)
        snap_block = b
        injector.record("snapshots")

    def rollback(b, reason):
        nonlocal shards
        if checkpoint_dir is not None:
            like = {k: 0 for k in D._STATE_FIELDS + ("block", "parity")}
            arrays, _ = CKPT.restore(checkpoint_dir, like, step=snap_block)
            glob = [torch.from_numpy(arrays[k]) for k in D._STATE_FIELDS]
        else:
            glob = [g.clone() for g in snap]
        shards = D.shard(cur_mesh, *glob)
        injector.record("rollbacks")
        if b > snap_block:
            injector.record("replayed_blocks", b - snap_block)
        injector.note(f"block {b}: rollback to block {snap_block} "
                      f"({reason})")
        return snap_block

    # -- fault applicators -------------------------------------------------
    def poison_rows(fi, row_lo, rows, value):
        """Global rows [row_lo, row_lo + rows) of field `fi`, every x, set
        to `value` in the shards that hold them."""
        Yl = Y // n_y
        for s, trio in enumerate(shards):
            iy = cur_mesh.coords(s)[1]
            lo = max(row_lo, iy * Yl)
            hi = min(row_lo + rows, (iy + 1) * Yl)
            if lo < hi:
                trio[fi][:, lo - iy * Yl:hi - iy * Yl, :] = value

    def do_reshard(target, b, why):
        nonlocal cur_mesh, n_y, shards
        if Y % target:
            raise ValueError(f"cannot re-shard to ny={target}: global "
                             f"Y={Y} is not divisible")
        glob = D.gather(cur_mesh, shards)     # gather off the mesh
        cur_mesh = _resized_mesh(cur_mesh, n_x, target)
        old, n_y = n_y, target
        shards = D.shard(cur_mesh, *glob)
        steps.clear()
        injector.clear_stalls()   # the lost transport died with the mesh
        injector.record("reshards")
        injector.note(f"block {b}: {why}: re-shard ny {old} -> {target}")

    take_snapshot(0)
    replays: Dict[int, int] = {}
    block = 0
    while block < n_blocks:
        corrupt = None
        for idx, f in injector.due(block):
            if f.kind == "exchange_stall":
                injector.arm_stall(idx, f)
                injector.note(f"block {block}: armed stall on "
                              f"{f.rung} x{f.stalls}")
            elif f.kind == "cache_evict":
                steps.clear()
                injector.record("cache_evictions")
                injector.note(f"block {block}: evicted the compiled "
                              f"step cache")
            elif f.kind == "nan_poison":
                fi = _FIELDS.index(f.field)
                poison_rows(fi, (f.slot % n_y) * (Y // n_y), 1, f.value())
                injector.note(f"block {block}: poisoned {f.field} on "
                              f"shard {f.slot % n_y} ({f.mode})")
            elif f.kind == "halo_corruption":
                if n_y > 1 or n_x > 1:
                    corrupt = (_FIELDS.index(f.field), f.depth, f.value())
                    injector.note(f"block {block}: corrupting {f.field} "
                                  f"halo band on the wire (depth "
                                  f"{f.depth}, {f.mode})")
                else:
                    # 1-shard mesh: no wire; the band is the slab edge
                    poison_rows(_FIELDS.index(f.field), 0, f.depth,
                                f.value())
                    injector.note(f"block {block}: 1-shard mesh, "
                                  f"corrupted the {f.field} edge rows "
                                  f"the band would have carried")
            elif f.kind == "device_loss":
                injector.record("device_losses")
                do_reshard(f.reshard_to or max(1, n_y // 2), block,
                           "device loss" if (f.reshard_to or 0) <= n_y
                           else "device return")
            injector.mark_fired(idx)

        while True:                       # stall/degrade loop
            step = get_step(block % 2, corrupt)

            def attempt():
                injector.poll_stall(rung)
                return step(shards)

            try:
                out = retry_with_backoff(
                    attempt, max_retries=max_retries, backoff_s=backoff_s,
                    max_backoff_s=max_backoff_s, jitter_seed=jitter_seed,
                    sleeper=sleeper,
                    on_retry=lambda k, e: injector.record("retries"))
                break
            except ExchangeStalled as e:
                nxt = ladder.degrade(str(e))    # RecoveryExhausted up
                injector.record("degradations")
                injector.note(f"block {block}: {ladder.transitions[-1]}")
                if nxt == MESH_SHRINK:
                    if n_y <= 1:
                        raise RecoveryExhausted(
                            f"mesh-shrink rung reached with ny={n_y}: "
                            f"nothing left to shrink") from e
                    do_reshard(max(1, n_y // 2), block, "mesh shrink")
                    exch = [r for r in ladder.rungs if r in D.EXCHANGES]
                    rung = exch[-1] if exch else "collective"
                else:
                    rung = nxt

        cand, flags = out if verify else (out, None)
        bad = None
        if flags is not None and int(flags.sum()) > 0:
            bad = "halo corruption detected by band checksums"
        elif guard and not _all_finite(cand):
            bad = "non-finite field values detected"
        if bad is not None:
            n_rep = replays.get(block, 0) + 1
            replays[block] = n_rep
            if n_rep > max_replays:
                raise RecoveryExhausted(
                    f"block {block}: {bad} persists after {max_replays} "
                    f"replay(s) — a persistent fault source rollback "
                    f"cannot clear")
            block = rollback(block, bad)
            continue

        shards = cand
        block += 1
        if block % checkpoint_every == 0 or block == n_blocks:
            take_snapshot(block)
    return tuple(D.gather(cur_mesh, shards)), injector
