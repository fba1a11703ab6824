"""Deterministic fault injection and the recovery discipline of the
serving stack (the port's copy of `repro.serving.faults`; numpy only).

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
                  -> reshard-down, each transition recorded.

A `FaultPlan` is a frozen tuple of `Fault`s pinned to mega-step or
exchange-block indices, built by hand, parsed from a
``kind@step[:key=val,...]`` spec string, or drawn from
``numpy.random.default_rng(seed)``: the same seed gives the same plan, and
`describe()` round-trips through `parse()`. `FaultInjector` owns the
mutable side (which faults have fired, how many stall attempts remain) and
the `health()` counters. Plans, strings, counters and sleep sequences are
the reference's. `resilient_distributed_run`, the exchange-block driver,
waits for slice E2.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

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
#: stencil mesh, re-shard, continue (`resilient_distributed_run`, slice E2)
MESH_SHRINK = "mesh_shrink"

#: the distributed run's full ladder: both transports, then shrink
ELASTIC_LADDER = DEFAULT_LADDER + (MESH_SHRINK,)

_FIELDS = ("u", "v", "w")
_MODES = ("nan", "inf")

_COUNTERS = ("faults_injected", "faults_skipped", "device_losses",
             "quarantines", "rollbacks", "retries", "degradations",
             "reshards", "cache_evictions", "snapshots",
             "replayed_blocks")

LATER_SLICE = ("waits for a later slice of the port (E2: the distributed "
               "run's checkpointed, fault-injected driver)")


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



def resilient_distributed_run(*args, **kwargs):
    """The reference's fault-injected, checkpointed driver of
    `make_distributed_step`, block by block (every `FaultPlan` kind at the
    exchange layer, the elastic mesh shrink). Not ported yet: it needs the
    checkpointed segments of the distributed run."""
    raise NotImplementedError(f"resilient_distributed_run {LATER_SLICE}")
