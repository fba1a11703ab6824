"""Forecast serving: many small advection domains batched into one
mega-launch of the fused ring (the port of `repro.serving.stencil_engine`).

A `StencilRequest` is a forecast job, ``(initial u/v/w fields, params,
n_steps)``. `StencilServingEngine` packs up to `batch_size` of them into
one padded mega-launch of K5 (`kernels.advection.advect_fused_batched`,
K1's kernel with the slot as a dimension of the launch grid) and runs the
finite guard (K4) over the (B, X) flags after each one. New jobs take
slots as old ones finish, through `serving.slots.SlotManager` (the paper's
§IV kernel pool, applied to many MONC domains).

Contracts (the reference's, held by tests/test_torch_stencil_serving.py):

  * Packing is exact: a request smaller than the slot is embedded at the
    origin with per-slot interior masks freezing everything outside its own
    extent and boundary ring, so the cropped outputs are bitwise-equal to
    sequential `advect_fused` runs on the unpadded fields.
  * Built launchers are cached on ``((B, X, Y, Z), T, dtype, n_blocks,
    exchange, (nx, ny))``, the reference's key, with hit, miss and evict
    counters and a bounded LRU. A launcher is the K5-then-K4 closure for
    its key; K1's launch plan for its shapes comes from the wrapper's caches.
  * Intermediate states stream back per slot (`StencilRequest.states`, one
    cropped (u, v, w) host snapshot per fused step); `out` is the last.
  * Faults come from a deterministic `serving.faults.FaultPlan` at
    mega-step boundaries (`lose_device_at` is the deprecated one-fault
    alias), and recovery is layered: the guard flags a poisoned slot the
    step it goes non-finite (a separate launch after the fused one, so the
    fields are the same bits as without it); snapshots of the in-flight
    state (a device clone, or through `training.checkpoint` on disk with
    `snapshot_dir`) roll any fault back and replay bitwise; a fault that
    fires again at the same (uid, step) after a rollback quarantines its
    slot; a stalled exchange is retried with backoff, then walks the
    `DegradationLadder` (a new cache key, one recorded miss), and an
    exhausted ladder reshards down; every action lands in `health()`.
  * A reshard re-packs the live slots into a smaller (or larger) batch on
    the same device (a new cache key); jobs that no longer fit resume from
    their in-flight state when slots free up, bitwise.

The batch (B, X, Y, Z), its masks (B, X) and (B, Y) and the per-slot
parameter leaves live on the domain's device between mega-steps, in the
domain's dtype (float32 or bfloat16; the masks stay f32). Requests come in
as host arrays (or tensors); states and outputs go back as host numpy
arrays. By design, a bf16 engine's states and outputs are float32 arrays
holding the bf16 values (an exact widening), where the reference's are
`ml_dtypes` bf16 arrays: numpy has no bf16 without that package, which the
port does not use. Its disk snapshots hold the reference's `<V2` words.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis import smem as SM
from repro_torch.core import roofline as R
from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.advection.ref import (AdvectParams,
                                               tensor_from_numpy)
from repro_torch.serving.faults import (DEFAULT_LADDER, DegradationLadder,
                                        ExchangeStalled, Fault, FaultInjector,
                                        FaultPlan, RecoveryExhausted,
                                        retry_with_backoff)
from repro_torch.serving.slots import SlotManager
from repro_torch.stencil.advection import AdvectionDomain
from repro_torch.training import checkpoint as CKPT


def _host(a) -> np.ndarray:
    """A request's array (numpy-convertible or a tensor) on the host; a
    bf16 tensor as float32 (exact)."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _tensor(a, dtype) -> torch.Tensor:
    """A tensor as it is, or a host array copied into a new one of `dtype`
    (a bf16 array bit for bit, `ref.tensor_from_numpy`)."""
    if torch.is_tensor(a):
        return a
    return tensor_from_numpy(a, dtype, "cpu")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as a numpy array: bf16 as float32 (exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@dataclasses.dataclass
class StencilRequest:
    """One forecast job: initial fields, coefficients and a step budget.

    `n_steps` counts fused steps (each advances `domain.fuse_T` Euler
    substeps); 0 means the job is complete at prime time and returns its
    initial fields. `params=None` uses the engine domain's coefficients; a
    per-tenant `AdvectParams` (same Z; numpy arrays or tensors) rides the
    slot's row of the parameter table. `status` walks pending -> running ->
    done, or -> quarantined (with `error` set and `out=None`) when the
    finite guard traps the slot.
    """
    uid: int
    u: Any                               # (Xr, Yr, Z) initial fields
    v: Any
    w: Any
    n_steps: int = 1
    params: Optional[AdvectParams] = None
    out: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    states: Optional[List[Tuple[np.ndarray, ...]]] = None
    status: str = "pending"
    error: Optional[str] = None


@dataclasses.dataclass
class _InFlight:
    """A live job's padded slot state (device tensors), detached for a
    reshard."""
    req: StencilRequest
    budget: int
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    xm: torch.Tensor
    ym: torch.Tensor
    params: Tuple[torch.Tensor, ...]
    extent: Tuple[int, int]


@dataclasses.dataclass
class _Snapshot:
    """Everything a rollback needs to replay from this boundary: the batch
    tensors (device clones), the slot assignments, the queue, and the
    length of every reachable request's streamed-state list (so replayed
    steps do not append twice). `disk_step` is set when the tensors were
    also written through `training.checkpoint.save`; the rollback then
    restores them from disk."""
    steps_run: int
    B: int
    arrays: Dict[str, torch.Tensor]
    extents: List[Tuple[int, int]]
    live: List[Tuple[int, int, int]]     # (slot, uid, budget)
    reqs: Dict[int, StencilRequest]
    states_len: Dict[int, int]
    queue: List[Any]
    done_uids: set
    disk_step: Optional[int]


class ExecutableCache:
    """Built-launcher cache: hit, miss and eviction counters and a bounded
    LRU.

    Keys are everything a mega-step's launcher depends on, ``(shape, T,
    dtype, n_blocks, exchange, mesh)``: a reshard (a new batch in `shape`)
    or a change of exchange records a miss and builds once, and every
    steady mega-step is a hit. Past `max_entries` the least recently used
    entry is evicted (a later return to its key is a counted miss).
    `evict(key)` drops one entry, the `cache_evict` fault's hook."""

    def __init__(self, max_entries: Optional[int] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._fns: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, build):
        fn = self._fns.get(key)
        if fn is None:
            self.misses += 1
            fn = self._fns[key] = build()
            if (self.max_entries is not None
                    and len(self._fns) > self.max_entries):
                self._fns.popitem(last=False)
                self.evictions += 1
        else:
            self.hits += 1
            self._fns.move_to_end(key)
        return fn

    def evict(self, key) -> bool:
        """Drop `key` if cached; True when something was evicted."""
        if key in self._fns:
            del self._fns[key]
            self.evictions += 1
            return True
        return False

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._fns), "evictions": self.evictions}


class StencilServingEngine:
    """Continuous-batching forecast server over K5 and K4.

    `domain` (variant "fused") fixes the padded slot shape ``(X, Y, Z)``,
    the fusion depth `fuse_T`, dt, the y-tile, the device, and the
    cache-key exchange, n_blocks and mesh (the mega-step runs one card's
    batched kernel). Requests smaller than the slot are padded and frozen
    by their masks; Z must match exactly (z has no interior mask).

    Fault tolerance knobs: `fault_plan` (a `FaultPlan`, or a spec string)
    schedules faults at mega-step boundaries; `snapshot_every=k` takes a
    recovery point every k mega-steps (None disables rollback, and a
    tripped guard quarantines at once); `snapshot_dir` also writes each
    snapshot through `training.checkpoint`'s atomic on-disk format;
    `max_retries`, `backoff_s` and `sleeper` bound the exchange-stall
    retries; `cache_max_entries` bounds the launcher cache (LRU).
    """

    def __init__(self, domain: AdvectionDomain, *, batch_size: int = 4,
                 fault_plan: Union[FaultPlan, str, None] = None,
                 snapshot_every: Optional[int] = 1,
                 snapshot_dir: Union[str, Path, None] = None,
                 max_retries: int = 3, backoff_s: float = 0.0,
                 sleeper=time.sleep,
                 cache_max_entries: Optional[int] = None):
        if domain.variant != "fused":
            raise ValueError("the serving tier packs the fused (v4) kernel; "
                             f"got variant={domain.variant!r}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if snapshot_every is not None and snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1 or None, got "
                             f"{snapshot_every}")
        self.domain = domain
        self.device = torch.device(domain.device)
        self.B = batch_size
        self.cache = ExecutableCache(max_entries=cache_max_entries)
        self.steps_run = 0
        # physical mega-step executions: unlike `steps_run` (the logical
        # step, rewound by a rollback so the replay is bitwise) this is
        # never restored, so faulted minus clean is the recovery overhead
        self.megasteps_executed = 0
        self._guard = True
        if isinstance(fault_plan, str):
            fault_plan = FaultPlan.parse(fault_plan)
        self._injector = FaultInjector(fault_plan)
        self._ladder = self._make_ladder()
        self._snapshot_every = snapshot_every
        self._snapshot_dir = Path(snapshot_dir) if snapshot_dir else None
        self._snap: Optional[_Snapshot] = None
        self._suspects: set = set()
        self._quarantined: set = set()
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._sleeper = sleeper
        self._last_ok: Optional[np.ndarray] = None
        self._alloc(batch_size)

    def _make_ladder(self) -> DegradationLadder:
        start = self.domain.exchange
        rungs = (DEFAULT_LADDER if start in DEFAULT_LADDER
                 else (start,) + tuple(DEFAULT_LADDER))
        return DegradationLadder(rungs, start=start)

    # -- storage -----------------------------------------------------------
    def _check_batch(self, batch_size: int) -> None:
        """Refuse, before any allocation or build, a batch K5 cannot run:
        K1's plan must exist for the slot shape at each pass's depth, the
        launch grid's slot axis must hold the batch, the batch's device
        buffers must fit `roofline.serving_max_batch`, and the mega-step's
        plan must fit the card (`analysis.smem.serving_ring_plan`)."""
        d = self.domain
        for Tk in set(K.fused_passes(d.fuse_T)):
            K._fused_block(d.Y, d.Z, Tk, d.y_tile)
        K.check_launch_grid((1, batch_size, 1),
                            f"serving engine batch_size={batch_size} (K5)")
        K.check_launch_grid((d.X, batch_size, 1),
                            f"serving engine batch_size={batch_size} (K4)")
        slot = d.serving_slot_bytes()
        max_b = R.serving_max_batch(slot)
        if batch_size > max_b:
            raise ValueError(
                f"serving engine slot buffers: batch_size={batch_size} needs "
                f"{batch_size} x {slot} B of device memory (the batch, the "
                f"launch's outputs and the rollback snapshot of "
                f"{(d.X, d.Y, d.Z)} slots), over the {R.HBM_PER_CHIP} B "
                f"budget; at most {max_b} slots fit: lower batch_size or "
                "the slot shape")
        # the mega-step's shared-memory plan (K5's block) and slot buffers,
        # before any allocation (the analysis layer's smem pass)
        SM.serving_ring_plan(d.X, d.Y, d.Z, batch=batch_size, T=d.fuse_T,
                             itemsize=d.itemsize, y_tile=d.y_tile,
                             context="serving engine slot buffers").check()

    def _alloc(self, batch_size: int) -> None:
        self._check_batch(batch_size)
        d = self.domain
        self.B = batch_size
        self.slots = SlotManager(batch_size)
        shape = (batch_size, d.X, d.Y, d.Z)
        dt = getattr(torch, d.dtype)
        self.u, self.v, self.w = (torch.zeros(shape, dtype=dt,
                                              device=self.device)
                                  for _ in range(3))
        self.xm = torch.zeros((batch_size, d.X), dtype=torch.float32,
                              device=self.device)
        self.ym = torch.zeros((batch_size, d.Y), dtype=torch.float32,
                              device=self.device)
        self._p = [leaf.expand((batch_size,) + tuple(leaf.shape)).clone()
                   for leaf in d.params]
        self._extent: List[Tuple[int, int]] = [(0, 0)] * batch_size

    def _step_key(self):
        d = self.domain
        return ((self.B, d.X, d.Y, d.Z), d.fuse_T, d.dtype, d.n_blocks,
                d.exchange, (d.mesh_nx, d.mesh_ny))

    def _build_step(self):
        """The mega-step's launcher for the current key: K5 then K4 (the
        wrapper takes K1's launch plan for (B, X, Y, Z, T) on this card from
        its caches)."""
        d = self.domain
        guard = self._guard

        def step(u, v, w, p, xm, ym):
            return K.advect_fused_batched(u, v, w, p, T=d.fuse_T, dt=d.dt,
                                          y_tile=d.y_tile, tiling=d.tiling,
                                          x_interior_mask=xm,
                                          y_interior_mask=ym, guard=guard)

        return step

    # -- slot lifecycle ----------------------------------------------------
    def _pack(self, slot: int, u, v, w, params: Optional[AdvectParams],
              extent: Tuple[int, int]) -> None:
        Xr, Yr = extent
        for dst, src in ((self.u, u), (self.v, v), (self.w, w)):
            dst[slot] = 0.0
            dst[slot, :Xr, :Yr] = _tensor(src, dst.dtype)
        # freeze everything outside the request's own interior: its
        # boundary ring behaves exactly like the unpadded kernel's walls,
        # so padding is bitwise-invisible
        self.xm[slot] = 0.0
        self.xm[slot, 1:Xr - 1] = 1.0
        self.ym[slot] = 0.0
        self.ym[slot, 1:Yr - 1] = 1.0
        leaves = params if params is not None else self.domain.params
        for dst, leaf in zip(self._p, leaves):
            dst[slot] = _tensor(leaf, dst.dtype)
        self._extent[slot] = extent

    def _prime(self, slot: int, req: StencilRequest) -> bool:
        """Pack `req` into `slot`; True when complete at prime time
        (``n_steps == 0``: the output is the initial state and the job
        never occupies the slot)."""
        d = self.domain
        if req.n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {req.n_steps} "
                             f"(request {req.uid})")
        u, v, w = (_host(f) for f in (req.u, req.v, req.w))
        shp = u.shape
        if v.shape != shp or w.shape != shp:
            raise ValueError(f"request {req.uid} field shapes differ")
        if len(shp) != 3:
            raise ValueError(f"request {req.uid} fields must be (X, Y, Z), "
                             f"got shape {shp}")
        Xr, Yr, Zr = shp
        if Zr != d.Z:
            raise ValueError(
                f"request {req.uid} has Z={Zr} but the engine slot is "
                f"Z={d.Z}: z is the lane dimension and cannot be padded")
        if Xr > d.X or Yr > d.Y:
            raise ValueError(
                f"request {req.uid} extent ({Xr}, {Yr}) exceeds the padded "
                f"slot shape ({d.X}, {d.Y}); domains must fit the slot")
        if Xr < 3 or Yr < 3:
            raise ValueError(
                f"request {req.uid} extent ({Xr}, {Yr}) has no interior "
                "cell; the stencil needs >= 3 points per decomposed axis")
        if (req.params is not None
                and tuple(_host(req.params.tzc1).shape) != (d.Z,)):
            raise ValueError(f"request {req.uid} params are not for Z={d.Z}")
        req.states = []
        if req.n_steps == 0:
            if d.dtype == "bfloat16":
                req.out = tuple(_to_numpy(_tensor(f, torch.bfloat16))
                                for f in (u, v, w))
            else:
                req.out = tuple(np.array(f, dtype=np.dtype(d.dtype))
                                for f in (u, v, w))
            req.status = "done"
            return True
        self._pack(slot, u, v, w, req.params, (Xr, Yr))
        self.slots.occupy(slot, req, req.n_steps)
        req.status = "running"
        return False

    def _resume(self, slot: int, flight: _InFlight) -> None:
        """Re-pack a job displaced by a reshard, from its in-flight state."""
        self.u[slot], self.v[slot], self.w[slot] = (flight.u, flight.v,
                                                    flight.w)
        self.xm[slot], self.ym[slot] = flight.xm, flight.ym
        for dst, leaf in zip(self._p, flight.params):
            dst[slot] = leaf
        self._extent[slot] = flight.extent
        self.slots.occupy(slot, flight.req, flight.budget)

    def _clear(self, slot: int) -> None:
        # an idle slot keeps stepping in the mega-launch; all-zero masks
        # freeze it, so it changes nothing
        self.xm[slot] = 0.0
        self.ym[slot] = 0.0
        self._extent[slot] = (0, 0)

    def _crop(self, slot: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        Xr, Yr = self._extent[slot]
        # a copy even on the CPU, where .cpu() would alias the batch that
        # later mega-steps and faults write in place
        return tuple(_to_numpy(f[slot, :Xr, :Yr].to("cpu", copy=True))
                     for f in (self.u, self.v, self.w))

    # -- the mega-step -----------------------------------------------------
    def _mega_step(self) -> None:
        fn = self.cache.get(self._step_key(), self._build_step)
        res = fn(self.u, self.v, self.w, AdvectParams(*self._p), self.xm,
                 self.ym)
        if self._guard:
            ou, ov, ow, gf = res
            # a slot is healthy iff every x-slice flag of its guard pass
            # is 1.0
            self._last_ok = (gf.amin(dim=1) > 0.0).cpu().numpy()
        else:
            ou, ov, ow = res
            self._last_ok = np.ones((self.B,), bool)
        self.u, self.v, self.w = ou, ov, ow
        self.steps_run += 1
        self.megasteps_executed += 1

    def _guarded_mega_step(self, queue: List[Any]) -> None:
        """One mega-step under the retry and degradation discipline: an
        armed exchange stall hangs the attempt, the bounded backoff loop
        absorbs a transient one, a persistent one degrades the ladder (a
        new exchange, so a new cache key and one recorded miss), and an
        exhausted ladder takes the implicit last rung: reshard down."""
        inj, lad = self._injector, self._ladder

        def attempt():
            inj.poll_stall(lad.current)
            self._mega_step()

        while True:
            try:
                retry_with_backoff(
                    attempt, max_retries=self.max_retries,
                    backoff_s=self.backoff_s, sleeper=self._sleeper,
                    on_retry=lambda k, e: inj.record("retries"))
                return
            except ExchangeStalled as e:
                try:
                    rung = lad.degrade(str(e))
                    inj.record("degradations")
                    inj.note(f"step {self.steps_run}: "
                             f"{lad.transitions[-1]}")
                    self.domain = dataclasses.replace(self.domain,
                                                      exchange=rung)
                except RecoveryExhausted:
                    n = max(self.B // 2, 1)
                    inj.record("reshards")
                    inj.note(f"step {self.steps_run}: ladder exhausted "
                             f"-> reshard to {n} slots")
                    inj.clear_stalls()
                    queue[:0] = self.reshard(n)

    # -- fault injection ---------------------------------------------------
    def _apply_faults(self, queue: List[Any]) -> None:
        """Apply the plan's faults due at this mega-step boundary."""
        inj = self._injector
        for idx, f in inj.due(self.steps_run):
            if f.kind == "device_loss":
                n = f.reshard_to if f.reshard_to is not None \
                    else max(self.B // 2, 1)
                inj.mark_fired(idx)
                inj.record("device_losses")
                inj.record("reshards")
                inj.note(f"step {self.steps_run}: device loss -> "
                         f"reshard to {n} slots")
                # displaced jobs resume ahead of queued fresh work
                queue[:0] = self.reshard(n)
            elif f.kind in ("nan_poison", "halo_corruption"):
                if f.slot >= self.B or not self.slots.is_live(f.slot):
                    inj.skip(idx, f"slot {f.slot} not live at step "
                                  f"{self.steps_run}")
                    continue
                arr = {"u": self.u, "v": self.v, "w": self.w}[f.field]
                Xr, Yr = self._extent[f.slot]
                if f.kind == "nan_poison":
                    # one interior cell: the stencil spreads it, the guard
                    # flags the whole slot this same step
                    arr[f.slot, 1, 1, 0] = f.value()
                else:
                    # a corrupted halo band: the mask freezes the boundary
                    # ring, so the poison sits there (caught by the guard)
                    # and cannot re-enter the interior; one-shot, so the
                    # rollback's replay is clean
                    arr[f.slot, :min(f.depth, Xr), :Yr, :] = f.value()
                inj.mark_fired(idx)
                inj.note(f"step {self.steps_run}: {f.kind} slot {f.slot} "
                         f"field {f.field} ({f.mode})")
            elif f.kind == "exchange_stall":
                inj.arm_stall(idx, f)
                inj.mark_fired(idx)
                inj.note(f"step {self.steps_run}: exchange stall armed on "
                         f"rung {f.rung!r} ({f.stalls} attempts)")
            elif f.kind == "cache_evict":
                if self.cache.evict(self._step_key()):
                    inj.record("cache_evictions")
                    inj.note(f"step {self.steps_run}: evicted current "
                             f"executable (re-trace on next launch)")
                else:
                    inj.note(f"step {self.steps_run}: cache_evict found "
                             f"no entry for the current key")
                inj.mark_fired(idx)

    # -- snapshots / rollback ----------------------------------------------
    def _reachable(self, queue: List[Any]) -> Dict[int, StencilRequest]:
        out: Dict[int, StencilRequest] = {}
        for s in self.slots.live_slots():
            r = self.slots.request(s)
            out[r.uid] = r
        for item in queue:
            r = item.req if isinstance(item, _InFlight) else item
            out[r.uid] = r
        return out

    def _arrays(self) -> Dict[str, torch.Tensor]:
        arrays = {"u": self.u, "v": self.v, "w": self.w, "xm": self.xm,
                  "ym": self.ym}
        for i, leaf in enumerate(self._p):
            arrays[f"p{i}"] = leaf
        return arrays

    def _take_snapshot(self, queue: List[Any], done: Dict[int, Any]) -> None:
        arrays = {k: a.clone() for k, a in self._arrays().items()}
        reqs = self._reachable(queue)
        disk_step = None
        if self._snapshot_dir is not None:
            CKPT.save(self._snapshot_dir, arrays, self.steps_run)
            disk_step = self.steps_run
        self._snap = _Snapshot(
            steps_run=self.steps_run, B=self.B, arrays=arrays,
            extents=list(self._extent),
            live=[(s, self.slots.request(s).uid, self.slots.budget(s))
                  for s in self.slots.live_slots()],
            reqs=reqs,
            states_len={uid: (len(r.states) if r.states is not None else -1)
                        for uid, r in reqs.items()},
            queue=list(queue), done_uids=set(done), disk_step=disk_step)
        self._injector.record("snapshots")

    def _rollback(self, queue: List[Any], done: Dict[int, Any],
                  reason: str) -> None:
        """Restore the last snapshot and replay from it. Quarantined jobs
        stay quarantined (their slot comes back empty); everything else
        (tensors, slot assignments, budgets, streamed states, the queue,
        the step counter) returns to the boundary, so the replay is
        bitwise-indistinguishable from a run that never faulted."""
        snap = self._snap
        assert snap is not None
        arrays = snap.arrays
        if self._snapshot_dir is not None and snap.disk_step is not None:
            # the atomic on-disk copy is the recovery point
            arrays, _ = CKPT.restore(self._snapshot_dir, snap.arrays,
                                     step=snap.disk_step)
        self._alloc(snap.B)
        for name, dst in self._arrays().items():
            dst.copy_(_tensor(arrays[name], dst.dtype))
        self._extent = list(snap.extents)
        for slot, uid, budget in snap.live:
            if uid in self._quarantined:
                self._clear(slot)
                for arr in (self.u, self.v, self.w):
                    arr[slot] = 0.0
                continue
            self.slots.occupy(slot, snap.reqs[uid], budget)
        for uid, req in snap.reqs.items():
            if uid in self._quarantined:
                continue
            n = snap.states_len[uid]
            if n < 0:
                req.states = None
            else:
                del req.states[n:]
            req.out = None
            req.status = "running" if any(u == uid for _, u, _ in snap.live) \
                else "pending"
        for uid in list(done):
            if uid not in snap.done_uids and uid not in self._quarantined:
                del done[uid]
        queue[:] = list(snap.queue)
        self.steps_run = snap.steps_run
        self._injector.record("rollbacks")
        self._injector.note(f"rollback to step {snap.steps_run}: {reason}")

    def _quarantine(self, slot: int, reason: str) -> StencilRequest:
        """Isolate a poisoned slot: error out its job, zero its data (so the
        frozen non-finite cells stop tripping the guard), free the slot."""
        req = self.slots.request(slot)
        req.status = "quarantined"
        req.error = reason
        req.out = None
        self._quarantined.add(req.uid)
        self.slots.release(slot)
        self._clear(slot)
        for arr in (self.u, self.v, self.w):
            arr[slot] = 0.0
        self._injector.record("quarantines")
        self._injector.note(f"quarantined uid {req.uid} (slot {slot}): "
                            f"{reason}")
        return req

    # -- fault tolerance ---------------------------------------------------
    def reshard(self, new_batch_size: int) -> List[_InFlight]:
        """Re-pack the engine onto `new_batch_size` slots on the same
        device (a device loss took the rest, or devices returned): live jobs
        are detached with their in-flight state, the batch is re-allocated
        (a new cache key, so the next mega-step records a miss and builds),
        and as many jobs as fit are re-packed at once. The rest come back
        for `run` to resume, state and budget intact, when slots free up.
        Slots are independent, so the re-pack is bitwise-invisible."""
        if new_batch_size < 1:
            raise ValueError(f"new_batch_size must be >= 1, got "
                             f"{new_batch_size}")
        flights = [
            _InFlight(req=self.slots.request(s), budget=self.slots.budget(s),
                      u=self.u[s].clone(), v=self.v[s].clone(),
                      w=self.w[s].clone(), xm=self.xm[s].clone(),
                      ym=self.ym[s].clone(),
                      params=tuple(leaf[s].clone() for leaf in self._p),
                      extent=self._extent[s])
            for s in self.slots.live_slots()]
        self._alloc(new_batch_size)
        for slot, flight in enumerate(flights[:new_batch_size]):
            self._resume(slot, flight)
        return flights[new_batch_size:]

    # -- driver ------------------------------------------------------------
    def run(self, requests: List[StencilRequest], *,
            lose_device_at: Optional[int] = None,
            reshard_to: Optional[int] = None,
            fault_plan: Union[FaultPlan, str, None] = None
            ) -> Dict[int, StencilRequest]:
        """Serve `requests` to completion; returns {uid: request}, each
        with `out` (the final cropped fields) and `states` (the streamed
        per-step snapshots), or ``status == "quarantined"`` with `error`
        set and ``out=None``.

        `fault_plan` (a `FaultPlan` or spec string) replaces the engine's
        injector for this run. `lose_device_at=k` is the deprecated
        one-fault alias: a device loss after the k-th mega-step, resharding
        onto `reshard_to` slots (default half, at least 1)."""
        if lose_device_at is not None:
            if fault_plan is not None:
                raise ValueError("pass either fault_plan or the deprecated "
                                 "lose_device_at, not both")
            if lose_device_at < 1:
                raise ValueError(f"lose_device_at must be >= 1, got "
                                 f"{lose_device_at}")
            n = reshard_to if reshard_to is not None else max(self.B // 2, 1)
            fault_plan = FaultPlan((Fault(
                "device_loss", at_step=self.steps_run + lose_device_at,
                reshard_to=n),))
        if fault_plan is not None:
            if isinstance(fault_plan, str):
                fault_plan = FaultPlan.parse(fault_plan)
            self._injector = FaultInjector(fault_plan)
        queue: List[Any] = list(requests)
        done: Dict[int, StencilRequest] = {}
        while queue or self.slots.any_live():
            if (self._snapshot_every is not None
                    and self.steps_run % self._snapshot_every == 0):
                self._take_snapshot(queue, done)
            for s in self.slots.idle_slots():
                if not queue:
                    break
                item = queue.pop(0)
                if isinstance(item, _InFlight):
                    self._resume(s, item)
                elif self._prime(s, item):
                    done[item.uid] = item
            self._apply_faults(queue)
            if not self.slots.any_live():
                continue
            step_idx = self.steps_run
            self._guarded_mega_step(queue)
            bad = [b for b in self.slots.live_slots()
                   if not self._last_ok[b]]
            if bad:
                fresh = [b for b in bad
                         if (self.slots.request(b).uid, step_idx)
                         not in self._suspects]
                if fresh and self._snap is not None:
                    # first sighting at this (uid, step): assume a
                    # transient, roll back and replay; a fault that fires
                    # again on the replay finds the site suspect and falls
                    # through to quarantine
                    for b in bad:
                        self._suspects.add(
                            (self.slots.request(b).uid, step_idx))
                    self._rollback(queue, done,
                                   reason=f"non-finite guard at step "
                                          f"{step_idx}, slots {bad}")
                    continue
                for b in bad:
                    req = self._quarantine(
                        b, f"non-finite field detected at step {step_idx}")
                    done[req.uid] = req
            for s in self.slots.live_slots():
                req = self.slots.request(s)
                state = self._crop(s)
                req.states.append(state)
                if self.slots.tick(s):
                    req.out = state
                    req.status = "done"
                    done[req.uid] = req
                    self.slots.release(s)
                    self._clear(s)
        return done

    # -- accounting --------------------------------------------------------
    def cache_stats(self) -> Dict[str, int]:
        return self.cache.stats()

    def health(self) -> Dict[str, Any]:
        """The fault and recovery counters: everything the injector
        recorded, the live exchange rung, the quarantined uids and the
        launcher-cache stats. Printed by `launch/serve.py`."""
        h = self._injector.health()
        h["exchange"] = self._ladder.current
        h["quarantined_uids"] = sorted(self._quarantined)
        h["cache"] = self.cache_stats()
        return h

    def guard_bytes_per_step(self) -> int:
        """Extra device-memory bytes the finite guard adds to one
        mega-launch (`roofline.guard_bytes_model` at the current batch)."""
        return dataclasses.replace(self.domain,
                                   batch=self.B).guard_bytes_per_step()

    def modelled_throughput(self) -> float:
        """Domains/s of this engine's mega-launch per
        `roofline.serving_throughput_model`, at the current batch size."""
        return dataclasses.replace(self.domain,
                                   batch=self.B).serving_throughput()
