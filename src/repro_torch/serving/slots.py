"""Continuous-batching slot manager, shared by every serving engine (the
port's copy of `repro.serving.slots`; numpy only).

The paper's §IV kernel-pool/DMA-chunk overlap — new work arriving in
chunks while resident work keeps computing — is continuous batching: a
fixed pool of B slots, each either idle or owned by an in-flight request
with a step budget. `SlotManager` owns exactly that bookkeeping (and
nothing model-specific), so the LLM `ServingEngine` and the stencil
`StencilServingEngine` share one slot lifecycle:

    prime  : `occupy(slot, req, budget)` — a queued request takes an idle
             slot. A budget of 0 means the request is already complete at
             prime time (the engine emits whatever priming produced and
             never occupies the slot) — the budget off-by-one this class
             exists to make unrepresentable.
    step   : `tick(slot)` — one unit of work done; returns True when the
             budget is exhausted and the engine must complete the request.
    finish : `release(slot)` — back to idle, immediately re-primable
             while the other slots keep stepping.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np


class SlotManager:
    """Host-side lifecycle of a fixed pool of decode/step slots."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._live = np.zeros((n_slots,), bool)
        self._budget = np.zeros((n_slots,), np.int64)
        self._req: List[Optional[Any]] = [None] * n_slots

    # -- queries -----------------------------------------------------------
    def live_mask(self) -> np.ndarray:
        """Copy of the live flags, index-aligned with the slot axis."""
        return self._live.copy()

    def any_live(self) -> bool:
        return bool(self._live.any())

    def is_live(self, slot: int) -> bool:
        return bool(self._live[slot])

    def idle_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if not self._live[s]]

    def live_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if self._live[s]]

    def request(self, slot: int):
        return self._req[slot]

    def budget(self, slot: int) -> int:
        return int(self._budget[slot])

    # -- lifecycle ---------------------------------------------------------
    def occupy(self, slot: int, req, budget: int) -> None:
        """Give `slot` to `req` with `budget` steps of work remaining.
        `budget` must be >= 1: a request whose work is done at prime time
        is complete — completing it is the CALLER's move, not a slot
        state."""
        if self._live[slot]:
            raise ValueError(f"slot {slot} is already live")
        if budget < 1:
            raise ValueError(
                f"budget must be >= 1 to occupy a slot, got {budget}; a "
                "request already complete at prime time never occupies one")
        self._live[slot] = True
        self._budget[slot] = budget
        self._req[slot] = req

    def tick(self, slot: int) -> bool:
        """One unit of work done on `slot`; True when its budget is spent
        (the engine must complete and `release`)."""
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live")
        self._budget[slot] -= 1
        return bool(self._budget[slot] <= 0)

    def release(self, slot: int) -> None:
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live")
        self._live[slot] = False
        self._budget[slot] = 0
        self._req[slot] = None
