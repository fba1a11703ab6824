"""TP-aware GQA head layout (the port's copy of `HeadLayout` and
`make_head_layout` from `repro.distributed.sharding`; numpy only).

Attention heads use a group-aligned stored layout that pads or replicates q
and kv heads so that the head dim always divides the tensor-parallel degree.
At tp = 1, the only degree the port runs so far, the stored layout is the
logical one. The logical-axis rules, `constrain` and meshes wait for the
slice that ports sharding (ROADMAP Queue 1, G2b).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HeadLayout:
    """Stored (possibly padded/replicated) attention-head layout for a TP degree.

    q weights are stored as (embed, n_kv_stored * q_per_group, head_dim) and
    kv weights as (embed, n_kv_stored, head_dim). Stored group g corresponds
    to original kv head ``g // kv_repeat`` (or a dead pad group). Dead q heads
    are masked after attention so semantics match the unpadded model exactly.
    """

    n_q: int            # logical q heads
    n_kv: int           # logical kv heads
    tp: int
    n_kv_stored: int
    kv_repeat: int      # each original kv head stored this many times
    q_per_group: int    # stored q heads per stored kv group
    n_kv_dead: int      # trailing dead kv groups (pad case only)

    @property
    def n_q_stored(self) -> int:
        return self.n_kv_stored * self.q_per_group

    @property
    def q_live_fraction(self) -> float:
        return self.n_q / self.n_q_stored

    def q_head_mask(self) -> np.ndarray:
        """(n_q_stored,) 1.0 for live stored q heads, 0.0 for padding."""
        mask = np.zeros((self.n_q_stored,), np.float32)
        q_per_kv = self.n_q // self.n_kv
        for g in range(self.n_kv_stored - self.n_kv_dead):
            orig = g // self.kv_repeat
            slot = g % self.kv_repeat
            start = slot * self.q_per_group
            live = min(max(q_per_kv - start, 0), self.q_per_group)
            mask[g * self.q_per_group : g * self.q_per_group + live] = 1.0
        assert int(mask.sum()) == self.n_q, (mask.sum(), self.n_q)
        return mask

    def q_gather_index(self) -> np.ndarray:
        """(n_q_stored,) original q-head index feeding each stored slot (0 for dead)."""
        idx = np.zeros((self.n_q_stored,), np.int64)
        q_per_kv = self.n_q // self.n_kv
        for g in range(self.n_kv_stored - self.n_kv_dead):
            orig = g // self.kv_repeat
            slot = g % self.kv_repeat
            for j in range(self.q_per_group):
                src = slot * self.q_per_group + j
                if src < q_per_kv:
                    idx[g * self.q_per_group + j] = orig * q_per_kv + src
        return idx

    def kv_gather_index(self) -> np.ndarray:
        """(n_kv_stored,) original kv head stored in each group (0 for dead)."""
        idx = np.zeros((self.n_kv_stored,), np.int64)
        for g in range(self.n_kv_stored - self.n_kv_dead):
            idx[g] = g // self.kv_repeat
        return idx


def make_head_layout(n_q: int, n_kv: int, tp: int) -> HeadLayout:
    q_per_kv = n_q // n_kv
    assert n_q % n_kv == 0, "q heads must be a multiple of kv heads"
    if tp <= 1 or n_kv % tp == 0:
        # clean case: kv groups shard directly
        return HeadLayout(n_q, n_kv, tp, n_kv, 1, q_per_kv, 0)
    if tp % n_kv == 0:
        # replicate each kv head tp/n_kv times; split its q heads over copies
        rep = tp // n_kv
        qpg = math.ceil(q_per_kv / rep)
        return HeadLayout(n_q, n_kv, tp, tp, rep, qpg, 0)
    # pad kv heads up to a multiple of tp (e.g. MHA 20 heads on tp=16 -> 32)
    n_kv_stored = math.ceil(n_kv / tp) * tp
    return HeadLayout(n_q, n_kv, tp, n_kv_stored, 1, q_per_kv, n_kv_stored - n_kv)
