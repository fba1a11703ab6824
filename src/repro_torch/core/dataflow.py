"""Dataflow-pipeline abstraction and analytic pipeline model (the port of
`repro.core.dataflow`; pure Python, no torch).

The paper's Fig. 4 restructure (load, prepare, compute and store as stages
that run at once, joined by streams) has two realisations in the port:

  1. *In-kernel*: each hand-written CUDA kernel stages its tiles through
     shared memory while earlier tiles compute (K2's dataflow rung, K8's
     TMA ring). That overlap is in the kernel; nothing to schedule here.

  2. *Host side*: `Pipeline` below, named stages over a stream of items
     with bounded queues (the paper's stream depth 16), one thread a
     stage. `core.chunking.ChunkScheduler` is the same structure on CUDA
     streams, for host-to-card transfers.

`pipeline_model` gives the analytic makespan the Fig. 3 and Fig. 5
reproductions use: the serial sum against the filled pipeline's slowest
stage plus its fill and drain.
"""
from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence

_STOP = object()


@dataclass
class Stage:
    name: str
    fn: Callable[[Any], Any]
    depth: int = 16                    # paper: HLS stream depth 16


_log = logging.getLogger(__name__)


class Pipeline:
    """Thread-per-stage dataflow pipeline with bounded inter-stage queues.

    `join_timeout` bounds the per-thread wait at drain time. A worker
    still alive past it is a LEAK (typically an upstream stage blocked on
    a bounded queue whose consumer died) and is never ignored: the leak
    is logged and, when no stage error explains it, raised as
    RuntimeError naming the hung stages."""

    def __init__(self, stages: Sequence[Stage], *,
                 join_timeout: float = 10.0):
        if join_timeout <= 0:
            raise ValueError(f"join_timeout must be > 0, got {join_timeout}")
        self.stages = list(stages)
        self.join_timeout = join_timeout

    def run(self, items: Sequence[Any]) -> List[Any]:
        qs = [queue.Queue(maxsize=max(s.depth, 1)) for s in self.stages]
        out_q: queue.Queue = queue.Queue()
        errs: List[BaseException] = []

        def worker(stage: Stage, q_in: queue.Queue, q_out: queue.Queue):
            while True:
                item = q_in.get()
                if item is _STOP:
                    q_out.put(_STOP)
                    return
                try:
                    q_out.put(stage.fn(item))
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)
                    q_out.put(_STOP)
                    return

        threads = []
        chain = qs + [out_q]
        for i, st in enumerate(self.stages):
            t = threading.Thread(target=worker,
                                 args=(st, chain[i], chain[i + 1]),
                                 daemon=True)
            t.start()
            threads.append(t)
        for it in items:
            qs[0].put(it)
        qs[0].put(_STOP)
        results = []
        while True:
            r = out_q.get()
            if r is _STOP:
                break
            results.append(r)
        leaked = []
        for st, t in zip(self.stages, threads):
            t.join(timeout=self.join_timeout)
            if t.is_alive():
                leaked.append(st.name)
        if leaked:
            _log.error(
                "pipeline leaked %d worker thread(s) still alive after "
                "%.1fs join: stages %s%s", len(leaked), self.join_timeout,
                leaked, " (stage error below)" if errs else "")
        if errs:
            raise errs[0]
        if leaked:
            raise RuntimeError(
                f"pipeline worker thread(s) for stage(s) {leaked} still "
                f"alive after {self.join_timeout}s join with no stage "
                "error: a bounded queue is wedged (likely a producer "
                "blocked on a dead consumer)")
        return results


def pipeline_model(stage_s: Dict[str, float], n_items: int,
                   *, overlapped: bool = True) -> Dict[str, float]:
    """Analytic makespan of a dataflow pipeline.

    serial      : sum over items of sum of stages (paper's pre-Fig.4 code)
    overlapped  : fill + n * max_stage + drain (paper's dataflow region)
    """
    total_stage = sum(stage_s.values())
    serial = n_items * total_stage
    bottleneck = max(stage_s.values())
    fill_drain = total_stage - bottleneck
    pipelined = fill_drain + n_items * bottleneck
    makespan = pipelined if overlapped else serial
    compute_total = n_items * stage_s.get("compute", 0.0)
    return {
        "serial_s": serial,
        "pipelined_s": pipelined if overlapped else serial,
        "bottleneck": max(stage_s, key=stage_s.get),
        "compute_share": compute_total / max(makespan, 1e-30),
        "speedup": serial / max(pipelined, 1e-30),
    }
