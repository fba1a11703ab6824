"""Synthetic token data with prefetch (the port of `repro.data.pipeline`).

`synth_batch` draws the reference's deterministic batches with numpy, bit
for bit the same for every family: seeded per step, so a resumed run
consumes exactly the batches it would have seen. `Prefetcher` prepares
batch i + depth on a background thread while the caller trains on batch
i; its `put_fn` moves a batch to the training device (`to_device`: from
pinned host memory, without blocking, on CUDA).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.config import ArchConfig, RunShape


@dataclass
class DataConfig:
    seed: int = 1234
    prefetch_depth: int = 2   # batches in flight


def synth_batch(cfg: ArchConfig, shape: RunShape, step: int,
                seed: int = 1234, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Deterministic synthetic LM batch for a given step (restart-stable):
    the reference's draws, in its order."""
    B = batch or shape.global_batch
    S = seq or shape.seq_len
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(step) * 1_000_003)
    V = cfg.vocab_size
    if cfg.family == "encdec":
        Td = cfg.encdec.dec_len
        toks = rng.integers(0, V, (B, Td + 1), dtype=np.int32)
        return {"enc_embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "dec_inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.embeds_input:
        out = {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                   np.float32),
               "targets": rng.integers(0, V, (B, S), dtype=np.int32)}
        if cfg.pos == "mrope":
            out["positions"] = np.broadcast_to(
                np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
        return out
    # a Markov-ish stream, so the loss has structure to learn
    toks = rng.integers(0, V, (B, S + 1), dtype=np.int32)
    toks[:, 1:] = (toks[:, :-1] * 31 + toks[:, 1:] % 7) % V
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on `device`: on CUDA copied from
    pinned host memory without blocking the host (the copy is ordered on
    the current stream of the calling thread)."""
    device = torch.device(device)
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            with torch.cuda.device(device):
                out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


class Prefetcher:
    """Background-thread batch preparation into a bounded queue: yields
    (step, batch) from `start_step` on. `close()` stops the thread and
    joins it."""

    def __init__(self, make_batch: Callable[[int], Dict], start_step: int,
                 depth: int = 2, put_fn: Optional[Callable] = None):
        self.make_batch = make_batch
        self.put_fn = put_fn or (lambda b: to_device(b, "cpu"))
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            try:
                item = (s, self.put_fn(self.make_batch(s)))
            except BaseException as e:  # noqa: BLE001 (handed to the caller)
                item = (s, e)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], BaseException):
                return
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s, batch = self.q.get()
        if isinstance(batch, BaseException):
            raise batch
        return s, batch

    def close(self):
        self._stop.set()
        self._thread.join()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
