"""Chunked host-to-card streaming with per-chunk compute: the paper's §IV on
CUDA streams (the port of `repro.core.chunking`).

The paper cuts the host's field data into chunks, starts an advection
kernel the moment *its* chunk lands on the card, and copies results back
while other kernels still run, which it calls "effectively ... CUDA
streams" (Fig. 6). On an NVIDIA card that is literally the design:

  pinned host chunk -> copy-in stream -> compute stream (the kernel)
                    -> copy-out stream -> pinned host buffer -> numpy

`ChunkScheduler.run_overlapped` keeps at most `depth` chunks in flight (the
paper's kernel pool). Events order the three streams: a chunk's kernel
waits for its copy-in and its copy-out waits for its kernel. The host's
copies between numpy and the staging buffers run on two threads: the
issuing thread fills the input buffers, and one worker waits for each
chunk's copy-out in turn and copies it into the numpy result. On one
thread the two copies would run in series with the issue loop and pace
it, whatever the streams overlap. `run_serial` is the paper's baseline:
every copy in, then every kernel, then every copy back.

Four hazards shape the design:
  * `copy_(..., non_blocking=True)` from pageable memory is synchronous
    and overlaps nothing, so every host buffer a transfer touches is a
    pinned staging buffer: `depth` for the way in and `depth` for the way
    out, allocated once per shape and dtype and reused;
  * the caching allocator keeps a freed block for the stream it was made
    on, so the three streams are made once per scheduler: new streams each
    run would find no cached block and pay a `cudaMalloc`, which waits for
    the card, for every chunk;
  * a staging buffer is refilled only after the copy that last read it has
    finished: an input buffer after its copy-in's event, an output buffer
    after the worker has copied its last chunk into numpy;
  * a device tensor made on one stream and read on another is marked with
    `record_stream` and kept referenced until the reading copy's event,
    so the caching allocator does not hand its memory to the next chunk.

The host's copies between numpy and the staging buffers are torch's CPU
copies, which split a large copy over the intra-op threads (numpy's copy
runs on one).

On ``device="cpu"`` both methods run the same loop without streams, so the
ordering logic runs in the CPU tests. A CUDA scheduler on a machine
without a card raises; it never moves to the CPU.

`overlap_model` is the reference's analytic §IV model, copied as it is.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclass
class ChunkTiming:
    serial_s: float
    overlapped_s: float

    @property
    def speedup(self) -> float:
        return self.serial_s / max(self.overlapped_s, 1e-12)


def _arrays(chunk) -> Tuple[np.ndarray, ...]:
    return tuple(chunk) if isinstance(chunk, tuple) else (chunk,)


def _is_tuple(out) -> bool:
    return isinstance(out, (tuple, list))


def _outs(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if _is_tuple(out) else (out,)


def _result(arrays: Sequence[np.ndarray], tupled: bool):
    return tuple(arrays) if tupled else arrays[0]


def _new_arrays(pinned) -> List[np.ndarray]:
    """New numpy arrays shaped as one pinned slot's tensors."""
    return [np.empty(tuple(b.shape), dtype=b.numpy().dtype) for b in pinned]


class ChunkScheduler:
    """Overlap host-to-card transfers with per-chunk kernel compute.

    `kernel` takes one chunk's tensors on `device` (one argument per array
    of a tuple chunk) and returns a tensor or a tuple of tensors. Both run
    methods take numpy chunks, each a tuple of arrays or one array, all of
    one shape and dtype, and return numpy results in chunk order, each a
    tuple where the kernel returns one. On the card both stage every
    transfer through the same pinned buffers, so they differ only in what
    overlaps."""

    def __init__(self, kernel: Callable, *, depth: int = 4,
                 device="cuda"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.kernel = kernel
        self.depth = depth            # in-flight chunks (kernel pool size)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("ChunkScheduler(device='cuda') needs a "
                                   "CUDA device; none is visible")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self._pinned: Dict[tuple, List[Tuple[torch.Tensor, ...]]] = {}
        self._streams = None

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _staging(self, key: str, metas) -> List[Tuple[torch.Tensor, ...]]:
        """`depth` tuples of pinned host tensors of the given (shape,
        dtype)s, made once per key and reused."""
        k = (key,) + tuple(metas)
        bufs = self._pinned.get(k)
        if bufs is None:
            bufs = [tuple(torch.empty(shape, dtype=dt, pin_memory=True)
                          for shape, dt in metas)
                    for _ in range(self.depth)]
            self._pinned[k] = bufs
        return bufs

    def _in_staging(self, chunks):
        return self._staging("in", [(tuple(a.shape), _torch_dtype(a.dtype))
                                    for a in _arrays(chunks[0])])

    def _copy_in(self, i: int, chunk, bufs, read: list, stream):
        """Chunk i's arrays into pinned slot i % depth (after the copy that
        last read the slot), then to the card on `stream`. Returns the
        device tensors and the copy's event."""
        slot = i % self.depth
        if read[slot] is not None:
            read[slot].synchronize()
        pinned = bufs[slot]
        for buf, a in zip(pinned, _arrays(chunk)):
            if (tuple(a.shape) != tuple(buf.shape)
                    or _torch_dtype(a.dtype) != buf.dtype):
                raise ValueError(f"chunk {i} is {a.dtype} {a.shape}, the "
                                 f"first {buf.dtype} {tuple(buf.shape)}: "
                                 "chunks share one shape and dtype")
            # torch's CPU copy runs on the intra-op threads; numpy's on one
            buf.copy_(torch.from_numpy(a))
        with torch.cuda.stream(stream):
            dev = tuple(b.to(self.device, non_blocking=True) for b in pinned)
            ev = torch.cuda.Event()
            ev.record(stream)
        read[slot] = ev
        return dev, ev

    @staticmethod
    def _copy_out(outs, pinned, stream):
        """The kernel's outputs into a pinned slot on `stream` (each
        output marked as used there); returns the copy's event."""
        with torch.cuda.stream(stream):
            for buf, o in zip(pinned, outs):
                o.record_stream(stream)
                buf.copy_(o, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        return ev

    def _out_staging(self, outs):
        return self._staging("out", [(tuple(o.shape), o.dtype)
                                     for o in outs])

    # -- the paper's baseline -----------------------------------------------

    def run_serial(self, chunks: Sequence) -> List:
        """Paper baseline: all transfers, then all compute, then all
        fetch, each phase waited for before the next."""
        if not self.is_cuda:
            return self._run_cpu(chunks)
        n = len(chunks)
        if not n:
            return []
        stream = torch.cuda.current_stream(self.device)
        bufs, read = self._in_staging(chunks), [None] * self.depth
        dev = [self._copy_in(i, c, bufs, read, stream)[0]
               for i, c in enumerate(chunks)]
        torch.cuda.synchronize(self.device)
        outs = [self.kernel(*d) for d in dev]
        torch.cuda.synchronize(self.device)
        del dev
        results: List = [None] * n
        out_bufs = self._out_staging(_outs(outs[0]))
        pending: deque = deque()
        for i, out in enumerate(outs):
            if len(pending) >= self.depth:
                self._take(*pending.popleft())
            pinned = out_bufs[i % self.depth]
            ev = self._copy_out(_outs(out), pinned, stream)
            pending.append((ev, pinned, _new_arrays(pinned), results, i,
                            _is_tuple(out)))
        while pending:
            self._take(*pending.popleft())
        return results

    @staticmethod
    def _take(ev, pinned, dst, results, i, tupled, _keep=None) -> None:
        """Wait for one chunk's copy-out, then copy its pinned slot into
        the numpy arrays `dst`, which become result `i`."""
        ev.synchronize()
        for a, b in zip(dst, pinned):
            torch.from_numpy(a).copy_(b)
        results[i] = _result(dst, tupled)

    # -- §IV -----------------------------------------------------------------

    def run_overlapped(self, chunks: Sequence) -> List:
        """§IV: chunk i+1's copy-in is issued while chunk i computes and
        earlier chunks' results copy back, at most `depth` chunks in
        flight. This thread fills the input staging buffers and issues the
        streams' work; one worker thread waits for each chunk's copy-out
        and copies it into the numpy result, so the host's two copies run
        beside each other and beside the transfers."""
        if not self.is_cuda:
            return self._run_cpu(chunks)
        n = len(chunks)
        results: List = [None] * n
        if not n:
            return results
        if self._streams is None:
            self._streams = tuple(torch.cuda.Stream(self.device)
                                  for _ in range(3))
        s_in, s_cmp, s_out = self._streams
        bufs, read = self._in_staging(chunks), [None] * self.depth
        out_bufs = None
        taking: deque = deque()     # the worker's takes, oldest first
        with ThreadPoolExecutor(max_workers=1) as worker:
            for i, c in enumerate(chunks):
                d_in, ev_in = self._copy_in(i, c, bufs, read, s_in)
                s_cmp.wait_event(ev_in)
                with torch.cuda.stream(s_cmp):
                    for t in d_in:
                        t.record_stream(s_cmp)
                    out = self.kernel(*d_in)
                    ev_k = torch.cuda.Event()
                    ev_k.record(s_cmp)
                outs = _outs(out)
                if out_bufs is None:
                    out_bufs = self._out_staging(outs)
                if len(taking) >= self.depth:
                    # the out slot's last chunk is in its numpy result
                    taking.popleft().result()
                s_out.wait_event(ev_k)
                pinned = out_bufs[i % self.depth]
                ev_out = self._copy_out(outs, pinned, s_out)
                # the result arrays are made on this thread, as run_serial
                # makes them; the device tensors stay referenced until the
                # take
                taking.append(worker.submit(
                    self._take, ev_out, pinned, _new_arrays(pinned), results,
                    i, _is_tuple(out), (d_in, outs)))
            while taking:
                taking.popleft().result()
        return results

    # -- the CPU loop: the same order, no streams ---------------------------

    def _run_cpu(self, chunks: Sequence) -> List:
        results: List = [None] * len(chunks)
        inflight: deque = deque()

        def take(j, o):
            results[j] = _result([t.numpy().copy() for t in _outs(o)],
                                 _is_tuple(o))

        for i, c in enumerate(chunks):
            if len(inflight) >= self.depth:
                take(*inflight.popleft())
            d = tuple(torch.from_numpy(np.array(a, copy=True))
                      for a in _arrays(c))
            inflight.append((i, self.kernel(*d)))
        while inflight:
            take(*inflight.popleft())
        return results

    def time_both(self, chunks, *, warmup: bool = True) -> ChunkTiming:
        if warmup:
            self.run_serial(chunks[:1])
            self.run_overlapped(chunks[:1])
        t0 = time.perf_counter()
        self.run_serial(chunks)
        t1 = time.perf_counter()
        self.run_overlapped(chunks)
        t2 = time.perf_counter()
        return ChunkTiming(t1 - t0, t2 - t1)


_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.uint8): torch.uint8}


def _torch_dtype(dt) -> torch.dtype:
    try:
        return _NP_TO_TORCH[np.dtype(dt)]
    except KeyError:
        raise ValueError(f"no pinned staging for numpy dtype {dt}") from None


def overlap_model(total_bytes: float, compute_s: float, bw: float,
                  n_chunks: int) -> dict:
    """Analytic §IV model: transfer T=total_bytes/bw against compute C.

    serial      = T_in + C + T_out
    overlapped  = max(C, T) + first-chunk-in + last-chunk-out
    (the paper: "the first few input chunks and last few result chunks will
    need to be waited on regardless").
    """
    t_in = total_bytes / bw
    t_out = total_bytes / bw
    serial = t_in + compute_s + t_out
    chunk_in = t_in / n_chunks
    chunk_out = t_out / n_chunks
    overlapped = chunk_in + max(compute_s, t_in + t_out - chunk_in - chunk_out) + chunk_out
    return {"serial_s": serial, "overlapped_s": overlapped,
            "dma_overhead_serial": (t_in + t_out) / serial,
            "dma_overhead_overlapped": max(overlapped - compute_s, 0.0) / overlapped,
            "speedup": serial / overlapped}
