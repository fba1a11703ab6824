"""Checkpoint and restore of nested arrays with atomic writes (the port of
`repro.training.checkpoint`).

Layout on disk, the reference's:
    <dir>/step_000000123/
        manifest.json      # step, arch, keys, shapes, dtypes
        arrays.npz         # one entry per flattened leaf (on the host)
    <dir>/LATEST           # atomic pointer file

A state is a nested dict (or list, tuple, NamedTuple) whose leaves are
numpy arrays, scalars or tensors on any device; tensors are copied to the
host. Leaf keys are joined as the reference joins jax's key paths: dict
keys in sorted order, list and tuple indices, and ``.name`` for a
NamedTuple field, "/" between them; None and empty containers hold no
leaf. So either package restores what the other saved.

  * atomic rename: a crashed save never corrupts LATEST;
  * `keep_last` bounds disk usage; `AsyncCheckpointer` overlaps the
    serialisation with the caller's next step (one save in flight).

A bf16 leaf (a tensor) is written as the reference writes one: its raw
2-byte words, which `np.save` stores as `<V2` (numpy has no bfloat16
without `ml_dtypes`, which the port does not use), with "bfloat16" in the
manifest. Either package restores the other's bf16 leaves bitwise.

Restored leaves are numpy arrays, as in the reference, except where the
`like_state` leaf is a bf16 tensor: a `<V2` leaf then comes back as a bf16
tensor on the CPU, bit for bit (without such a leaf it stays the raw
`<V2` array the reference returns). With `cfg=` and
`layout=`, a train state's params are stored in the logical (tp = 1) head
layout (`models.relayout.to_logical`) and mapped back to `layout` on
restore (`from_logical`), each leaf then coerced to the dtype of its
`like_state` leaf: a restart on another TP degree re-lays-out on load.

A state placed on a `DeviceMesh` (DTensor leaves, one rank a card) is
saved and restored one leaf at a time, so that no rank holds more than
its own blocks and one whole leaf on its card. `AsyncCheckpointer.save`
gathers each leaf whole on every rank (a collective, on the caller's
thread, in the same order on every rank), copies it to the host on the
writing rank only and frees it before the next; the writing rank's host
copy goes to the writer thread, which writes the same archive as one
process would. `restore_placed` reads one leaf at a time on every rank,
re-lays it out (`relayout.leaf_maps`) and keeps the rank's own block
(`sharding.place`). The format does not change.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import pspec
from repro_torch.distributed import sharding as SH
from repro_torch.models import relayout as R


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container, in jax's flattening order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _walk(tree, [], out)
    return out


# The recursions are module functions, not closures: a closure that calls
# itself is a reference cycle, and one over `out` or `values` would keep
# every leaf of a dropped state (a sharded state's blocks on the card)
# alive until the cyclic collector runs.
def _walk(node, path: List[str], out: List[Tuple[str, Any]]) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append(("/".join(path), node))
        return
    for key, child in kids:
        _walk(child, path + [key], out)


def _unflatten(like, values: List[Any]):
    """`like`'s structure with its leaves replaced, in flattening order."""
    return _build(like, iter(values))


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*(_build(c, it) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def _to_host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array; a bf16 tensor as its raw 2-byte words
    (`<V2`), the reference's bytes for a bf16 leaf."""
    if torch.is_tensor(leaf):
        host = leaf.detach().to("cpu", copy=copy)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view("V2")
        return host.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _is_bf16(leaf) -> bool:
    return torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16


def _dtype_name(leaf, host: np.ndarray) -> str:
    """The manifest's dtype of a leaf: the reference's name, "bfloat16",
    for a bf16 one (a tensor, or an `ml_dtypes` array)."""
    if _is_bf16(leaf) or getattr(getattr(leaf, "dtype", None), "name",
                                 None) == "bfloat16":
        return "bfloat16"
    return str(host.dtype)


def _bf16_tensor(a: np.ndarray) -> torch.Tensor:
    """A bf16 leaf's raw 2-byte words (`<V2`, or an `ml_dtypes` array) as
    a bf16 tensor on the CPU, bit for bit."""
    return torch.from_numpy(np.array(a, order="C").view(np.int16)).view(
        torch.bfloat16)


def _restored(a: np.ndarray, like):
    """A stored leaf for a `like_state` leaf: a bf16 tensor where `like` is
    one and the leaf holds 2-byte words, else the array as stored."""
    if _is_bf16(like) and a.dtype.itemsize == 2 and a.dtype.kind == "V":
        return _bf16_tensor(a)
    return a


def _gathered_to_host(state, keep: bool):
    """`state` with every leaf copied to a host numpy array of its own (a
    CPU tensor's or an array's memory is not shared), one leaf at a time:
    a DTensor leaf gathered whole first (`sharding.gather`, a collective:
    every rank calls this with the same tree) and freed before the next
    leaf. Where not `keep` (a rank that writes nothing) the leaves are
    gathered and dropped, and None comes back."""
    hosts = []
    for _, leaf in _flatten_with_paths(state):
        full = SH.gather(leaf)
        if keep:
            hosts.append(_to_host(full, copy=True))
        del full
    return _unflatten(state, hosts) if keep else None


def _np_dtype(leaf):
    """The numpy dtype of a leaf (tensor, array or scalar), or None; None
    too for a bf16 tensor, which numpy has no dtype for (`_coerce`)."""
    if _is_bf16(leaf):
        return None
    if torch.is_tensor(leaf):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return getattr(leaf, "dtype", None)


def _coerce(a, like):
    """A restored leaf in the dtype of its `like_state` leaf: a bf16 tensor
    for a bf16 one (2-byte words bit for bit, other values rounded)."""
    if _is_bf16(like):
        if torch.is_tensor(a):
            return a.to(torch.bfloat16)
        a = np.asarray(a)
        if a.dtype.itemsize == 2 and a.dtype.kind == "V":
            return _bf16_tensor(a)
        return torch.from_numpy(np.array(a, order="C")).to(torch.bfloat16)
    dt = _np_dtype(like)
    return np.asarray(a) if dt is None else np.asarray(a, dtype=dt)


def save(ckpt_dir: str | Path, state: Dict[str, Any], step: int, *,
         cfg=None, layout=None, keep_last: int = 3) -> Path:
    """Synchronous atomic checkpoint save; with `cfg` and `layout`,
    state["params"] in the logical head layout."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step:09d}_{os.getpid()}"
    final = ckpt_dir / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    if cfg is not None and layout is not None:
        state = {**state, "params": R.to_logical(state["params"], cfg,
                                                 layout)}
    flat = _flatten_with_paths(state)
    leaves = [(k, _to_host(v)) for k, v in flat]
    np.savez(tmp / "arrays.npz", **dict(leaves))
    manifest = {
        "step": step,
        "time": time.time(),
        "arch": cfg.name if cfg else None,
        "keys": [k for k, _ in leaves],
        "shapes": {k: list(v.shape) for k, v in leaves},
        "dtypes": {k: _dtype_name(leaf, v)
                   for (k, v), (_, leaf) in zip(leaves, flat)},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic on POSIX
    latest_tmp = ckpt_dir / ".LATEST.tmp"
    latest_tmp.write_text(final.name)
    latest_tmp.rename(ckpt_dir / "LATEST")  # atomic pointer update
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: Path, keep_last: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Overlap checkpoint serialisation with the caller (one in flight).

    Under a `DeviceMesh` every rank holds one and calls `save` with its
    DTensor state at the same step (the gather is a collective); only
    the one made with `writer=True` writes. `seconds` holds, per save,
    the step, the seconds of the host copy (the gathers included) and,
    once done, of the write."""

    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3, *,
                 writer: bool = True):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self.writer = writer
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.seconds: List[Dict[str, float]] = []

    def save(self, state, step: int, *, cfg=None, layout=None):
        self.wait()
        # copy to host memory now (cheap beside the serialisation), so the
        # caller may go on changing its tensors; a placed state leaf by
        # leaf, every rank taking part in each leaf's gather
        t0 = time.perf_counter()
        host_state = _gathered_to_host(state, keep=self.writer)
        rec = {"step": step, "copy_s": time.perf_counter() - t0}
        self.seconds.append(rec)
        if not self.writer:
            return

        def work():
            t1 = time.perf_counter()
            try:
                save(self.ckpt_dir, host_state, step, cfg=cfg,
                     layout=layout, keep_last=self.keep_last)
                rec["write_s"] = time.perf_counter() - t1
            except BaseException as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self.last_error is not None:
                raise self.last_error


class CheckpointCorrupted(RuntimeError):
    """A checkpoint on disk is unreadable (truncated write, damaged
    archive, missing file). The message always names the offending path."""


def _is_complete(d: Path) -> bool:
    """A checkpoint directory is complete once both files the atomic
    rename published exist; `latest_step` ignores anything else."""
    return (d / "manifest.json").exists() and (d / "arrays.npz").exists()


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """Newest complete checkpoint step, or None. Prefers the LATEST
    pointer; a stale or partial target falls back to scanning the
    complete `step_*` directories (`.tmp_*` staging dirs never count)."""
    ckpt_dir = Path(ckpt_dir)
    p = ckpt_dir / "LATEST"
    if p.exists():
        name = p.read_text().strip()
        if _is_complete(ckpt_dir / name):
            return int(name.split("_")[1])
    steps = sorted(d for d in ckpt_dir.glob("step_*")
                   if d.is_dir() and _is_complete(d))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _archive(ckpt_dir: Path, step: Optional[int]) -> Tuple[Path, int]:
    """The arrays file of checkpoint `step` (the latest where None) and
    the step; FileNotFoundError where there is none."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    npz = ckpt_dir / f"step_{step:09d}" / "arrays.npz"
    if not npz.exists():
        raise FileNotFoundError(f"checkpoint step {step}: no arrays file "
                                f"at {npz}")
    return npz, step


@contextlib.contextmanager
def _members(npz: Path):
    """The archive open, as a function from a leaf's key to its array,
    read when asked for (`np.load` reads each member lazily). A leaf the
    archive lacks raises KeyError; a truncated or otherwise damaged
    archive raises `CheckpointCorrupted` naming the path."""
    def corrupted(e):
        return CheckpointCorrupted(
            f"checkpoint archive {npz} is unreadable "
            f"({type(e).__name__}: {e}); the write was likely truncated - "
            f"restore an earlier step")
    try:
        data = np.load(npz, allow_pickle=False)
        stored_keys = set(data.files)
    except FileNotFoundError:
        raise
    except Exception as e:   # torn npz: BadZipFile / EOFError / OSError / ...
        raise corrupted(e) from e

    def read(k: str) -> np.ndarray:
        if k not in stored_keys:
            raise KeyError(f"checkpoint missing leaf {k}")
        try:
            return np.asarray(data[k])
        except Exception as e:   # a torn member
            raise corrupted(e) from e
    try:
        yield read
    finally:
        data.close()


def restore(ckpt_dir: str | Path, like_state: Dict[str, Any], *,
            step: Optional[int] = None, cfg=None,
            layout=None) -> Tuple[Dict[str, Any], int]:
    """Restore into the structure of `like_state`, leaves as numpy arrays
    (a bf16 tensor where the `like_state` leaf is one); with `cfg` and
    `layout`, state["params"] re-laid-out from the logical
    head layout to `layout`, and every leaf coerced to the dtype of its
    `like_state` leaf (tensor, array or scalar).

    A truncated or otherwise damaged archive raises `CheckpointCorrupted`
    naming the path; a checkpoint that is not there raises
    FileNotFoundError; a leaf the archive lacks raises KeyError."""
    npz, step = _archive(Path(ckpt_dir), step)
    like_flat = _flatten_with_paths(like_state)
    with _members(npz) as read:
        vals = [_restored(read(k), like) for k, like in like_flat]
    state = _unflatten(like_state, vals)
    if cfg is not None and layout is not None:
        state = {**state, "params": R.from_logical(state["params"], cfg,
                                                   layout)}
        got = [v for _, v in _flatten_with_paths(state)]
        state = _unflatten(like_state, [
            _coerce(a, like) for a, (_, like) in zip(got, like_flat)])
    return state, step


def restore_placed(ckpt_dir: str | Path, specs, rules, mesh, *,
                   step: Optional[int] = None, cfg=None,
                   layout=None) -> Tuple[Dict[str, Any], int]:
    """Restore a state of `ParamSpec`s' structure (`training.step.
    state_specs`) onto `mesh`, one leaf at a time: each leaf read from the
    archive (on every rank), with `cfg` and `layout` state["params"]'s
    leaves re-laid-out from the logical head layout
    (`relayout.leaf_maps`), coerced to its spec's dtype and placed by its
    spec's logical axes (`sharding.place`: the rank keeps its own block on
    its card), the host copy dropped before the next leaf. Returns (the
    state of DTensors, the step). Errors as `restore`. Every rank must
    ask for the same step."""
    npz, step = _archive(Path(ckpt_dir), step)
    like = pspec.abstract_params(specs)
    maps = pspec.tree_map(lambda _: None, specs)
    if cfg is not None and layout is not None:
        maps["params"] = R.leaf_maps(specs["params"], cfg, layout,
                                     logical=False)
    shardings = pspec.tree_leaves(pspec.param_shardings(specs, rules, mesh))
    vals = []
    with _members(npz) as read:
        for (k, lk), sh, fn in zip(_flatten_with_paths(like), shardings,
                                   pspec.tree_leaves(maps)):
            a = _restored(read(k), lk)
            if fn is not None:
                a = fn(a)
            vals.append(SH.place(torch.as_tensor(_coerce(a, lk)), sh))
            del a
    return _unflatten(like, vals), step
