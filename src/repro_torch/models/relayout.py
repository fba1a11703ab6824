"""Re-lay-out attention parameters between TP head layouts (the port of
`repro.models.relayout`).

Checkpoints store the logical (tp = 1) layout; on restore the params are
re-laid-out for the run's TP degree. Dead padded heads are zero-filled
and masked at run time, so the relayout preserves the model's function.
The functions take trees of tensors (the model's params) or of numpy
arrays (a checkpoint on the host) and return the same kind, leaf by leaf:
each leaf's map depends only on its key and on whether its dict is an
attention dict (`leaf_maps`), so a checkpoint maps one leaf at a time. A
DTensor leaf (params placed on a mesh) is gathered whole first, one leaf
at a time (`sharding.gather`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import HeadLayout, gather
from repro_torch.models.model import padded_vocab

# key -> (head axis, unstacked ndim); stacked layers shift axes by +1
_Q_KEYS = {"wq": (1, 3), "bq": (0, 2)}
_KV_KEYS = {"wk": (1, 3), "bk": (0, 2), "wv": (1, 3), "bv": (0, 2)}
_O_KEYS = {"wo": (0, 3)}


def _ax(arr, ax_nd):
    ax, nd = ax_nd
    return ax + (arr.ndim - nd)


def _take(arr, idx: np.ndarray, axis: int):
    if torch.is_tensor(arr):
        return torch.index_select(arr, axis, torch.as_tensor(
            idx, device=arr.device))
    return np.take(arr, idx, axis=axis)


def _gather_pad(arr, idx: np.ndarray, live: np.ndarray, axis: int):
    out = _take(arr, idx, axis)
    shape = [1] * out.ndim
    shape[axis] = len(idx)
    mask = live.reshape(shape)
    if torch.is_tensor(out):
        return out * torch.as_tensor(mask, dtype=out.dtype, device=out.device)
    return out * mask.astype(out.dtype)


def _is_attn(d) -> bool:
    return isinstance(d, dict) and "wq" in d and "wo" in d


def _resize(arr, axis: int, n: int):
    """`arr` cut or zero-padded to `n` along `axis`."""
    have = arr.shape[axis]
    if have >= n:
        return arr[:n] if axis == 0 else arr[:, :n]
    shape = list(arr.shape)
    shape[axis] = n - have
    if torch.is_tensor(arr):
        return torch.cat([arr, arr.new_zeros(shape)], dim=axis)
    return np.concatenate([arr, np.zeros(shape, arr.dtype)], axis=axis)


_VOCAB_AXES = {"tok_embed": 0, "lm_head": 1}


def _attn_leaf(key: str, lo: HeadLayout, logical: bool):
    """The map of one attention leaf (`key` of an attention dict) between
    the stored layout for `lo` and the logical one, or None where `key`
    has no head axis. The keys are independent: each takes its own head
    index along its own axis."""
    for keys, kind in ((_Q_KEYS, "q"), (_KV_KEYS, "kv"), (_O_KEYS, "q")):
        if key in keys:
            ax_nd = keys[key]
            break
    else:
        return None
    if logical:
        if kind == "kv":
            idx = np.arange(lo.n_kv) * lo.kv_repeat   # first stored copy
        else:
            # inverse permutation: logical head h lives at stored slot inv[h]
            qmask = lo.q_head_mask().astype(bool)
            idx = np.zeros((lo.n_q,), np.int64)
            for stored, logical_h in enumerate(lo.q_gather_index()):
                if qmask[stored]:
                    idx[logical_h] = stored
        return lambda a: _take(a, idx, _ax(a, ax_nd))
    if kind == "kv":
        idx = lo.kv_gather_index()
        live = np.ones((lo.n_kv_stored,), bool)
        if lo.n_kv_dead:
            live[-lo.n_kv_dead:] = False
    else:
        idx, live = lo.q_gather_index(), lo.q_head_mask().astype(bool)
    return lambda a: _gather_pad(a, idx, live, _ax(a, ax_nd))


def leaf_maps(params, cfg: ArchConfig, layout: HeadLayout,
              logical: bool):
    """`params`' structure (any tree of that structure: tensors, numpy
    arrays, `ParamSpec`s) with each leaf replaced by the function that
    maps that leaf alone from the stored layout for `layout` to the
    logical one (`logical=True`) or back, or by None where the leaf stays
    as it is. The vocabulary leaves are cut or padded to their size, each
    attention leaf with a head axis is re-indexed along it."""
    vocab = cfg.vocab_size if logical else padded_vocab(cfg, layout.tp)
    heads = not (layout.n_q_stored == layout.n_q
                 and layout.n_kv_stored == layout.n_kv)

    def walk(node, top: bool):
        if isinstance(node, dict):
            attn = heads and _is_attn(node)
            out = {}
            for k, v in node.items():
                if isinstance(v, (dict, list)):
                    out[k] = walk(v, False)
                elif top and k in _VOCAB_AXES:
                    out[k] = (lambda a, ax=_VOCAB_AXES[k]:
                              _resize(a, ax, vocab))
                else:
                    out[k] = _attn_leaf(k, layout, logical) if attn else None
            return out
        if isinstance(node, list):
            return [walk(v, False) for v in node]
        return None

    return walk(params, True)


def _apply(params, maps):
    """Each leaf of `params` gathered whole (`sharding.gather`: a DTensor
    leaf's full tensor) and mapped by its function in `maps`, one leaf at
    a time."""
    if isinstance(params, dict):
        return {k: _apply(v, maps[k]) for k, v in params.items()}
    if isinstance(params, list):
        return [_apply(v, m) for v, m in zip(params, maps)]
    full = gather(params)
    return full if maps is None else maps(full)


def to_logical(params, cfg: ArchConfig, layout: HeadLayout):
    return _apply(params, leaf_maps(params, cfg, layout, logical=True))


def from_logical(params, cfg: ArchConfig, layout: HeadLayout):
    return _apply(params, leaf_maps(params, cfg, layout, logical=False))


def relayout(params, cfg: ArchConfig, src: HeadLayout, dst: HeadLayout):
    return from_logical(to_logical(params, cfg, src), cfg, dst)
