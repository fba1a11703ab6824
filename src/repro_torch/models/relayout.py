"""Re-lay-out attention parameters between TP head layouts (the port of
`repro.models.relayout`).

Checkpoints store the logical (tp = 1) layout; on restore the params are
re-laid-out for the run's TP degree. Dead padded heads are zero-filled
and masked at run time, so the relayout preserves the model's function.
The functions take trees of tensors (the model's params) or of numpy
arrays (a checkpoint on the host) and return the same kind; DTensor
leaves (params placed on a mesh) are gathered whole first
(`pspec.gather_tree`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import HeadLayout
from repro_torch.models.model import padded_vocab
from repro_torch.pspec import gather_tree

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


def _attn_to_logical(p: Dict[str, Any], lo: HeadLayout) -> Dict[str, Any]:
    """Stored layout -> logical (tp=1, unpadded) layout."""
    qmask = lo.q_head_mask().astype(bool)
    qidx = lo.q_gather_index()
    # inverse permutation: logical head h lives at stored slot inv[h]
    inv = np.zeros((lo.n_q,), np.int64)
    for stored, logical in enumerate(qidx):
        if qmask[stored]:
            inv[logical] = stored
    kv_first = np.arange(lo.n_kv) * lo.kv_repeat  # first stored copy
    out = dict(p)
    for keys, idx in ((_Q_KEYS, inv), (_KV_KEYS, kv_first), (_O_KEYS, inv)):
        for k, ax in keys.items():
            if k in p:
                out[k] = _take(p[k], idx, _ax(p[k], ax))
    return out


def _attn_from_logical(p: Dict[str, Any], lo: HeadLayout) -> Dict[str, Any]:
    """Logical layout -> stored layout for `lo` (pad / replicate)."""
    qidx, qlive = lo.q_gather_index(), lo.q_head_mask().astype(bool)
    kidx = lo.kv_gather_index()
    klive = np.ones((lo.n_kv_stored,), bool)
    if lo.n_kv_dead:
        klive[-lo.n_kv_dead:] = False
    out = dict(p)
    for keys, idx, live in ((_Q_KEYS, qidx, qlive), (_KV_KEYS, kidx, klive),
                            (_O_KEYS, qidx, qlive)):
        for k, ax in keys.items():
            if k in p:
                out[k] = _gather_pad(p[k], idx, live, _ax(p[k], ax))
    return out


def _is_attn(d) -> bool:
    return isinstance(d, dict) and "wq" in d and "wo" in d


def _map_attn(tree, fn):
    if _is_attn(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_attn(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_attn(v, fn) for v in tree]
    return tree


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


def _resize_vocab(params, vocab: int):
    out = dict(params)
    if "tok_embed" in out:
        out["tok_embed"] = _resize(out["tok_embed"], 0, vocab)
    if "lm_head" in out:
        out["lm_head"] = _resize(out["lm_head"], 1, vocab)
    return out


def to_logical(params, cfg: ArchConfig, layout: HeadLayout):
    params = _resize_vocab(gather_tree(params), cfg.vocab_size)
    if layout.n_q_stored == layout.n_q and layout.n_kv_stored == layout.n_kv:
        return params
    return _map_attn(params, lambda p: _attn_to_logical(p, layout))


def from_logical(params, cfg: ArchConfig, layout: HeadLayout):
    params = _resize_vocab(gather_tree(params), padded_vocab(cfg, layout.tp))
    if layout.n_q_stored == layout.n_q and layout.n_kv_stored == layout.n_kv:
        return params
    return _map_attn(params, lambda p: _attn_from_logical(p, layout))


def relayout(params, cfg: ArchConfig, src: HeadLayout, dst: HeadLayout):
    return from_logical(to_logical(params, cfg, src), cfg, dst)
