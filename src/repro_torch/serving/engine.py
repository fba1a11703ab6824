"""Serving: prefill -> decode cache management + a batched request engine.

The port of `repro.serving.engine`. Decode caches, stacked on a leading
layer axis where the parameters are, else a list of per-layer dicts:

  * full-attention layers: (B, max_len, Ks, D) linear buffers, written at
    `pos`;
  * hybrid local-attention layers: (B, Lc, Ks, D) ring buffers (slot =
    pos % Lc), Lc = min(window, max_len);
  * mamba / rec layers: the O(1) conv window and recurrent state;
  * encdec: the decoder's self-attention k, v (max_dec_len) and the
    encoder's projected ck, cv.

`prefill_to_decode_cache` converts the prefill caches (length = prompt)
into decode buffers of the serving length.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import HeadLayout
from repro_torch.models import model as M
from repro_torch.pspec import torch_dtype, tree_leaves, tree_map
from repro_torch.serving.slots import SlotManager


def _to_linear(k: torch.Tensor, max_len: int) -> torch.Tensor:
    """([L,] B, S, Ks, D) prefill cache -> ([L,] B, max_len, Ks, D)."""
    ax = k.ndim - 3  # the sequence axis
    if k.shape[ax] > max_len:
        raise ValueError(f"a prefill cache of {k.shape[ax]} positions does "
                         f"not fit a decode cache of {max_len}")
    shape = list(k.shape)
    shape[ax] = max_len
    out = k.new_zeros(shape)
    out.narrow(ax, 0, k.shape[ax]).copy_(k)
    return out


def _to_ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """([L,] B, S, ...) -> ([L,] B, W, ...) ring: the last W tokens at slot
    t % W."""
    ax = k.ndim - 3
    S, W = k.shape[ax], window
    shape = list(k.shape)
    shape[ax] = W
    out = k.new_zeros(shape)
    if S <= W:
        out.narrow(ax, 0, S).copy_(k)
        return out
    tpos = torch.arange(S - W, S, device=k.device) % W
    out.index_copy_(ax, tpos, k.narrow(ax, S - W, W))
    return out


def prefill_to_decode_cache(cfg: ArchConfig, caches, prompt_len: int,
                            max_len: int):
    """Convert prefill caches into decode buffers. Mamba and rec caches and
    encdec's (already padded to max_dec_len by the forward) come back as
    they are, so a decode step then updates them in place.

    A hybrid attention layer's ring holds min(window, max_len) slots, as
    `init_decode_cache` sizes it; the reference converts to `window` slots
    whatever max_len is, so its engine cannot serve below the window (ROADMAP
    Queue 3). Below the window the ring is a linear buffer of max_len, exact
    while every position stays below max_len (the engine retires a slot
    before it reaches max_len); a prompt longer than such a ring raises."""
    if caches is None:
        return None
    if cfg.family == "encdec":
        return caches

    def convert_layer(c):
        if "state" in c:          # mamba / rg-lru: O(1) state, pass through
            return c
        if cfg.family == "hybrid":
            W = min(cfg.hybrid.window, max_len)
            S = c["k"].shape[-3]
            if W < cfg.hybrid.window and S > W:
                raise ValueError(f"a prefill cache of {S} positions does "
                                 f"not fit a ring of max_len {max_len} "
                                 f"below the window {cfg.hybrid.window}")
            return {name: _to_ring(t, W) for name, t in c.items()}
        return {name: _to_linear(t, max_len) for name, t in c.items()}

    if isinstance(caches, list):
        return [convert_layer(c) for c in caches]
    return convert_layer(caches)


def init_decode_cache(cfg: ArchConfig, layout: HeadLayout, batch: int,
                      max_len: int, *, device):
    specs = M.cache_specs(cfg, layout, batch, max_len)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                                          device=device), specs)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    out: Optional[List[int]] = None


class ServingEngine:
    """Minimal batched greedy-decode engine over the functional model API.

    Slots of a fixed decode batch are filled as requests arrive: a finished
    slot is immediately re-primed with the next queued request while the
    other slots keep decoding. The slot lifecycle (live flags, step budgets,
    completion) lives in `SlotManager`, as in the reference, and the
    errors are the reference's.

    A primed request's cache goes into batch row `slot` of every layer
    (axis 1 of the stacked caches, axis 0 of each listed layer's). For
    stacked caches the reference's `_prime` writes it into layer `slot`
    instead (`dst.at[slot]` on the layer axis), so its later tokens are not
    the model's greedy tokens (ROADMAP Queue 3); the port's tokens are
    held to the reference model's greedy decode. For listed caches (the
    hybrid family, interleaved MoE) the reference writes the batch row, as
    the port does.

    It serves token prompts, as the reference's (`_prime` feeds
    `{"inputs": prompt}`): the vlm and encdec families, whose inputs are
    embeddings, raise `ValueError`; their path is `forward(mode="prefill")`
    then `decode_step`.

    The engine runs where its parameters lie. `stats` counts prefills and
    decode steps and their host seconds; each ends in a device-to-host
    read of the chosen tokens, so the seconds include the device's work.
    """

    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 4,
                 max_len: int = 256, tp: int = 1):
        if cfg.embeds_input or cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the serving engine takes token "
                             f"prompts, and the {cfg.family} family's "
                             f"inputs are embeddings (as in the reference, "
                             f"whose _prime feeds 'inputs'); run "
                             f"forward(mode='prefill') and decode_step")
        self.cfg = cfg
        self.layout = M.make_layout(cfg, tp)
        self.params = params
        self.device = tree_leaves(params, is_leaf=torch.is_tensor)[0].device
        self.B = batch_size
        self.max_len = max_len
        self.caches = init_decode_cache(cfg, self.layout, batch_size, max_len,
                                        device=self.device)
        self.pos = np.zeros((batch_size,), np.int32)
        self.next_token = np.zeros((batch_size,), np.int32)
        self.slots = SlotManager(batch_size)
        self.stats = {"prefills": 0, "prefill_s": 0.0, "decode_steps": 0,
                      "decode_s": 0.0}

    def _decode(self, tokens, pos) -> np.ndarray:
        logits, self.caches = M.decode_step(
            self.params, self.caches, {"token": tokens, "pos": pos},
            self.cfg, self.layout)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # -- slot management ---------------------------------------------------
    def _prime(self, slot: int, req: Request) -> bool:
        """Prefill `req` into `slot`. Prime time already emits the first
        new token (the prefill logits' argmax), so a request arrives with
        `max_new_tokens - 1` decode steps of budget — and one with
        ``max_new_tokens == 1`` is COMPLETE here: it never occupies the
        slot, and the caller must collect it instead of decoding an extra
        token past the budget. Returns True in that complete-at-prime
        case."""
        cfg, layout = self.cfg, self.layout
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens} "
                f"(request {req.uid})")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of request {req.uid} has {len(req.prompt)} tokens "
                f"but max_len is {self.max_len}: the prompt must be shorter "
                "than max_len (the decode-cache scatter would clip the "
                "out-of-bounds tail and corrupt decode)")
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None]
        logits, _, caches = M.forward(self.params, {"inputs": prompt}, cfg,
                                      layout, mode="prefill")
        caches = prefill_to_decode_cache(cfg, caches, prompt.shape[1],
                                         self.max_len)
        # this request's cache into batch row `slot` of every layer
        if isinstance(self.caches, list):
            for dst, src in zip(self.caches, caches):
                for name, d in dst.items():
                    d[slot] = src[name][0].to(d.dtype)
        else:
            for name, dst in self.caches.items():
                dst[:, slot] = caches[name][:, 0].to(dst.dtype)
        self.pos[slot] = len(req.prompt) - 1  # next decode writes at prompt_len
        nxt = int(torch.argmax(logits[0, -1]))
        self.stats["prefills"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t0
        req.out = [nxt]
        self.next_token[slot] = nxt
        if req.max_new_tokens == 1:
            return True
        self.slots.occupy(slot, req, req.max_new_tokens - 1)
        return False

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        queue = list(requests)
        self.next_token = np.zeros((self.B,), np.int32)
        done: Dict[int, List[int]] = {}
        while queue or self.slots.any_live():
            # fill idle slots (chunk arrival overlapping busy slots)
            for s in self.slots.idle_slots():
                if not queue:
                    break
                req = queue.pop(0)
                if self._prime(s, req):
                    done[req.uid] = req.out
            if not self.slots.any_live():
                continue  # everything primed this round completed at prime
            # dead slots are masked to a fixed (token 0, pos 0) feed: they
            # must not replay their previous occupant's stale state through
            # the decoder (their logits are discarded and a re-prime
            # overwrites the whole cache slot, so the masked write is inert)
            live = self.slots.live_mask()
            toks = torch.as_tensor(np.where(live, self.next_token, 0)
                                   .astype(np.int64), device=self.device)
            pos = torch.as_tensor(np.where(live, self.pos + 1, 0)
                                  .astype(np.int64), device=self.device)
            t0 = time.perf_counter()
            nxt = self._decode(toks, pos)
            self.stats["decode_steps"] += 1
            self.stats["decode_s"] += time.perf_counter() - t0
            for s in self.slots.live_slots():
                self.pos[s] += 1
                req = self.slots.request(s)
                req.out.append(int(nxt[s]))
                self.next_token[s] = nxt[s]
                if self.slots.tick(s) or self.pos[s] + 2 >= self.max_len:
                    done[req.uid] = req.out
                    self.slots.release(s)
        return done
