"""Model assembly of the dense and ssm families: parameter trees,
forward, decode.

The port of the dense-family and ssm-family parts of `repro.models.model`,
with its uniform API:

  layout      = make_layout(cfg, tp)
  specs       = param_specs(cfg, layout)          # tree of ParamSpec
  params      = pspec.init_params(specs, gen)     # or abstract_params(specs)
  logits, _, kv = forward(params, batch, cfg, layout, mode="prefill")
  logits, kv    = decode_step(params, caches, batch, cfg, layout)

Parameters keep the reference's layout, stacked on a leading layer axis
`(n_layers, ...)`, so weights carry across one to one
(`models.convert.params_from_numpy`); `_run_stack` loops over that axis in
Python where the reference runs `lax.scan`. The other families (moe,
hybrid, encdec, vlm), training's loss, remat and sharding wait for slices
G1c and G2 (ROADMAP Queue 1) and raise `NotImplementedError` here.

JAX clamps an out-of-range index where torch would raise or read past the
end, so `_embed` refuses a token outside the vocabulary and `decode_step`
a position outside the cache (the serving engine reaches neither).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import HeadLayout, make_head_layout
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.blocks import Ctx
from repro_torch.pspec import ParamSpec, stack_specs, torch_dtype, tree_map

Params = Dict[str, Any]
FAMILIES = ("dense", "ssm")
BLOCK_KINDS = ("attn_mlp", "mamba")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family waits for slice G1c "
            f"(ROADMAP Queue 1); the port runs the dense and ssm families")
    if not cfg.scan_layers:
        raise NotImplementedError(
            "scan_layers=False (per-layer parameter lists) is not ported; "
            "the port keeps the reference's stacked (n_layers, ...) layout")


def make_layout(cfg: ArchConfig, tp: int = 1) -> HeadLayout:
    if cfg.n_heads == 0:  # attention-free
        return HeadLayout(0, 0, tp, 0, 1, 0, 0)
    return make_head_layout(cfg.n_heads, cfg.n_kv_heads, tp)


def padded_vocab(cfg: ArchConfig, tp: int) -> int:
    v = cfg.vocab_size
    if tp > 1 and v % tp:
        v = math.ceil(v / tp) * tp
    return v


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _norm_specs(cfg: ArchConfig, dt: str, bias: bool = False) -> Params:
    p = {"w": ParamSpec((cfg.d_model,), (None,), dt, "ones")}
    if bias:
        p["b"] = ParamSpec((cfg.d_model,), (None,), dt, "zeros")
    return p


def _apply_norm(p: Params, x, eps: float):
    if "b" in p:
        return L.layer_norm(x, p["w"], p["b"], eps)
    return L.rms_norm(x, p["w"], eps)


def _require_kind(kind: str, what: str = "block") -> None:
    if kind not in BLOCK_KINDS:
        raise NotImplementedError(f"the {kind!r} {what} waits for slice G1c "
                                  f"(ROADMAP Queue 1)")


def block_specs(cfg: ArchConfig, layout: HeadLayout, kind: str,
                dt: str) -> Params:
    _require_kind(kind)
    if kind == "mamba":
        return {"ln": _norm_specs(cfg, dt),
                "mamba": B.mamba_specs(cfg, dt)}
    ln_bias = cfg.family == "encdec"
    return {"ln1": _norm_specs(cfg, dt, ln_bias),
            "attn": B.attention_specs(cfg, layout, dt),
            "ln2": _norm_specs(cfg, dt, ln_bias),
            "mlp": B.mlp_specs(cfg, dt, bias=ln_bias)}


def layer_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """Block kind per layer for the decoder(-only) stack."""
    if cfg.family == "ssm":
        return ("mamba",) * cfg.n_layers
    if cfg.family == "hybrid":
        pat = []
        while len(pat) < cfg.n_layers:
            pat.extend(cfg.hybrid.pattern or ("rec", "rec", "attn"))
        return tuple("rec" if k == "rec" else "attn_mlp"
                     for k in pat[: cfg.n_layers])
    if cfg.family == "moe":
        k = cfg.moe.moe_every
        return tuple("moe" if (i % k == k - 1) else "attn_mlp"
                     for i in range(cfg.n_layers))
    return ("attn_mlp",) * cfg.n_layers


def _stacked(tree, n: int):
    return tree_map(lambda s: stack_specs(s, n), tree)


def param_specs(cfg: ArchConfig, layout: HeadLayout) -> Params:
    _require_ported(cfg)
    dt = cfg.param_dtype
    E = cfg.d_model
    Vp = padded_vocab(cfg, layout.tp)
    specs: Params = {}
    if not cfg.embeds_input:
        specs["tok_embed"] = ParamSpec((Vp, E), ("vocab", "embed"), dt,
                                       "embed", 0.02)
    specs["layers"] = _stacked(block_specs(cfg, layout, layer_kinds(cfg)[0],
                                           dt), cfg.n_layers)
    specs["final_norm"] = _norm_specs(cfg, dt)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((E, Vp), ("embed", "vocab"), dt,
                                     "fan_in")
    return specs


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def layer_cache_specs(cfg: ArchConfig, layout: HeadLayout, kind: str,
                      batch: int, max_len: int, dt: str) -> Params:
    _require_kind(kind, "cache")
    if kind == "mamba":
        Di, N, K = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.conv_k
        return {"conv": ParamSpec((batch, K - 1, Di),
                                  ("batch", None, "act_ffn"), dt, "zeros"),
                "state": ParamSpec((batch, Di, N),
                                   ("batch", "act_ffn", None), dt, "zeros")}
    D, Ks = cfg.head_dim, layout.n_kv_stored
    ax = ("batch", None, "act_kv_heads", None)
    return {"k": ParamSpec((batch, max_len, Ks, D), ax, dt, "zeros"),
            "v": ParamSpec((batch, max_len, Ks, D), ax, dt, "zeros")}


def cache_specs(cfg: ArchConfig, layout: HeadLayout, batch: int,
                max_len: int) -> Any:
    _require_ported(cfg)
    one = layer_cache_specs(cfg, layout, layer_kinds(cfg)[0], batch,
                            max_len, cfg.compute_dtype)
    return _stacked(one, cfg.n_layers)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_block(kind: str, p: Params, x, ctx: Ctx, cache=None):
    """Returns (x, new_cache)."""
    _require_kind(kind)
    cfg = ctx.cfg
    ctx = dataclasses.replace(ctx, cache=cache, new_cache=None)
    if kind == "mamba":
        x = x + B.mamba_apply(p["mamba"], _apply_norm(p["ln"], x,
                                                      cfg.norm_eps), ctx)
        return x, ctx.new_cache
    x = x + B.attention_apply(p["attn"], _apply_norm(p["ln1"], x,
                                                     cfg.norm_eps), ctx)
    x = x + B.mlp_apply(p["mlp"], _apply_norm(p["ln2"], x, cfg.norm_eps), ctx)
    return x, ctx.new_cache


def _layer(tree, i: int):
    """Layer i of a stacked tree, as views."""
    return tree_map(lambda a: a[i], tree, is_leaf=torch.is_tensor)


def _run_stack(params_layers, kinds, x, ctx: Ctx, caches=None):
    """Apply the layer stack in order (the reference's `lax.scan` over the
    stacked axis). Returns (x, new caches): in prefill, stacked like the
    parameters; in decode, `caches`, updated in place; else None."""
    new = []
    for i, kind in enumerate(kinds):
        cache = None if caches is None else _layer(caches, i)
        x, nc = _apply_block(kind, _layer(params_layers, i), x, ctx, cache)
        new.append(nc)
    if ctx.mode == "decode":
        return x, caches
    if ctx.mode != "prefill":
        return x, None
    return x, {k: torch.stack([c[k] for c in new]) for k in new[0]}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(params, cfg: ArchConfig, tokens):
    tab = params["tok_embed"]
    bad = (tokens < 0) | (tokens >= tab.shape[0])
    if bool(bad.any()):
        raise ValueError(f"token ids must lie in [0, {tab.shape[0]}); "
                         f"jnp.take would clamp or fill them, torch would "
                         f"read out of bounds")
    x = torch.index_select(tab, 0, tokens.reshape(-1).long())
    x = x.reshape(tuple(tokens.shape) + (tab.shape[1],))
    return x.to(torch_dtype(cfg.compute_dtype))


def _lm_logits(params, cfg: ArchConfig, layout: HeadLayout, x):
    if cfg.tie_embeddings:
        w = params["tok_embed"].to(x.dtype)
        logits = torch.einsum("bse,ve->bsv", x, w)
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    logits = logits.float()
    if cfg.logit_softcap:
        logits = L.softcap(logits, cfg.logit_softcap)
    Vp = logits.shape[-1]
    if Vp > cfg.vocab_size:
        mask = torch.arange(Vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full_like(logits, L.NEG_INF))
    return logits


def _default_positions(cfg: ArchConfig, batch_dict, Bsz, S, device):
    if "positions" in batch_dict:
        return batch_dict["positions"]
    return torch.arange(S, device=device)[None].expand(Bsz, S)


def forward(params, batch, cfg: ArchConfig, layout: HeadLayout, *,
            mode: str = "train"):
    """Full-sequence forward (train, forward only, or prefill).
    batch: {"inputs": (B, S) int}. Returns (logits (B, S, Vp) f32, aux,
    caches): the prefill caches are stacked on the layer axis: (L, B, S,
    Ks, D) for attention, (L, B, K-1, Di) and (L, B, Di, N) for mamba."""
    _require_ported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward runs mode 'train' or 'prefill', got "
                         f"{mode!r}; decode is `decode_step`")
    x = _embed(params, cfg, batch["inputs"])
    Bsz, S = x.shape[0], x.shape[1]
    positions = _default_positions(cfg, batch, Bsz, S, x.device)
    ctx = Ctx(cfg=cfg, layout=layout, positions=positions, mode=mode)
    x, caches = _run_stack(params["layers"], layer_kinds(cfg), x, ctx)
    x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_logits(params, cfg, layout, x), aux, caches


def decode_step(params, caches, batch, cfg: ArchConfig, layout: HeadLayout):
    """One-token decode. batch: {"token": (B,), "pos": (B,)}.

    Returns (logits (B, Vp), caches): the caches are updated in place (the
    reference returns new ones). Where there is a positional cache, a
    position outside [0, cache length) raises before anything is written;
    a mamba step reads no position."""
    _require_ported(cfg)
    tok, pos = batch["token"], batch["pos"]
    if "k" in caches:
        Lc = caches["k"].shape[-3]
        if bool(((pos < 0) | (pos >= Lc)).any()):
            raise ValueError(f"decode positions must lie in [0, {Lc}), the "
                             f"cache length; got {pos.tolist()}")
    pos = pos.long()
    x = _embed(params, cfg, tok[:, None])
    ctx = Ctx(cfg=cfg, layout=layout, mode="decode", pos=pos)
    x, caches = _run_stack(params["layers"], layer_kinds(cfg), x, ctx, caches)
    x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
    return _lm_logits(params, cfg, layout, x)[:, 0], caches
