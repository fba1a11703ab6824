"""Model assembly: parameter trees, forward, decode.

The port of `repro.models.model` for every family (dense, ssm, moe,
hybrid, encdec, vlm), with its uniform API:

  layout      = make_layout(cfg, tp)
  specs       = param_specs(cfg, layout)          # tree of ParamSpec
  params      = pspec.init_params(specs, gen)     # or abstract_params(specs)
  loss, metrics   = loss_fn(params, batch, cfg, layout)          (train)
  logits, aux, kv = forward(params, batch, cfg, layout, mode="prefill")
  logits, kv      = decode_step(params, caches, batch, cfg, layout)

Parameters keep the reference's layout: a uniform stack under
`scan_layers` is stacked on a leading layer axis `(n_layers, ...)`, any
other stack (the hybrid and interleaved-MoE patterns, or
`scan_layers=False`) is a list of per-layer trees, and encdec keeps
stacked `enc_layers` and `dec_layers`. So weights carry across one to one
(`models.convert.params_from_numpy`); `_run_stack` loops over the layers
in Python where the reference runs `lax.scan`. A list may also hold
per-layer views of a stacked tree (`training.step.split_layers`: the train
step differentiates the layers as leaves of their own).

In `mode="train"` under autograd, `cfg.remat` recomputes in backward what
the reference's `jax.checkpoint` does: "full" saves only each layer's
input (`torch.utils.checkpoint`, non-reentrant), "dots" also the outputs
of the products without batch dimensions (`DOTS_POLICY`, the counterpart
of `checkpoint_dots_with_no_batch_dims`). `cfg.scan_group` g > 1 saves
only the boundaries of groups of g layers (the reference's sqrt-remat
group scan), and a non-uniform stack of at least 6 layers with a
repeating pattern saves only the pattern groups' boundaries (the
reference's `_run_grouped_pattern`; both in `_run_train_stack`).
Recompute runs the same operations on the same inputs, so the loss and
gradients are the flat run's, bitwise.

`forward`, `decode_step` and `loss_fn` take the reference's `rules` and
`mesh`. Under a `DeviceMesh` the params and the batch are DTensors
(`pspec.place_tree`), plain tensors made inside count as replicated
(`implicit_replication`), and the residual stream is constrained at the
reference's sites. The embedding table is gathered whole over the mesh
first: DTensor's vocab-sharded lookup (`MaskPartial`) fails on a batch
sharded over "data". The loss's logits stay split over the vocab, and
`lm_loss` computes its log-partition and target logits vocab-parallel, as
XLA partitions the reference's. Without a `DeviceMesh` the rules change
nothing.

JAX clamps an out-of-range index where torch would raise or read past the
end, so `_embed` refuses a token outside the vocabulary and `decode_step`
a position outside a linear cache (the serving engine reaches neither).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import (HeadLayout, Rules,
                                              is_device_mesh, is_dtensor,
                                              make_head_layout, vocab_offset)
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.blocks import Ctx
from repro_torch.pspec import ParamSpec, stack_specs, torch_dtype, tree_map

Params = Dict[str, Any]


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


def block_specs(cfg: ArchConfig, layout: HeadLayout, kind: str,
                dt: str) -> Params:
    ln_bias = cfg.family == "encdec"
    if kind == "attn_mlp":
        return {"ln1": _norm_specs(cfg, dt, ln_bias),
                "attn": B.attention_specs(cfg, layout, dt),
                "ln2": _norm_specs(cfg, dt, ln_bias),
                "mlp": B.mlp_specs(cfg, dt, bias=ln_bias)}
    if kind == "moe":
        return {"ln1": _norm_specs(cfg, dt),
                "attn": B.attention_specs(cfg, layout, dt),
                "ln2": _norm_specs(cfg, dt),
                "moe": B.moe_specs(cfg, dt)}
    if kind == "mamba":
        return {"ln": _norm_specs(cfg, dt),
                "mamba": B.mamba_specs(cfg, dt)}
    if kind == "rec":
        return {"ln1": _norm_specs(cfg, dt),
                "rec": B.rglru_specs(cfg, dt),
                "ln2": _norm_specs(cfg, dt),
                "mlp": B.mlp_specs(cfg, dt)}
    if kind == "dec":  # enc-dec decoder layer: self + cross + mlp
        return {"ln1": _norm_specs(cfg, dt, True),
                "self": B.attention_specs(cfg, layout, dt),
                "ln2": _norm_specs(cfg, dt, True),
                "cross": B.attention_specs(cfg, layout, dt),
                "ln3": _norm_specs(cfg, dt, True),
                "mlp": B.mlp_specs(cfg, dt, bias=True)}
    raise ValueError(kind)


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


def _uniform(kinds) -> bool:
    return len(set(kinds)) == 1


def _scanned(cfg: ArchConfig) -> bool:
    """Whether the layers are stacked on a leading axis (else a list)."""
    return cfg.scan_layers and _uniform(layer_kinds(cfg))


def _stacked(tree, n: int):
    return tree_map(lambda s: stack_specs(s, n), tree)


def param_specs(cfg: ArchConfig, layout: HeadLayout) -> Params:
    dt = cfg.param_dtype
    E = cfg.d_model
    Vp = padded_vocab(cfg, layout.tp)
    specs: Params = {}

    if cfg.family == "encdec":
        e = cfg.encdec
        specs["tok_embed"] = ParamSpec((Vp, E), ("vocab", "embed"), dt,
                                       "embed", 0.02)
        specs["dec_pos"] = ParamSpec((e.max_dec_len, E), (None, "embed"), dt,
                                     "embed", 0.02)
        specs["enc_layers"] = _stacked(
            block_specs(cfg, layout, "attn_mlp", dt), e.enc_layers)
        specs["dec_layers"] = _stacked(block_specs(cfg, layout, "dec", dt),
                                       e.dec_layers)
        specs["enc_norm"] = _norm_specs(cfg, dt, True)
        specs["final_norm"] = _norm_specs(cfg, dt, True)
        return specs

    if not cfg.embeds_input:
        specs["tok_embed"] = ParamSpec((Vp, E), ("vocab", "embed"), dt,
                                       "embed", 0.02)
    kinds = layer_kinds(cfg)
    if _scanned(cfg):
        specs["layers"] = _stacked(block_specs(cfg, layout, kinds[0], dt),
                                   cfg.n_layers)
    else:
        specs["layers"] = [block_specs(cfg, layout, k, dt) for k in kinds]
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
    D = cfg.head_dim
    Ks = layout.n_kv_stored
    ax = ("batch", None, "act_kv_heads", None)
    if kind in ("attn_mlp", "moe"):
        W = cfg.hybrid.window if cfg.family == "hybrid" else 0
        Lc = min(max_len, W) if W else max_len
        return {"k": ParamSpec((batch, Lc, Ks, D), ax, dt, "zeros"),
                "v": ParamSpec((batch, Lc, Ks, D), ax, dt, "zeros")}
    if kind == "mamba":
        Di, N, K = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.conv_k
        return {"conv": ParamSpec((batch, K - 1, Di),
                                  ("batch", None, "act_ffn"), dt, "zeros"),
                "state": ParamSpec((batch, Di, N),
                                   ("batch", "act_ffn", None), dt, "zeros")}
    if kind == "rec":
        Dr, K = cfg.hybrid.d_rnn, cfg.hybrid.conv_k
        return {"conv": ParamSpec((batch, K - 1, Dr),
                                  ("batch", None, "act_ffn"), dt, "zeros"),
                "state": ParamSpec((batch, Dr), ("batch", "act_ffn"), dt,
                                   "zeros")}
    if kind == "dec":
        e = cfg.encdec
        return {"k": ParamSpec((batch, e.max_dec_len, Ks, D), ax, dt,
                               "zeros"),
                "v": ParamSpec((batch, e.max_dec_len, Ks, D), ax, dt,
                               "zeros"),
                "ck": ParamSpec((batch, max_len, Ks, D), ax, dt, "zeros"),
                "cv": ParamSpec((batch, max_len, Ks, D), ax, dt, "zeros")}
    raise ValueError(kind)


def cache_specs(cfg: ArchConfig, layout: HeadLayout, batch: int,
                max_len: int) -> Any:
    dt = cfg.compute_dtype
    if cfg.family == "encdec":
        return _stacked(layer_cache_specs(cfg, layout, "dec", batch, max_len,
                                          dt), cfg.encdec.dec_layers)
    kinds = layer_kinds(cfg)
    if _scanned(cfg):
        return _stacked(layer_cache_specs(cfg, layout, kinds[0], batch,
                                          max_len, dt), cfg.n_layers)
    return [layer_cache_specs(cfg, layout, k, batch, max_len, dt)
            for k in kinds]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_block(kind: str, p: Params, x, ctx: Ctx, cache=None):
    """Returns (x, aux, new_cache)."""
    cfg = ctx.cfg
    ctx = dataclasses.replace(ctx, cache=cache, new_cache=None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "attn_mlp":
        window = cfg.hybrid.window if cfg.family == "hybrid" else 0
        x = x + B.attention_apply(p["attn"], _apply_norm(p["ln1"], x,
                                                         cfg.norm_eps),
                                  ctx, window=window)
        x = x + B.mlp_apply(p["mlp"], _apply_norm(p["ln2"], x, cfg.norm_eps),
                            ctx)
    elif kind == "moe":
        x = x + B.attention_apply(p["attn"], _apply_norm(p["ln1"], x,
                                                         cfg.norm_eps), ctx)
        out, aux = B.moe_apply(p["moe"], _apply_norm(p["ln2"], x,
                                                     cfg.norm_eps), ctx)
        x = x + out
    elif kind == "mamba":
        x = x + B.mamba_apply(p["mamba"], _apply_norm(p["ln"], x,
                                                      cfg.norm_eps), ctx)
    elif kind == "rec":
        x = x + B.rglru_apply(p["rec"], _apply_norm(p["ln1"], x,
                                                    cfg.norm_eps), ctx)
        x = x + B.mlp_apply(p["mlp"], _apply_norm(p["ln2"], x, cfg.norm_eps),
                            ctx)
    elif kind == "enc":
        sub = dataclasses.replace(ctx, causal=False)
        x = x + B.attention_apply(p["attn"], _apply_norm(p["ln1"], x,
                                                         cfg.norm_eps),
                                  sub, use_rope=False)
        x = x + B.mlp_apply(p["mlp"], _apply_norm(p["ln2"], x, cfg.norm_eps),
                            ctx)
    else:
        raise ValueError(kind)
    x = ctx.con(x, ("batch", "res_seq", "act_embed"))
    return x, aux, ctx.new_cache


def _apply_dec_block(p: Params, x, enc_out, ctx: Ctx, cache=None):
    """An encdec decoder layer: causal self-attention, cross-attention
    (from `enc_out` at prefill, from the cached `ck` / `cv` at decode),
    MLP. Returns (x, new_cache): at prefill the self-attention's k, v and
    the cross-attention's as ck, cv; at decode the layer's cache, updated
    in place."""
    cfg = ctx.cfg
    new_cache = {}
    c1 = dataclasses.replace(ctx, cache=cache, new_cache=None)
    x = x + B.attention_apply(p["self"], _apply_norm(p["ln1"], x,
                                                     cfg.norm_eps),
                              c1, use_rope=False)
    if c1.new_cache:
        new_cache.update(c1.new_cache)
    if ctx.mode == "decode":
        c2 = dataclasses.replace(ctx, cache=cache, new_cache=None)
        x = x + B.attention_apply(p["cross"], _apply_norm(p["ln2"], x,
                                                          cfg.norm_eps),
                                  c2, is_cross=True, use_rope=False)
    else:
        c2 = dataclasses.replace(ctx, cache=cache, new_cache=None,
                                 causal=False)
        x = x + B.attention_apply(p["cross"], _apply_norm(p["ln2"], x,
                                                          cfg.norm_eps),
                                  c2, kv_x=enc_out, is_cross=True,
                                  use_rope=False)
        if ctx.mode == "prefill" and c2.new_cache:
            new_cache["ck"] = c2.new_cache["k"]
            new_cache["cv"] = c2.new_cache["v"]
    x = x + B.mlp_apply(p["mlp"], _apply_norm(p["ln3"], x, cfg.norm_eps),
                        ctx)
    x = ctx.con(x, ("batch", "res_seq", "act_embed"))
    return x, new_cache


def _layer(tree, i: int):
    """Layer i of a stacked tree, as views; of a list, its i-th tree."""
    if isinstance(tree, list):
        return tree[i]
    return tree_map(lambda a: a[i], tree, is_leaf=torch.is_tensor)


def _restack(new: list):
    """Per-layer prefill caches, stacked on a leading layer axis; None
    where the layers keep none (the ssm's `skip_core` lowering, as in the
    reference)."""
    if any(c is None for c in new):
        return None
    return {k: torch.stack([c[k] for c in new]) for k in new[0]}


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products without batch dimensions (2-D `mm` and `addmm`,
    and `bmm` over a batch of one: the weight projections); recompute
    the rest (attention's batched products, the elementwise ops)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


DOTS_POLICY = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)


def _remat(fn, remat: str):
    """`fn` recomputed in backward under `remat` ("none" returns it)."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    kw = {"context_fn": DOTS_POLICY} if remat == "dots" else {}
    return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


def _training(ctx: Ctx, caches) -> bool:
    """Whether remat applies: a train-mode forward under autograd."""
    return ctx.mode == "train" and caches is None and torch.is_grad_enabled()


def _run_stack(params_layers, kinds, x, ctx: Ctx, caches=None):
    """Apply the layer stack in order (the reference's `lax.scan` over a
    stacked axis, or its loop over a list). Returns (x, aux summed over the
    layers, new caches): in prefill, stacked or listed like the
    parameters; in decode, `caches`, updated in place; else None.

    In training the layers run under `cfg.remat`, in groups where
    `cfg.scan_group` asks for them (`_group_spans`)."""
    if _training(ctx, caches):
        return _run_train_stack(params_layers, kinds, x, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new = []
    for i, kind in enumerate(kinds):
        cache = None if caches is None else _layer(caches, i)
        x, a, nc = _apply_block(kind, _layer(params_layers, i), x, ctx,
                                cache)
        aux = aux + a
        new.append(nc)
    if ctx.mode == "decode":
        return x, aux, caches
    if ctx.mode != "prefill":
        return x, aux, None
    return x, aux, (new if isinstance(params_layers, list)
                    else _restack(new))


def _pattern_period(kinds) -> int:
    """Smallest repeating period of the layer-kind pattern (0 if none)."""
    for p in range(1, len(kinds) // 2 + 1):
        if all(kinds[i] == kinds[i % p] for i in range(len(kinds))):
            return p
    return 0


def _group_spans(cfg: ArchConfig, kinds):
    """(layers in a group, the group's remat, each layer's remat inside
    it), or None for a flat stack. A stacked uniform stack groups
    `scan_group` layers when they split it into more than one group: each
    group recomputed whatever `cfg.remat` is, each layer inside under it
    (the reference's checkpointed outer scan over its inner scan of
    remat'd blocks). A non-uniform stack of at least 6 layers with
    `scan_group` set groups its repeating pattern: each group recomputed
    unless `cfg.remat` is "none", the layers inside not (the reference's
    `_run_grouped_pattern`)."""
    g, nL = cfg.scan_group, len(kinds)
    if _uniform(kinds):
        if cfg.scan_layers and g > 1 and nL % g == 0 and nL // g > 1:
            return g, "full", cfg.remat
        return None
    if g and nL >= 6:
        pat = _pattern_period(kinds)
        if pat and nL // pat > 1:
            return pat, "none" if cfg.remat == "none" else "full", "none"
    return None


def _run_train_stack(params_layers, kinds, x, ctx: Ctx):
    """The training forward of the stack, with remat and groups: returns
    (x, aux summed over the layers in order, None)."""
    cfg = ctx.cfg

    def run(layers, remat, x, aux):
        for i in layers:
            def f(p, x, kind=kinds[i]):
                return _apply_block(kind, p, x, ctx)[:2]
            x, a = _remat(f, remat)(_layer(params_layers, i), x)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    spans = _group_spans(cfg, kinds)
    if spans is None:
        return (*run(range(len(kinds)), cfg.remat, x, aux), None)
    size, group_remat, inside = spans
    n_groups = len(kinds) // size
    for gi in range(n_groups):
        group = functools.partial(run, range(gi * size, (gi + 1) * size),
                                  inside)
        x, aux = _remat(group, group_remat)(x, aux)
    # the pattern's tail, layer by layer (a uniform stack has none)
    x, aux = run(range(n_groups * size, len(kinds)), group_remat, x, aux)
    return x, aux, None


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _replicated(t):
    """A DTensor gathered whole on every rank (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def sharded_context(rules, mesh):
    """The context a forward under `mesh` runs in: plain tensors made
    inside count as replicated DTensors. Autograd carries the setting
    into the backward's threads. `implicit_replication` turns it off on
    exit whatever it was before, so a nested call enters nothing."""
    if rules and is_device_mesh(mesh):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        if not DTensor._op_dispatcher._allow_implicit_replication:
            return implicit_replication()
    return contextlib.nullcontext()


def _traced(t) -> bool:
    """Whether `t` is a trace's fake tensor, or a DTensor of one: a dry
    run's input, whose values cannot be read (their checks are skipped)."""
    from repro_torch.kernels.library import is_fake
    local = t.to_local() if is_dtensor(t) else t
    return is_fake(local)


def _embed(params, cfg: ArchConfig, tokens):
    tab = _replicated(params["tok_embed"])
    bad = (tokens < 0) | (tokens >= tab.shape[0])
    if not _traced(tokens) and bool(bad.any()):
        raise ValueError(f"token ids must lie in [0, {tab.shape[0]}); "
                         f"jnp.take would clamp or fill them, torch would "
                         f"read out of bounds")
    # `F.embedding`: the rows `index_select` gathers, and a backward that
    # sums repeated tokens' rows in a fixed order on CUDA (index_select's
    # adds them atomically, so a train step would not repeat bitwise)
    x = F.embedding(tokens.long(), tab)
    return x.to(torch_dtype(cfg.compute_dtype))


def _lm_logits(params, cfg: ArchConfig, layout: HeadLayout, x):
    if cfg.tie_embeddings:
        w = params["tok_embed"].to(x.dtype)
        logits = B._einsum("bse,ve->bsv", x, w)
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
    pos = torch.arange(S, device=device)[None].expand(Bsz, S)
    if cfg.pos == "mrope":
        pos = pos[..., None].expand(Bsz, S, 3)
    return pos


def forward(params, batch, cfg: ArchConfig, layout: HeadLayout, *,
            rules: Optional[Rules] = None, mesh=None, mode: str = "train"):
    """Full-sequence forward (train, forward only, or prefill).

    batch: {"inputs": (B, S) int}, or {"embeds": (B, S, E)} for the vlm
    family, with optional "positions" ((B, S, 3) under M-RoPE); encdec
    takes {"enc_embeds": (B, Se, E), "dec_inputs": (B, Td) int}. Returns
    (logits (B, S, Vp) f32, aux (the MoE losses summed over the layers),
    caches). The prefill caches are stacked on the layer axis where the
    parameters are ((L, B, S, Ks, D) for attention, (L, B, K-1, Di) and
    (L, B, Di, N) for mamba), else a list of per-layer dicts (rec: conv
    (B, K-1, Dr), state (B, Dr)); encdec's hold k, v padded to
    max_dec_len and the encoder's ck, cv."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward runs mode 'train' or 'prefill', got "
                         f"{mode!r}; decode is `decode_step`")
    with sharded_context(rules, mesh):
        if cfg.family == "encdec":
            return _forward_encdec(params, batch, cfg, layout, rules=rules,
                                   mesh=mesh, mode=mode)
        return _forward(params, batch, cfg, layout, rules, mesh, mode)


def _forward(params, batch, cfg: ArchConfig, layout: HeadLayout, rules,
             mesh, mode: str):
    if cfg.embeds_input:
        x = batch["embeds"].to(torch_dtype(cfg.compute_dtype))
    else:
        x = _embed(params, cfg, batch["inputs"])
    Bsz, S = x.shape[0], x.shape[1]
    positions = _default_positions(cfg, batch, Bsz, S, x.device)
    ctx = Ctx(cfg=cfg, layout=layout, rules=rules, mesh=mesh,
              positions=positions, mode=mode)
    x = ctx.con(x, ("batch", "res_seq", "act_embed"))
    x, aux, caches = _run_stack(params["layers"], layer_kinds(cfg), x, ctx)
    x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
    return _lm_logits(params, cfg, layout, x), aux, caches


def _forward_encdec(params, batch, cfg: ArchConfig, layout: HeadLayout, *,
                    rules, mesh, mode: str):
    dtc = torch_dtype(cfg.compute_dtype)
    enc_x = batch["enc_embeds"].to(dtc)
    Bsz, Se = enc_x.shape[0], enc_x.shape[1]
    table = torch.as_tensor(L.sincos_positions(Se, cfg.d_model),
                            device=enc_x.device)
    enc_x = enc_x + table.to(dtc)
    ctx = Ctx(cfg=cfg, layout=layout, rules=rules, mesh=mesh, mode="train")
    enc_x = ctx.con(enc_x, ("batch", "res_seq", "act_embed"))
    e = cfg.encdec
    x = enc_x
    for i in range(e.enc_layers):
        x, _, _ = _apply_block("enc", _layer(params["enc_layers"], i), x,
                               ctx)
    enc_out = _apply_norm(params["enc_norm"], x, cfg.norm_eps)

    dec_tokens = batch["dec_inputs"]
    Td = dec_tokens.shape[1]
    if Td > e.max_dec_len:
        raise ValueError(f"a decoder prompt of {Td} tokens exceeds "
                         f"max_dec_len {e.max_dec_len}, the length of the "
                         f"learned positions and the self-attention cache")
    x = _embed(params, cfg, dec_tokens)
    x = x + params["dec_pos"][:Td].to(dtc)[None]
    dpos = torch.arange(Td, device=x.device)[None].expand(Bsz, Td)
    dctx = Ctx(cfg=cfg, layout=layout, rules=rules, mesh=mesh,
               positions=dpos, mode=mode)
    x = dctx.con(x, ("batch", "res_seq", "act_embed"))
    new = []
    for i in range(e.dec_layers):
        x, nc = _apply_dec_block(_layer(params["dec_layers"], i), x,
                                 enc_out, dctx)
        new.append(nc)
    x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, cfg, layout, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode != "prefill":
        return logits, aux, None
    caches = _restack(new)
    # pad the self-attention cache out to max_dec_len
    for name in ("k", "v"):
        k = caches[name]
        caches[name] = torch.cat([k, k.new_zeros(
            k.shape[:2] + (e.max_dec_len - Td,) + k.shape[3:])], dim=2)
    return logits, aux, caches


def _check_positions(caches, pos, cfg: ArchConfig) -> None:
    """Refuse a decode position a cache would clamp or misplace: outside
    [0, length) of a linear cache, or of a hybrid ring shorter than the
    window (it wraps only where the window hides what it overwrites);
    below 0 for a ring of the window (written at pos % length). A
    recurrent state reads no position."""
    if _traced(pos):
        return
    layers = caches if isinstance(caches, list) else [caches]
    for c in layers:
        if "k" not in c:
            continue
        Lc = c["k"].shape[-3]
        ring = cfg.family == "hybrid" and Lc >= cfg.hybrid.window
        hi = None if ring else Lc
        if bool((pos < 0).any()) or (hi is not None
                                     and bool((pos >= hi).any())):
            raise ValueError(f"decode positions must lie in [0, "
                             f"{hi if hi is not None else 'inf'}), the "
                             f"cache length; got {pos.tolist()}")


def decode_step(params, caches, batch, cfg: ArchConfig, layout: HeadLayout,
                *, rules: Optional[Rules] = None, mesh=None):
    """One-token decode. batch: {"token": (B,), "pos": (B,)}, with
    "embeds" (B, 1, E) for the vlm family (whose M-RoPE position is `pos`
    on all three axes, as in the reference).

    Returns (logits (B, Vp), caches): the caches are updated in place (the
    reference returns new ones). A position outside a linear cache, or
    negative, raises before anything is written; a mamba or rec step reads
    no position."""
    with sharded_context(rules, mesh):
        return _decode_step(params, caches, batch, cfg, layout, rules, mesh)


def _decode_step(params, caches, batch, cfg: ArchConfig, layout: HeadLayout,
                 rules, mesh):
    tok, pos = batch["token"], batch["pos"]
    _check_positions(caches, pos, cfg)
    pos = pos.long()
    ctx = Ctx(cfg=cfg, layout=layout, rules=rules, mesh=mesh, mode="decode",
              pos=pos)
    if cfg.family == "encdec":
        x = _embed(params, cfg, tok[:, None])
        x = x + torch.index_select(params["dec_pos"], 0, pos)[:, None].to(
            x.dtype)
        for i in range(cfg.encdec.dec_layers):
            x, _ = _apply_dec_block(_layer(params["dec_layers"], i), x,
                                    None, ctx, _layer(caches, i))
    else:
        x = _embed(params, cfg, tok[:, None]) if not cfg.embeds_input else \
            batch["embeds"].to(torch_dtype(cfg.compute_dtype))
        x, _, caches = _run_stack(params["layers"], layer_kinds(cfg), x, ctx,
                                  caches)
    x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
    return _lm_logits(params, cfg, layout, x)[:, 0], caches


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _take_target(logits, tgt):
    """logits[..., tgt]: each position's target logit. On DTensors (logits
    split over the batch, the vocab whole; targets split alike) each rank
    gathers from its own rows (`local_map`): DTensor's own `gather` rule
    replicates both operands, which gathers every rank's logits to every
    rank (the whole global batch's, 637 GB a rank for `qwen3-32b` at
    train_4k on 16 x 16)."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, tgt[..., None])[..., 0]
    from torch.distributed.tensor.experimental import local_map
    tgt = tgt.redistribute(logits.device_mesh, logits.placements)
    fn = local_map(lambda lg, t: torch.gather(lg, -1, t[..., None])[..., 0],
                   out_placements=list(tgt.placements),
                   in_placements=(list(logits.placements),
                                  list(tgt.placements)),
                   device_mesh=logits.device_mesh)
    return fn(logits, tgt)


def _all_reduce(x, op: str, groups):
    """x reduced by `op` over each (mesh, dim) of `groups` in turn."""
    from torch.distributed import _functional_collectives as funcol
    for group in groups:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, group))
    return x


class _VocabLogZ(torch.autograd.Function):
    """The log-partition of logits split over the vocab: each rank's max,
    reduced by max (it only keeps the sums stable, so it takes no
    gradient), then the log of the sum over the ranks of each one's sum of
    exp, as `torch.logsumexp` computes it on one rank (a max of +-inf taken
    as 0). Its gradient is logsumexp's, ``g * exp(logits - logz)``, on each
    rank's own columns."""

    @staticmethod
    def forward(ctx, lg, groups):
        m = _all_reduce(lg.amax(-1), "max", groups)
        m = m.masked_fill(m.abs() == math.inf, 0.0)
        s = _all_reduce(torch.exp(lg - m[..., None]).sum(-1), "sum", groups)
        logz = torch.log(s) + m
        ctx.save_for_backward(lg, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        lg, logz = ctx.saved_tensors
        return g[..., None] * torch.exp(lg - logz[..., None]), None


class _VocabTarget(torch.autograd.Function):
    """Each position's target logit from logits split over the vocab: the
    rank whose columns [v0, v0 + V/tp) hold the target gathers it, every
    other rank gives 0, and a sum over the ranks leaves the one logit
    (exactly: the other terms are zeros). Its gradient goes to that rank's
    column."""

    @staticmethod
    def forward(ctx, lg, tgt, v0: int, groups):
        lt = tgt - v0
        own = (lt >= 0) & (lt < lg.shape[-1])
        idx = torch.clamp(lt, 0, lg.shape[-1] - 1)
        ll = torch.gather(lg, -1, idx[..., None])[..., 0]
        ll = _all_reduce(torch.where(own, ll, 0.0), "sum", groups)
        ctx.save_for_backward(idx, own)
        ctx.shape = lg.shape
        return ll

    @staticmethod
    def backward(ctx, g):
        idx, own = ctx.saved_tensors
        grad = g.new_zeros(ctx.shape)
        grad.scatter_(-1, idx[..., None], torch.where(own, g, 0.0)[..., None])
        return grad, None, None, None


def _vocab_dims(logits) -> Tuple[int, ...]:
    """The mesh dims of more than one rank that split DTensor logits' last
    (vocab) axis, in mesh order."""
    if not is_dtensor(logits):
        return ()
    mesh, d = logits.device_mesh, logits.ndim - 1
    return tuple(i for i, p in enumerate(logits.placements)
                 if p.is_shard(d) and mesh.size(i) > 1)


def _vocab_parallel(logits, tgt, dims):
    """(logz, target logit) of logits split over the vocab on mesh `dims`,
    each rank reading only its own V/tp columns (`local_map`); both come
    back split as the batch is and replicated over `dims`."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, d = logits.device_mesh, logits.ndim - 1
    v0 = vocab_offset(logits.shape[-1], mesh, dims)
    out = [Replicate() if p.is_shard(d) else p for p in logits.placements]
    tgt = tgt.redistribute(mesh, out)
    groups = [(mesh, i) for i in dims]

    def terms(lg, t):
        return _VocabLogZ.apply(lg, groups), \
            _VocabTarget.apply(lg, t, v0, groups)
    fn = local_map(terms, out_placements=(out, out),
                   in_placements=(list(logits.placements), out),
                   device_mesh=mesh)
    return fn(logits, tgt)


def lm_loss(logits, targets, *, z_loss: float = 1e-4):
    """Masked softmax cross-entropy in f32, plus `z_loss` times the mean
    squared log-partition. targets < 0 are masked. On DTensor logits split
    over the vocab by more than one rank, vocab-parallel: no rank holds a
    logits-shaped tensor wider than its own columns (`_vocab_parallel`);
    split by one rank (or whole), each rank computes on its own rows."""
    logits = logits.float()
    mask = (targets >= 0).float()
    tgt = torch.clamp_min(targets, 0).long()
    dims = _vocab_dims(logits)
    if dims:
        logz, ll = _vocab_parallel(logits, tgt, dims)
    else:
        if is_dtensor(logits):
            from torch.distributed.tensor import Replicate
            d = logits.ndim - 1
            logits = logits.redistribute(
                logits.device_mesh, [Replicate() if p.is_shard(d) else p
                                     for p in logits.placements])
        logz = torch.logsumexp(logits, dim=-1)
        ll = _take_target(logits, tgt)
    nll = (logz - ll) * mask
    z = torch.square(logz) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    return nll.sum() / denom + z_loss * z.sum() / denom


def loss_fn(params, batch, cfg: ArchConfig, layout: HeadLayout, *,
            rules: Optional[Rules] = None, mesh=None):
    """Training loss: `lm_loss` of the train-mode logits against
    batch["targets"], plus the MoE aux losses. Returns (loss, {"loss",
    "aux"})."""
    logits, aux, _ = forward(params, batch, cfg, layout, rules=rules,
                             mesh=mesh, mode="train")
    with sharded_context(rules, mesh):
        if rules:
            # the sequence gathered, the vocab left split over "model":
            # `lm_loss` is vocab-parallel (DTensor plans the one-step move
            # from the sequence-parallel placement as an all-gather of the
            # whole global batch to every rank)
            ctx = Ctx(cfg=cfg, layout=layout, rules=rules, mesh=mesh)
            logits = ctx.con(logits, ("batch", None, "act_vocab"))
        loss = lm_loss(logits, batch["targets"]) + aux
    return loss, {"loss": loss, "aux": aux}
