"""Per-family layer blocks: param specs + apply fns.

The port of `repro.models.blocks`: the attention block (self-attention,
windowed self-attention with its ring-buffer decode, and cross-attention,
in the `train` (forward only), `prefill` and `decode` modes, with the
`dense`, `chunked`, `local` and `pallas` implementations), the dense MLP
(`swiglu`, `sq_relu`, `gelu`), the MoE block (`moe_apply`, capacity
routing with one-hot dispatch and combine), the Mamba-1 block
(`mamba_apply`) and the RG-LRU block (`rglru_apply`). Weights stay in the
param dtype and are cast to the compute dtype at each use, as the
reference casts them (`.astype(x.dtype)`).

`attention_impl="pallas"` runs the flash-attention kernel K8
(`kernels.attention.ops.gqa_layout_attention`) in causal self-attention
without a window, and the selective-scan kernel K9
(`kernels.ssm.ops.mamba_scan`) in mamba blocks, at train and prefill: on
CUDA tensors the hand-written kernels, on CPU tensors their plain
versions. Both routes are forward-only, as the reference's: they raise
under grad. `flash` (causal self-attention through `layers.attn_flash`,
whose backward recomputes the probabilities) and `chunked` train. As in
the reference, a window takes precedence over `pallas` and `flash` (the
hybrid family's attention runs `attn_local`), non-causal and cross
attention run `attn_dense`, and the RG-LRU recurrence has no kernel.
`skip_core` is the reference's phase-attribution lowering, which the dry
run's cost pair uses: it keeps every projection and drops the S^2
attention core, the MoE one-hot dispatch and combine, the mamba scan and
the RG-LRU recurrence, with `0.0 * x` terms that keep the dropped inputs
live in the trace.

Under a `DeviceMesh` with rules (`Ctx.rules`, `Ctx.mesh`), parameters and
activations are DTensors and `Ctx.con` redistributes an activation to
the placements of its logical axes at the reference's constraint sites.
`pallas` then runs K8 on each rank's own kv groups (`gqa_layout_attention`
under `local_map`). Without rules `con` returns its input: the
single-device path is unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import (HeadLayout, Rules, constrain,
                                              is_dtensor, per_group)
from repro_torch.kernels.attention.ops import gqa_layout_attention
from repro_torch.kernels.ssm.ops import mamba_scan
from repro_torch.models import layers as L
from repro_torch.pspec import ParamSpec

Params = Dict[str, Any]

IMPLS = ("dense", "chunked", "local", "pallas", "flash", "skip_core")


@dataclass
class Ctx:
    """Per-call context: positions, mode, sharding rules and mesh, cache
    slot."""
    cfg: ArchConfig
    layout: HeadLayout
    rules: Optional[Rules] = None
    mesh: Any = None
    positions: Any = None        # (B, S) or (B, S, 3) for mrope
    mode: str = "train"          # train | prefill | decode
    cache: Any = None            # layer cache dict at decode
    pos: Any = None              # (B,) decode position
    causal: bool = True
    new_cache: Any = None        # out: updated layer cache

    def con(self, x, axes):
        return constrain(x, axes, self.rules, self.mesh) if self.rules else x


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def attention_specs(cfg: ArchConfig, layout: HeadLayout, dt: str) -> Params:
    E, D = cfg.d_model, cfg.head_dim
    Hs, Ks = layout.n_q_stored, layout.n_kv_stored
    p: Params = {
        "wq": ParamSpec((E, Hs, D), ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((E, Ks, D), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamSpec((E, Ks, D), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamSpec((Hs, D, E), ("heads", "head_dim", "embed"), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((Hs, D), ("heads", "head_dim"), dt, "zeros")
        p["bk"] = ParamSpec((Ks, D), ("kv_heads", "head_dim"), dt, "zeros")
        p["bv"] = ParamSpec((Ks, D), ("kv_heads", "head_dim"), dt, "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((D,), (None,), dt, "ones")
        p["k_norm"] = ParamSpec((D,), (None,), dt, "ones")
    return p


def _q_head_mask(layout: HeadLayout, dtype, device):
    if layout.n_q_stored == layout.n_q:
        return None
    return torch.as_tensor(layout.q_head_mask(), dtype=dtype,
                           device=device).reshape(layout.n_kv_stored,
                                                  layout.q_per_group)


def _einsum(eq: str, a, w):
    """torch.einsum(eq, a, w) of an activation and a weight. On DTensors
    rank by rank (`local_map`): DTensor's view rules refuse some of the
    einsum's internal reshapes of a sharded dim (the output projection at
    a batch of 1 on torch 2.11). On each mesh dimension, where `a` is
    sharded the weight follows it (sharded on the same letter where it
    has it, else whole); where only the weight is sharded it stays so if
    that letter reaches the output (column-parallel), else it is gathered
    (FSDP). The output is sharded on the shared letter, or a partial sum
    where that letter is contracted (row-parallel). In backward an
    operand's gradient is a partial sum over the ranks where the other
    operand alone was sharded (the weight's over the batch's shards, the
    activation's over a column-parallel weight's)."""
    if not is_dtensor(a):
        return torch.einsum(eq, a, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ins, out = eq.split("->")
    la, lw = ins.split(",")
    apl, wpl, opl, agrad, wgrad = [], [], [], [], []
    for pa, pw in zip(a.placements, w.placements):
        ka = la[pa.dim] if isinstance(pa, Shard) else None
        kw = lw[pw.dim] if isinstance(pw, Shard) else None
        if ka is not None:
            kw = ka if ka in lw else None
        elif kw is not None and kw not in out:
            kw = None
        k = ka or kw
        apl.append(Shard(la.index(ka)) if ka else Replicate())
        wpl.append(Shard(lw.index(kw)) if kw else Replicate())
        opl.append(Shard(out.index(k)) if k and k in out else
                   Partial() if k else Replicate())
        agrad.append(Partial() if kw and not ka else apl[-1])
        wgrad.append(Partial() if ka and not kw else wpl[-1])
    fn = local_map(lambda x, y: torch.einsum(eq, x, y), out_placements=opl,
                   in_placements=(apl, wpl),
                   in_grad_placements=(agrad, wgrad),
                   device_mesh=a.device_mesh, redistribute_inputs=True)
    return fn(a, w)


def _project(x, w, b=None):
    """x (B,S,E) @ w (E,H,D) in x's dtype, plus the bias."""
    out = _einsum("bse,ehd->bshd", x, w.to(x.dtype))
    return out if b is None else out + b.to(x.dtype)


def _write_cache(cache, new, pos):
    """cache[b, pos[b]] = new[b, 0], in place. The reference's
    `dynamic_update_slice` clamps an out-of-range position; here the caller
    (`model.decode_step`) has refused one, so none reaches this write. A
    DTensor cache (batch and heads split over the mesh) is written rank by
    rank on its own block (`local_map`): DTensor has no in-place rule for
    an indexed write into a sharded tensor."""
    if is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh, pl = cache.device_mesh, list(cache.placements)
        new = new.redistribute(mesh, pl)
        pos_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in pl]
        pos = pos.redistribute(mesh, pos_pl)
        local_map(_write_cache, out_placements=pl,
                  in_placements=(pl, pl, pos_pl), device_mesh=mesh)(
            cache, new, pos)
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos] = new[:, 0].to(cache.dtype)
    return cache


def attention_apply(p: Params, x, ctx: Ctx, *, kv_x=None, window: int = 0,
                    use_rope: Optional[bool] = None,
                    is_cross: bool = False):
    """x: (B, S, E). kv_x: cross-attention source (B, Skv, E) if given. At
    decode, self-attention runs against the layer's cache, which it updates
    in place (the reference returns a new one): a linear buffer written at
    `pos`, or with `window` a ring written at `pos % Lc`; cross-attention
    reads the encoder's projected `ck` / `cv`, every position valid."""
    cfg, lo = ctx.cfg, ctx.layout
    B, S, E = x.shape
    D = cfg.head_dim
    impl = cfg.attention_impl
    if impl not in IMPLS:
        raise ValueError(f"unknown attention_impl {impl!r}")
    kv_src = x if kv_x is None else kv_x
    Skv = kv_src.shape[1]

    q = _project(x, p["wq"], p.get("bq"))
    q = q.reshape(B, S, lo.n_kv_stored, lo.q_per_group, D)
    q = ctx.con(q, ("batch", "seq", "act_kv_heads", None, None))
    use_rope = cfg.pos in ("rope", "mrope") if use_rope is None else use_rope
    mrope = cfg.pos == "mrope"
    scale = 1.0 / math.sqrt(D)

    if ctx.mode == "decode" and not is_cross:
        k = _project(x, p["wk"], p.get("bk"))
        v = _project(x, p["wv"], p.get("bv"))
        if cfg.qk_norm:
            q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
        if use_rope:
            pos_q = ctx.pos[:, None]  # (B,1)
            if mrope:
                pos_q = pos_q[..., None].expand(B, 1, 3)
            q = L.apply_rope(q, pos_q, cfg.rope_theta, mrope)
            k = L.apply_rope(k, pos_q, cfg.rope_theta, mrope)
        Lc = ctx.cache["k"].shape[1]
        slot = ctx.pos % Lc if window else ctx.pos
        kc = _write_cache(ctx.cache["k"], k, slot)
        vc = _write_cache(ctx.cache["v"], v, slot)
        ctx.new_cache = {"k": kc, "v": vc}
        if window:
            # ring buffer: the valid entries are pos-window+1..pos, at
            # slots (idx % Lc)
            idx = torch.arange(Lc, device=x.device)
            age = (slot[:, None] - idx[None, :]) % Lc
            mask = age < torch.clamp(ctx.pos + 1, max=window)[:, None]
            logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(),
                                  kc.float()) * scale
            logits = L._masked(logits, mask[:, None, None, None, :])
            pr = torch.softmax(logits, dim=-1)
            out = torch.einsum("bkgqs,bskd->bqkgd", pr,
                               vc.float()).to(x.dtype)
        else:
            out = L.attn_decode(q, kc, vc, pos=ctx.pos, scale=scale)
    elif ctx.mode == "decode":
        # cross-attention at decode: the cached projected encoder K/V, all
        # positions valid
        kc, vc = ctx.cache["ck"], ctx.cache["cv"]
        if cfg.qk_norm:
            q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        pos_full = torch.full((B,), kc.shape[1] - 1, device=x.device)
        out = L.attn_decode(q, kc, vc, pos=pos_full, scale=scale)
    else:
        k = _project(kv_src, p["wk"], p.get("bk"))
        v = _project(kv_src, p["wv"], p.get("bv"))
        if cfg.qk_norm:
            q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
        k = ctx.con(k, ("batch", "seq", "act_kv_heads", None))
        if use_rope and kv_x is None:
            q = L.apply_rope(q, ctx.positions, cfg.rope_theta, mrope)
            k = L.apply_rope(k, ctx.positions, cfg.rope_theta, mrope)
        q_pos = torch.arange(S, device=x.device)
        kv_pos = torch.arange(Skv, device=x.device)
        if ctx.mode == "prefill":
            ctx.new_cache = {"k": k, "v": v}
        if impl == "skip_core":
            # phase-attribution lowering: keep projections, drop the S^2 core
            vv = v if Skv == S else v[:, :S]
            out = vv[:, :, :, None, :].expand(
                B, S, lo.n_kv_stored, lo.q_per_group, D).to(q.dtype)
            out = out + 0.0 * q
        elif window:
            out = L.attn_local(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               scale=scale, window=window)
        else:
            # each rank attends its own batch rows and kv groups: the whole
            # sequence local, the groups split over "model"
            q = ctx.con(q, ("batch", None, "act_kv_heads", None, None))
            k = ctx.con(k, ("batch", None, "act_kv_heads", None))
            v = ctx.con(v, ("batch", None, "act_kv_heads", None))
            if impl == "dense" or not ctx.causal:
                out = per_group(lambda q, k, v: L.attn_dense(
                    q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                    causal=ctx.causal and kv_x is None, scale=scale),
                    q, k, v)
            elif impl == "flash":
                out = per_group(lambda q, k, v: L.attn_flash(
                    q, k, v, q_pos, kv_pos, True, scale, cfg.attn_chunk),
                    q, k, v)
            elif impl == "pallas":
                # the flash kernel K8 (its plain version on CPU tensors);
                # forward only, as in the reference
                out = gqa_layout_attention(q, k, v, causal=True)
            else:
                out = per_group(lambda q, k, v: L.attn_chunked(
                    q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                    scale=scale, chunk=cfg.attn_chunk), q, k, v)

    mask = _q_head_mask(lo, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, :, None]
    out = out.reshape(B, out.shape[1], lo.n_q_stored, D)
    return _einsum("bshd,hde->bse", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ArchConfig, dt: str, d_ff: Optional[int] = None,
              bias: bool = False) -> Params:
    E, F_ = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": ParamSpec((E, F_), ("embed", "ffn"), dt),
         "wo": ParamSpec((F_, E), ("ffn", "embed"), dt)}
    if cfg.mlp == "swiglu":
        p["wg"] = ParamSpec((E, F_), ("embed", "ffn"), dt)
    if bias:
        p["bi"] = ParamSpec((F_,), (None,), dt, "zeros")
        p["bo"] = ParamSpec((E,), (None,), dt, "zeros")
    return p


def mlp_apply(p: Params, x, ctx: Ctx):
    cfg = ctx.cfg
    cast = lambda w: w.to(x.dtype)  # noqa: E731
    if cfg.mlp == "swiglu":
        h = F.silu(x @ cast(p["wg"])) * (x @ cast(p["wi"]))
    elif cfg.mlp == "sq_relu":
        h = torch.square(F.relu(x @ cast(p["wi"])))
    else:  # gelu; jax.nn.gelu defaults to the tanh approximation
        h = x @ cast(p["wi"])
        if "bi" in p:
            h = h + cast(p["bi"])
        h = F.gelu(h, approximate="tanh")
    h = ctx.con(h, ("batch", "seq", "act_ffn"))
    out = h @ cast(p["wo"])
    if "bo" in p:
        out = out + cast(p["bo"])
    return out


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style capacity routing)
# ---------------------------------------------------------------------------


def moe_specs(cfg: ArchConfig, dt: str) -> Params:
    E, m = cfg.d_model, cfg.moe
    X, Fe = m.n_experts, m.d_ff_expert
    # the reference's logical axes: EP-resident experts use a distinct one
    emb = "embed" if m.expert_fsdp else "expert_embed"
    p: Params = {
        "router": ParamSpec((E, X), ("embed", "expert"), dt, "normal"),
        "wi": ParamSpec((X, E, Fe), ("expert", emb, "expert_ffn"), dt),
        "wg": ParamSpec((X, E, Fe), ("expert", emb, "expert_ffn"), dt),
        "wo": ParamSpec((X, Fe, E), ("expert", "expert_ffn", emb), dt),
    }
    if m.shared_expert:
        p["shared"] = mlp_specs(cfg, dt, d_ff=Fe)
    if m.dense_residual:
        p["dense"] = mlp_specs(cfg, dt, d_ff=cfg.d_ff)
    return p


def _top_k(probs, k: int):
    """`jax.lax.top_k` along the last axis: the k largest, in descending
    order, the lower index first among equal values (a stable descending
    sort; `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_groups(cfg: ArchConfig, B: int, S: int) -> tuple:
    """(G, g_size, cap): the reference's token groups and the capacity of
    each expert's buffer in a group."""
    m = cfg.moe
    T = B * S
    g_size = min(m.group_size or min(S, 2048), T)
    while T % g_size:
        g_size -= 1
    cap = int(math.ceil(m.top_k * g_size / m.n_experts * m.capacity_factor))
    return T // g_size, g_size, max(cap, 4)


def moe_route(p: Params, xg, cfg: ArchConfig, cap: int):
    """The router of one token-group batch xg (G, s, E): (logits (G,s,X)
    f32, probs, gate_vals (G,s,k) with the dropped choices zeroed,
    gate_idx (G,s,k), pos_in_expert (G,s,k), keep (G,s,k)). The router
    product runs in the compute dtype, its softmax in f32, as in the
    reference; each (token, choice) takes the next place in its expert's
    buffer, in token order, and is dropped at `cap`."""
    m = cfg.moe
    X, k = m.n_experts, m.top_k
    G, s = xg.shape[0], xg.shape[1]
    logits = _einsum("gse,ex->gsx", xg, p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                     # (G,s,k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    experts = torch.arange(X, device=xg.device)
    onehot = (gate_idx[..., None] == experts).long()           # (G,s,k,X)
    flatoh = onehot.reshape(G, s * k, X)
    pos_in_expert = torch.cumsum(flatoh, dim=1) - flatoh       # (G,s*k,X)
    pos_in_expert = (pos_in_expert * flatoh).sum(-1).reshape(G, s, k)
    keep = pos_in_expert < cap
    return logits, probs, gate_vals * keep, gate_idx, pos_in_expert, keep


def moe_apply(p: Params, x, ctx: Ctx):
    """Returns (out, aux_loss). Token-group capacity routing.

    Dispatch and combine are one-hot einsums, the reference's: pure data
    movement, the tensors that become all-to-alls under expert
    parallelism. Each one-hot product has one nonzero term per output, so
    it is exact in any dtype. Expert weights are cast to the compute dtype
    at each use (a no-op for weights stored in it)."""
    cfg = ctx.cfg
    m = cfg.moe
    B, S, E = x.shape
    X = m.n_experts
    if cfg.attention_impl == "skip_core":
        return _moe_skip_core(p, x, ctx)
    G, g_size, cap = moe_groups(cfg, B, S)
    xg = x.reshape(G, g_size, E)
    logits, probs, gate_vals, gate_idx, pos_in_expert, keep = moe_route(
        p, xg, cfg, cap)

    # dispatch (G,s,X,cap) one-hot; combine carries the gate weights
    dt = x.dtype
    slots = torch.arange(cap, device=x.device)
    disp = ((gate_idx[..., None] == torch.arange(X, device=x.device)).to(dt)
            [..., None]
            * (pos_in_expert[..., None] == slots).to(dt)[..., None, :]
            * keep[..., None, None].to(dt))                    # (G,s,k,X,cap)
    comb = disp * gate_vals[..., None, None].to(dt)
    disp = disp.sum(2)                                         # (G,s,X,cap)
    comb = comb.sum(2)

    exp_in = _einsum("gsxc,gse->gxce", disp, xg)               # (G,X,cap,E)
    exp_in = ctx.con(exp_in, (None, "act_expert", None, None))
    h = (F.silu(_einsum("gxce,xef->gxcf", exp_in, p["wg"].to(dt)))
         * _einsum("gxce,xef->gxcf", exp_in, p["wi"].to(dt)))
    exp_out = _einsum("gxcf,xfe->gxce", h, p["wo"].to(dt))
    out = _einsum("gsxc,gxce->gse", comb, exp_out).reshape(B, S, E)

    # aux losses: load balance (Switch) + router z-loss
    density = torch.mean((gate_idx[..., 0, None] == torch.arange(
        X, device=x.device)).float(), dim=(0, 1))
    p_mean = torch.mean(probs, dim=(0, 1))
    lb = X * torch.sum(density * p_mean) * m.load_balance_loss
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1))) \
        * m.router_z_loss
    aux = lb + z

    if m.shared_expert:
        out = out + _moe_inner_mlp(p["shared"], x, ctx)
    if m.dense_residual:
        out = out + _moe_inner_mlp(p["dense"], x, ctx)
    return out, aux


def _moe_skip_core(p: Params, x, ctx: Ctx):
    """The phase-attribution lowering of `moe_apply`: the router's softmax
    and the expert products stay (FLOP parity), the one-hot dispatch and
    combine products go, so their differential is the dispatch's data
    movement. Each expert takes the group's first `cap` tokens; expert 0's
    output lands on them."""
    cfg = ctx.cfg
    m = cfg.moe
    B, S, E = x.shape
    X = m.n_experts
    G, g_size, cap = moe_groups(cfg, B, S)
    xg = x.reshape(G, g_size, E)
    dt = x.dtype
    logits = _einsum("gse,ex->gsx", xg, p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    tok = (xg[:, :cap] if cap <= g_size
           else F.pad(xg, (0, 0, 0, cap - g_size)))
    exp_in = tok[:, None].expand(G, X, cap, E).to(dt)
    exp_in = ctx.con(exp_in, (None, "act_expert", None, None))
    h = (F.silu(_einsum("gxce,xef->gxcf", exp_in, p["wg"].to(dt)))
         * _einsum("gxce,xef->gxcf", exp_in, p["wi"].to(dt)))
    exp_out = _einsum("gxcf,xfe->gxce", h, p["wo"].to(dt))
    n = min(cap, g_size)
    pad = exp_out[:, 0, :n]
    if n < g_size:
        pad = torch.cat([pad, torch.zeros_like(xg[:, n:])], dim=1)
    out = (pad + (0.0 * probs.sum(-1, keepdim=True)).to(pad.dtype)
           ).reshape(B, S, E)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if m.shared_expert:
        out = out + _moe_inner_mlp(p["shared"], x, ctx)
    if m.dense_residual:
        out = out + _moe_inner_mlp(p["dense"], x, ctx)
    return out, aux


def _moe_inner_mlp(p, x, ctx: Ctx):
    h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    h = ctx.con(h, ("batch", "seq", "act_ffn"))
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba)
# ---------------------------------------------------------------------------


def mamba_specs(cfg: ArchConfig, dt: str) -> Params:
    E, Di = cfg.d_model, cfg.d_inner
    N, K, R = cfg.ssm.d_state, cfg.ssm.conv_k, cfg.ssm.dt_rank
    return {
        "in_proj": ParamSpec((E, 2 * Di), ("embed", "ffn"), dt),
        "conv_w": ParamSpec((K, Di), ("conv", "ffn"), dt),
        "conv_b": ParamSpec((Di,), ("ffn",), dt, "zeros"),
        "x_proj": ParamSpec((Di, R + 2 * N), ("ffn", None), dt),
        "dt_proj": ParamSpec((R, Di), ("lowrank", "ffn"), dt),
        "dt_bias": ParamSpec((Di,), ("ffn",), dt, "zeros"),
        "A_log": ParamSpec((Di, N), ("ffn", "state"), dt, "ones"),
        "D": ParamSpec((Di,), ("ffn",), dt, "ones"),
        "out_proj": ParamSpec((Di, E), ("ffn", "embed"), dt),
    }


def _softplus(x):
    """`jax.nn.softplus`, i.e. logaddexp(x, 0). `F.softplus` returns x
    itself above its threshold of 20, which this does not."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv. x (B,S,C), w (K,C). Returns y, new_cache
    (B,K-1,C): the last K-1 rows of the padded input, zero padding
    included when S < K-1. The taps are summed in order from 0, as the
    reference's Python `sum` adds them."""
    K = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    new_cache = xp[:, -(K - 1):] if K > 1 else pad
    return y + b.to(x.dtype), new_cache


def scan_chunk_for(S: int, scan_chunk: int) -> int:
    """The chunk `_mamba_chunk_scan` runs a length-S sequence in:
    S // max(S // scan_chunk, 1). Raises ValueError where that does not
    divide S (the reference's `S % n` assertion; e.g. S = 513 at
    scan_chunk 256)."""
    n = max(S // scan_chunk, 1)
    if S % n:
        raise ValueError(f"a sequence of {S} tokens does not split into "
                         f"{n} equal chunks of about scan_chunk="
                         f"{scan_chunk}; the reference's chunked scan "
                         f"refuses it too")
    return S // n


def _associative_scan(a, b):
    """Prefix composition of h -> a*h + b along axis 1 (the reference's
    `lax.associative_scan(combine, (a, b), axis=1)`), in log2(length)
    rounds: returns (pa, pb) with h_t = pa_t * h_(-1) + pb_t. Each round
    is built out of place (`cat`): DTensor has no plan for the backward of
    a slice written into a sharded tensor."""
    step = 1
    while step < a.shape[1]:
        pa = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        pb = torch.cat([b[:, :step], a[:, step:] * b[:, :-step]
                        + b[:, step:]], dim=1)
        a, b, step = pa, pb, 2 * step
    return a, b


def _scan_dt(dt_r, p: Params):
    """dt = softplus(dt_r @ dt_proj + dt_bias), all in f32, as the
    reference's chunked scan computes it for prefill."""
    return _softplus(dt_r.float() @ p["dt_proj"].float()
                     + p["dt_bias"].float())


def _mamba_chunk_scan(xc, dt_r, Bmat, Cmat, p: Params, h0, *, chunk: int):
    """Selective scan over sequence chunks (the reference's jnp chunked
    scan): per chunk, dt in f32 (`_scan_dt`), the discretised (a, bu) of
    shape (B, chunk, Di, N), an associative scan and the C-projection. The
    chunks stream in the compute dtype and are promoted to f32 one at a
    time.

    Returns (y (B,S,Di) f32, h_final (B,Di,N) f32)."""
    S = xc.shape[1]
    chunk = scan_chunk_for(S, chunk)
    A = -torch.exp(p["A_log"].float())                     # (Di,N)
    h, ys = h0, []
    for j in range(S // chunk):
        cut = slice(j * chunk, (j + 1) * chunk)
        xj, bj, cj = (t[:, cut].float() for t in (xc, Bmat, Cmat))
        dt = _scan_dt(dt_r[:, cut], p)                     # (B,chunk,Di)
        a = torch.exp(dt[..., None] * A)                   # (B,chunk,Di,N)
        bu = (dt * xj)[..., None] * bj[..., None, :]
        pa, pb = _associative_scan(a, bu)
        h_all = pa * h[:, None] + pb                       # (B,chunk,Di,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, cj))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def _mamba_kernel_scan(xc, dt_r, Bmat, Cmat, p: Params, h0, *, chunk: int):
    """The same function through K9 (`attention_impl="pallas"`): dt in f32
    as `_mamba_chunk_scan` computes it, then `mamba_scan` with the chunk
    `_mamba_chunk_scan` would use. xc, Bmat and Cmat stay in the compute
    dtype; the kernel promotes them.

    Returns (y (B,S,Di) f32, h_final (B,Di,N) f32)."""
    chunk = scan_chunk_for(xc.shape[1], chunk)
    A = -torch.exp(p["A_log"].float())
    return mamba_scan(xc, _scan_dt(dt_r, p), Bmat, Cmat, A, h0, chunk=chunk)


def mamba_apply(p: Params, x, ctx: Ctx):
    """Mamba-1 selective SSM. Returns block output (B,S,E). At decode it
    updates the layer's `conv` and `state` caches in place (the reference
    returns new ones)."""
    cfg = ctx.cfg
    N, R = cfg.ssm.d_state, cfg.ssm.dt_rank
    Di = cfg.d_inner
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = torch.split(xz, Di, dim=-1)
    xin = ctx.con(xin, ("batch", "seq", "act_ffn"))

    conv_cache = ctx.cache.get("conv") if ctx.mode == "decode" else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_cache)
    xc = F.silu(xc)

    proj = xc @ p["x_proj"].to(x.dtype)
    dt_r, Bmat, Cmat = torch.split(proj, [R, N, N], dim=-1)

    if ctx.mode == "decode":
        # dt in the compute dtype, then f32 (the reference's decode step)
        dt = _softplus(dt_r @ p["dt_proj"].to(x.dtype)
                       + p["dt_bias"].to(x.dtype)).float()
        A = -torch.exp(p["A_log"].float())
        a = torch.exp(dt[..., None] * A)                       # (B,1,Di,N)
        bu = ((dt * xc.float())[..., None]
              * Bmat.float()[..., None, :])
        state = ctx.cache["state"]
        h = a[:, 0] * state.float() + bu[:, 0]
        ctx.cache["conv"].copy_(new_conv)
        state.copy_(h.to(state.dtype))
        ctx.new_cache = ctx.cache
        y = torch.einsum("bdn,bsn->bsd", h, Cmat.float()).to(x.dtype)
    elif cfg.attention_impl == "skip_core":
        # phase-attribution lowering: drop the scan core, keep projections
        y = (xc.to(x.dtype) + 0.0 * Bmat.sum(-1, keepdim=True)
             + 0.0 * Cmat.sum(-1, keepdim=True)
             + 0.0 * dt_r.sum(-1, keepdim=True))
    else:
        scan = _mamba_kernel_scan if cfg.attention_impl == "pallas" else \
            _mamba_chunk_scan
        h0 = torch.zeros((x.shape[0], Di, N), dtype=torch.float32,
                         device=x.device)
        y, h = scan(xc, dt_r, Bmat, Cmat, p, h0, chunk=cfg.scan_chunk)
        y = y.to(x.dtype)
        if ctx.mode == "prefill":
            ctx.new_cache = {"conv": new_conv, "state": h.to(x.dtype)}

    y = y + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma)
# ---------------------------------------------------------------------------

_RG_BLOCKS = 16  # block-diagonal gate heads


def rglru_specs(cfg: ArchConfig, dt: str) -> Params:
    E, Dr = cfg.d_model, cfg.hybrid.d_rnn
    K = cfg.hybrid.conv_k
    nb = _RG_BLOCKS
    bs = Dr // nb
    return {
        "in_proj": ParamSpec((E, 2 * Dr), ("embed", "ffn"), dt),
        "conv_w": ParamSpec((K, Dr), ("conv", "ffn"), dt),
        "conv_b": ParamSpec((Dr,), ("ffn",), dt, "zeros"),
        "gate_a": ParamSpec((nb, bs, bs), ("heads", None, None), dt),
        "gate_x": ParamSpec((nb, bs, bs), ("heads", None, None), dt),
        "gate_a_b": ParamSpec((Dr,), ("ffn",), dt, "zeros"),
        "gate_x_b": ParamSpec((Dr,), ("ffn",), dt, "zeros"),
        "Lambda": ParamSpec((Dr,), ("ffn",), dt, "recurrent"),
        "out_proj": ParamSpec((Dr, E), ("ffn", "embed"), dt),
    }


def _ssm_scan(a, b, h0, *, chunk: int):
    """h_t = a_t * h_{t-1} + b_t elementwise; a, b (B, S, ...); h0 (B, ...).

    Chunked: an associative scan within each chunk, the chunks in order
    (the reference's `lax.scan`). The chunk is `scan_chunk_for(S, chunk)`,
    which refuses what the reference's assertion refuses. Returns (h_all
    (B, S, ...), h_final)."""
    S = a.shape[1]
    chunk = scan_chunk_for(S, chunk)
    h, outs = h0, []
    for j in range(S // chunk):
        cut = slice(j * chunk, (j + 1) * chunk)
        pa, pb = _associative_scan(a[:, cut], b[:, cut])
        h_all = pa * h[:, None] + pb
        outs.append(h_all)
        h = h_all[:, -1]
    return torch.cat(outs, dim=1), h


def rglru_apply(p: Params, x, ctx: Ctx):
    """The RG-LRU block. Returns (B, S, E). The recurrence is plain PyTorch,
    as in the reference (no kernel). At decode it updates the layer's
    `conv` and `state` caches in place (the reference returns new ones)."""
    cfg = ctx.cfg
    Dr = cfg.hybrid.d_rnn
    nb = _RG_BLOCKS
    B, S, E = x.shape
    xg = x @ p["in_proj"].to(x.dtype)
    xin, gate = torch.split(xg, Dr, dim=-1)
    xin = ctx.con(xin, ("batch", "seq", "act_ffn"))

    conv_cache = ctx.cache.get("conv") if ctx.mode == "decode" else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_cache)

    xb = xc.reshape(B, S, nb, Dr // nb)
    r = torch.sigmoid(_einsum("bsnd,nde->bsne", xb,
                              p["gate_a"].to(x.dtype)).reshape(B, S, Dr)
                      + p["gate_a_b"].to(x.dtype))
    i = torch.sigmoid(_einsum("bsnd,nde->bsne", xb,
                              p["gate_x"].to(x.dtype)).reshape(B, S, Dr)
                      + p["gate_x_b"].to(x.dtype))

    c = 8.0
    log_a = -c * _softplus(p["Lambda"].float()) * r.float()
    a = torch.exp(log_a)
    gated_x = (i * xc).float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * gated_x

    if ctx.mode == "decode":
        state = ctx.cache["state"]
        h = a[:, 0] * state.float() + b[:, 0]
        hs = h[:, None]
        ctx.cache["conv"].copy_(new_conv)
        state.copy_(h.to(state.dtype))
        ctx.new_cache = ctx.cache
    elif cfg.attention_impl == "skip_core":
        hs = b  # phase-attribution lowering: drop the recurrence core
    else:
        h0 = torch.zeros((B, Dr), dtype=torch.float32, device=x.device)
        hs, h = _ssm_scan(a, b, h0, chunk=cfg.scan_chunk)
        if ctx.mode == "prefill":
            ctx.new_cache = {"conv": new_conv, "state": h.to(x.dtype)}

    y = hs.to(x.dtype) * F.gelu(gate, approximate="tanh")
    return y @ p["out_proj"].to(x.dtype)
