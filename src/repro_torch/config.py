"""Architecture + run-shape configuration system (the port's copy of
`repro.config`, pure dataclasses; the tests hold it field by field to the
reference).

Every assigned architecture is a frozen `ArchConfig`; run shapes
(train_4k / prefill_32k / decode_32k / long_500k) are `RunShape`s.
`src/repro_torch/configs/<id>.py` instantiates the exact published numbers
and a reduced smoke config of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # arctic: dense residual MLP running in parallel with the routed experts
    dense_residual: bool = False
    # llama4: one always-on shared expert added to the routed output
    shared_expert: bool = False
    # route tokens within groups of this size (GShard-style grouping bounds
    # the dispatch tensor); 0 = pick automatically
    group_size: int = 0
    # MoE on every k-th layer (llama4 interleaves MoE with dense layers)
    moe_every: int = 1
    # True: expert weights ZeRO-3 FSDP-sharded over `data` (baseline; weight
    # all-gather per layer). False: EP-resident — experts sharded over
    # `model` only, replicated across `data`, optimizer moments ZeRO-1
    # sharded over `data`; tokens move (all-to-all), weights don't.
    expert_fsdp: bool = True
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    conv_k: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> d_model // 16


@dataclass(frozen=True)
class HybridConfig:
    # recurrentgemma: repeating block pattern, e.g. ("rec", "rec", "attn")
    pattern: Tuple[str, ...] = ()
    window: int = 2048          # local attention window
    d_rnn: int = 0              # RG-LRU width (0 -> d_model)
    conv_k: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 0
    dec_layers: int = 0
    dec_len: int = 512          # decoder text length used for train/prefill shapes
    max_dec_len: int = 512      # decoder self-attention cache length at decode


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    mlp: str = "swiglu"         # swiglu | sq_relu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    pos: str = "rope"           # rope | mrope | none | sincos
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    encdec: EncDecConfig = field(default_factory=EncDecConfig)

    # modality frontends are stubs per the assignment: inputs are precomputed
    # frame/patch embeddings rather than raw pixels/audio
    embeds_input: bool = False

    # ---- execution knobs (not part of the published architecture) ----
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"   # AdamW moment dtype
    scan_layers: bool = True
    scan_group: int = 0          # 0 = flat scan; g>1 = sqrt-remat group scan
    seq_parallel: bool = False   # shard residual-stream seq dim over `model`
    remat: str = "full"          # none | dots | full
    attention_impl: str = "chunked"  # dense | chunked | local | pallas
    attn_chunk: int = 1024
    scan_chunk: int = 256        # ssm/hybrid sequence-chunk size
    grad_accum: int = 1

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "ssm" and self.ssm.dt_rank == 0:
            object.__setattr__(
                self, "ssm", dataclasses.replace(self.ssm, dt_rank=self.d_model // 16)
            )
        if self.family == "hybrid" and self.hybrid.d_rnn == 0:
            object.__setattr__(
                self, "hybrid", dataclasses.replace(self.hybrid, d_rnn=self.d_model)
            )

    # -- convenience ----------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is supported (SSM / local-attention)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (logical / unpadded)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hq, hk, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * hq * hd + 2 * d * hk * hd + hq * hd * d
        if self.mlp == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = 0
        if self.family == "ssm":
            di, st, dtr = self.d_inner, self.ssm.d_state, self.ssm.dt_rank
            per_layer = (2 * d * di + di * self.ssm.conv_k + di * (dtr + 2 * st)
                         + dtr * di + di * st + di + di * d)
        elif self.family == "hybrid":
            n_attn = sum(1 for p in self._pattern_full() if p == "attn")
            n_rec = self.n_layers - n_attn
            dr = self.hybrid.d_rnn
            rec = 2 * d * dr + dr * self.hybrid.conv_k + 3 * dr + dr * d
            per_layer = 0  # handled below (non-uniform)
            total = n_attn * (attn + mlp) + n_rec * (rec + mlp)
            emb = v * d + (0 if self.tie_embeddings else d * v)
            return total + emb + L * 2 * d
        elif self.family == "moe":
            m = self.moe
            n_moe = self.n_layers // m.moe_every
            n_dense = self.n_layers - n_moe
            routed = m.n_experts * 3 * d * m.d_ff_expert
            extra = (3 * d * self.d_ff if m.dense_residual else 0)
            extra += (3 * d * m.d_ff_expert if m.shared_expert else 0)
            total = (self.n_layers * attn
                     + n_moe * (routed + extra + d * m.n_experts)
                     + n_dense * 3 * d * self.d_ff)
            emb = v * d + (0 if self.tie_embeddings else d * v)
            return total + emb + L * 2 * d
        elif self.family == "encdec":
            e = self.encdec
            enc = e.enc_layers * (attn + mlp)
            dec = e.dec_layers * (2 * attn + mlp)  # self + cross
            emb = v * d + (0 if self.tie_embeddings else d * v)
            return enc + dec + emb
        else:
            per_layer = attn + mlp
        emb = v * d + (0 if self.tie_embeddings else d * v)
        return L * per_layer + emb + L * 2 * d

    def active_param_count(self) -> int:
        """Params touched per token (MoE active; equals param_count for dense)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        m = self.moe
        n_moe = L // m.moe_every
        n_dense = L - n_moe
        hq, hk, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * hq * hd + 2 * d * hk * hd + hq * hd * d
        routed_active = m.top_k * 3 * d * m.d_ff_expert
        extra = (3 * d * self.d_ff if m.dense_residual else 0)
        extra += (3 * d * m.d_ff_expert if m.shared_expert else 0)
        emb = self.vocab_size * d * 2
        return (L * attn + n_moe * (routed_active + extra + d * m.n_experts)
                + n_dense * 3 * d * self.d_ff + emb)

    def _pattern_full(self) -> Tuple[str, ...]:
        if self.family != "hybrid":
            return ()
        pat = self.hybrid.pattern or ("rec", "rec", "attn")
        out = []
        while len(out) < self.n_layers:
            out.extend(pat)
        return tuple(out[: self.n_layers])


@dataclass(frozen=True)
class RunShape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = RunShape("train_4k", "train", 4_096, 256)
PREFILL_32K = RunShape("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = RunShape("decode_32k", "decode", 32_768, 128)
LONG_500K = RunShape("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def supports(cfg: ArchConfig, shape: RunShape) -> bool:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
