"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared expert,
early-fusion multimodal backbone (text path built here). [hf:meta-llama/Llama-4-*]
"""
from repro_torch.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    mlp="swiglu",
    pos="rope",
    rope_theta=500_000.0,
    scan_layers=False,  # interleaved dense/MoE pattern: unrolled stack
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  shared_expert=True, capacity_factor=1.25, moe_every=2),
)

SMOKE = CONFIG.replace(
    name="llama4-maverick-smoke",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=128, attn_chunk=32, scan_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=96,
                  shared_expert=True, capacity_factor=8.0, group_size=64),
)
