"""arctic-480b [moe] — 128 experts top-2 PLUS a dense residual MLP per layer
(dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    mlp="swiglu",
    pos="rope",
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True, capacity_factor=1.25),
)

SMOKE = CONFIG.replace(
    name="arctic-480b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=128, attn_chunk=32, scan_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                  dense_residual=True, capacity_factor=4.0, group_size=64),
)
