"""qwen3-32b [dense] — GQA with qk_norm, SwiGLU. [hf:Qwen/Qwen3-*]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    mlp="swiglu",
    qk_norm=True,
    pos="rope",
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    name="qwen3-32b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, attn_chunk=32, scan_chunk=16,
)
