"""qwen2.5-14b [dense] — GQA with QKV bias, SwiGLU. [hf:Qwen/Qwen2.5-*]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    head_dim=128,
    mlp="swiglu",
    qkv_bias=True,
    pos="rope",
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    name="qwen2.5-14b-smoke",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=160, vocab_size=128, attn_chunk=32, scan_chunk=16,
)
