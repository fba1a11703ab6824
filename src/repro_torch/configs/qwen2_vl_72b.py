"""qwen2-vl-72b [vlm] — M-RoPE backbone, dynamic-resolution frontend (stub).

Per the assignment the modality frontend is a stub: inputs are precomputed
patch embeddings at d_model plus 3-component (t,h,w) M-RoPE positions.
[arXiv:2409.12191]
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    mlp="swiglu",
    qkv_bias=True,
    pos="mrope",
    rope_theta=1_000_000.0,
    embeds_input=True,
)

SMOKE = CONFIG.replace(
    name="qwen2-vl-72b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, attn_chunk=32, scan_chunk=16,
)
