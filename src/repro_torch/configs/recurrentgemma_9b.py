"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern.

Pattern (rec, rec, attn) repeating over 38 layers; local attention window
2048; MQA (kv=1). [arXiv:2402.19427]
"""
from repro_torch.config import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    mlp="swiglu",
    pos="rope",
    scan_layers=False,  # non-uniform pattern: unrolled stack
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), window=2048, conv_k=4),
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-9b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=128, attn_chunk=32, scan_chunk=16,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), window=16, conv_k=4),
)
