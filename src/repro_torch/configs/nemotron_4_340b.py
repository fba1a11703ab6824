"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    mlp="sq_relu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    name="nemotron-4-340b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, attn_chunk=32, scan_chunk=16,
)
