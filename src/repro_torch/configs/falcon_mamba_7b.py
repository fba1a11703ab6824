"""falcon-mamba-7b [ssm] — pure Mamba-1, attention-free. [arXiv:2410.05355]"""
from repro_torch.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    head_dim=1,
    mlp="swiglu",  # unused (attention-free family has no MLP)
    pos="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=16, conv_k=4, expand=2),
)

SMOKE = CONFIG.replace(
    name="falcon-mamba-7b-smoke",
    n_layers=2, d_model=64, vocab_size=128, scan_chunk=16,
    ssm=SSMConfig(d_state=4, conv_k=4, expand=2, dt_rank=8),
)
