"""whisper-large-v3 [audio] — enc-dec transformer backbone, conv frontend stub.

32 encoder + 32 decoder layers (the assignment's "32L"), MHA (kv == q heads),
GELU MLPs, LayerNorm with bias, sinusoidal encoder positions + learned decoder
positions, tied decoder embeddings. Inputs are precomputed frame embeddings
(the conv frontend is a stub per the assignment). [arXiv:2212.04356]
"""
from repro_torch.config import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=64,  # 32 enc + 32 dec
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    mlp="gelu",
    pos="none",
    tie_embeddings=True,
    norm_eps=1e-5,
    encdec=EncDecConfig(enc_layers=32, dec_layers=32, dec_len=448, max_dec_len=448),
    embeds_input=True,
)

SMOKE = CONFIG.replace(
    name="whisper-large-v3-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=131, attn_chunk=32, scan_chunk=16,
    encdec=EncDecConfig(enc_layers=2, dec_layers=2, dec_len=16, max_dec_len=32),
)
