"""phi4-mini-3.8b [dense] — 32L d3072 24H (GQA kv=8) d_ff=8192 vocab=200064."""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10000.0,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab_size=256,
    )
