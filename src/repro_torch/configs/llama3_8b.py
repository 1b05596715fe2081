"""llama3-8b [dense] — 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=128256."""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
