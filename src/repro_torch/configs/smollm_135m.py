"""smollm-135m [dense] — 30L d576 9H (GQA kv=3) d_ff=1536 vocab=49152."""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10000.0,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=3, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab_size=256,
    )
