"""musicgen-medium [audio] — 48L d1536 24H d_ff=6144 vocab=2048.

Decoder-only transformer over EnCodec tokens: 4 codebooks, embeddings summed
at the input (delay-pattern handling lives in the data pipeline / stub
frontend per the assignment), 4 parallel LM heads at the output.
"""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, n_codebooks=2,
    )
