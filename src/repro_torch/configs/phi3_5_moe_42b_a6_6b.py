"""phi3.5-moe-42b-a6.6b [moe] — 32L d4096 32H (GQA kv=8) d_ff=6400 vocab=32064.

MoE: 16 experts, top-2 routing, no shared expert.
"""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    block_pattern=("moe",),
    n_experts=16,
    experts_per_token=2,
    shared_expert=False,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, n_experts=4, experts_per_token=2,
    )
