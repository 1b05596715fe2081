"""llama4-scout-17b-a16e [moe] — 48L d5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

MoE: 16 routed experts, top-1 routing, plus a shared expert per layer
(Llama-4-Scout style). Experts are sharded over the ``model`` axis (EP).
"""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("moe",),
    n_experts=16,
    experts_per_token=1,
    shared_expert=True,
    rope_theta=500000.0,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, n_experts=4, experts_per_token=1,
    )
