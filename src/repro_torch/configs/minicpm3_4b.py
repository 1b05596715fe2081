"""minicpm3-4b [dense] — 62L d2560 40H d_ff=6400 vocab=73448 — MLA attention.

Multi-head latent attention dims follow hf:openbmb/MiniCPM3-4B:
q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32,
v_head_dim=64. The KV cache stores the compressed latent (c_kv + k_rope).
"""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,          # qk head dim = nope 64 + rope 32
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    mla_q_rank=768,
    mla_kv_rank=256,
    mla_rope_dim=32,
    mla_nope_dim=64,
    mla_v_dim=64,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, vocab_size=256, mla_q_rank=32, mla_kv_rank=16,
        mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16,
    )
