"""llama-3.2-vision-90b [vlm] — 100L d8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

Cross-attention image layers every 5th layer (20 xattn superblock closers).
Modality frontend is a stub: ``input_specs`` provides precomputed patch
embeddings ``(batch, n_image_tokens, d_model)``.
"""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    n_superblocks=20,
    cross_attn_every=5,
    n_image_tokens=1024,
    rope_theta=500000.0,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG,
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_superblocks=1,
        n_image_tokens=8,
    )
