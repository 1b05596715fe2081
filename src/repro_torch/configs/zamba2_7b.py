"""zamba2-7b [hybrid] — 81L d3584 32H d_ff=14336 vocab=32000, ssm_state=64.

Mamba2 backbone with one *shared* attention+MLP transformer block invoked
every 6 Mamba2 layers (13 invocations over 78 scanned layers + 3 tail Mamba2
layers = 81 SSM layers), Zamba2 style. The shared block's weights are a single
copy reused at every invocation. SSM state is O(1) in context ⇒ supports
``long_500k``.
"""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("mamba2",) * 6,
    n_superblocks=13,
    tail_blocks=("mamba2",) * 3,
    shared_block_every=6,
    ssm_state=64,
    ssm_expand=2,
    ssm_heads=112,                  # d_inner 7168 / ssd head dim 64
    ssm_chunk=128,                  # intra-chunk block of the SSD kernel
    supports_long_context=True,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, block_pattern=("mamba2",) * 2,
        n_superblocks=2, tail_blocks=("mamba2",), shared_block_every=2,
        ssm_state=16, ssm_heads=4, ssm_chunk=8,
    )
