"""xlstm-125m [ssm] — 12L d768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.

Block pattern ``(mlstm, mlstm, mlstm, slstm) × 3`` (mLSTM-dominant, per the
xLSTM paper's [7:1]-style mostly-mLSTM configurations). d_ff=0 per assignment:
blocks carry their own up/down projections (``lstm_proj_factor``). Constant
state size ⇒ supports ``long_500k``.
"""
from repro_torch.configs.base import ArchConfig, scale_down

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    n_superblocks=3,
    lstm_proj_factor=2.0,
    supports_long_context=True,
)


def reduced() -> ArchConfig:
    return scale_down(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab_size=256, n_superblocks=1,
    )
