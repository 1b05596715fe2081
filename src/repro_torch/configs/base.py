"""Architecture / shape configuration dataclasses.

The port's own copy of the reference's ``configs/base.py`` (which imports
no JAX, but the port imports nothing of the reference). Every id of
``ARCH_IDS`` has a module ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` (published widths) and ``reduced()`` (CPU test size); an
unknown id raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    """A decoder-only LM backbone configuration.

    ``block_pattern`` describes one *superblock*; the stack is
    ``n_superblocks`` repetitions (scanned) plus ``tail_blocks`` extra
    blocks. Block kinds: ``attn`` (self-attn + MLP), ``xattn`` (cross-attn +
    MLP), ``mamba2``, ``mlstm``, ``slstm``, ``moe`` (self-attn + MoE MLP).
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # superblock structure
    block_pattern: Tuple[str, ...] = ("attn",)
    n_superblocks: int = 0           # 0 -> n_layers // len(block_pattern)
    tail_blocks: Tuple[str, ...] = ()
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # MLA (multi-head latent attention)
    attn_type: str = "gqa"           # gqa | mla
    mla_q_rank: int = 0
    mla_kv_rank: int = 0
    mla_rope_dim: int = 0
    mla_nope_dim: int = 0
    mla_v_dim: int = 0
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0               # mamba2 value heads
    ssm_chunk: int = 256
    # hybrid (zamba2): shared transformer block invoked every k ssm layers
    shared_block_every: int = 0
    # xLSTM
    lstm_proj_factor: float = 2.0
    # VLM
    cross_attn_every: int = 0        # informational; pattern encodes placement
    n_image_tokens: int = 0
    # audio
    n_codebooks: int = 0
    # misc
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which shapes are defined for this arch (long_500k only for sub-quadratic)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_superblocks(self) -> int:
        if self.n_superblocks:
            return self.n_superblocks
        return (self.n_layers - len(self.tail_blocks)) // len(self.block_pattern)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "llama_3_2_vision_90b",
    "llama3_8b",
    "smollm_135m",
    "minicpm3_4b",
    "phi4_mini_3_8b",
    "llama4_scout_17b_a16e",
    "phi3_5_moe_42b_a6_6b",
    "xlstm_125m",
    "zamba2_7b",
    "musicgen_medium",
)

# CLI ids (match assignment spelling) -> module names
CLI_ALIASES = {
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "llama3-8b": "llama3_8b",
    "smollm-135m": "smollm_135m",
    "minicpm3-4b": "minicpm3_4b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-7b": "zamba2_7b",
    "musicgen-medium": "musicgen_medium",
}


def _module(name: str):
    mod_name = CLI_ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_arch(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


def shapes_for(arch: ArchConfig):
    """The assigned shape cells that are active for this architecture."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not arch.supports_long_context:
            continue  # skip documented in DESIGN.md §Arch-applicability
        out.append(s)
    return out


def scale_down(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Build a reduced config of the same family for CPU smoke tests."""
    return dataclasses.replace(cfg, **overrides)
