"""Architecture and shape configurations of the LM stack (the port's copy)."""
from repro_torch.configs.base import (
    ARCH_IDS,
    CLI_ALIASES,
    PORTED_IDS,
    SHAPES,
    ArchConfig,
    ShapeConfig,
    get_arch,
    get_reduced,
    scale_down,
    shapes_for,
)
