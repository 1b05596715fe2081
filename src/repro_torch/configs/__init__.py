"""Architecture and shape configurations of the LM stack, and the paper's
GW solver config (the port's copies)."""
from repro_torch.configs.base import (
    ARCH_IDS,
    CLI_ALIASES,
    SHAPES,
    ArchConfig,
    ShapeConfig,
    get_arch,
    get_reduced,
    scale_down,
    shapes_for,
)
from repro_torch.configs.paper import DEFAULT as DEFAULT_GW_CONFIG
from repro_torch.configs.paper import GWSolverConfig
