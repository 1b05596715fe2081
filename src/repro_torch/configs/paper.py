"""Solver configs for the paper's own experiments (SPAR-GW and variants)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class GWSolverConfig:
    loss: str = "l2"            # l1 | l2 | kl
    reg: str = "prox"           # prox (PGA, KL(T||T^r)) | ent (entropic H(T))
    epsilon: float = 1e-2
    outer_iters: int = 20       # R
    inner_iters: int = 50       # H (Sinkhorn)
    # sparsification
    sample_ratio: int = 16      # s = sample_ratio * n (paper default s = 16n)
    # unbalanced
    marginal_lambda: float = 1.0
    seed: int = 0


DEFAULT = GWSolverConfig()
PAPER_FIG2 = GWSolverConfig(epsilon=1e-2, outer_iters=20, inner_iters=50,
                            sample_ratio=16)
