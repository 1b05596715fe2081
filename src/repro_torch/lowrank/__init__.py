"""Low-rank GW (counterpart of ``repro.lowrank``).

Couplings factored as ``T = Q diag(1/g) Rᵀ`` and costs as skinny ``U Vᵀ``
products, so every GW iteration is linear in m + n (Scetbon, Peyré &
Cuturi, 2021/22). The ``lowrank_gw`` solver is registered by
``repro_torch.api``, which imports :mod:`repro_torch.lowrank.solver`.
"""
from repro_torch.lowrank.dykstra import lr_dykstra
from repro_torch.lowrank.factorize import (
    CostFactors,
    GroundFactors,
    factor_ground,
    khatri_rao_square,
    sketch_factors,
    sq_euclidean_factors,
)
from repro_torch.lowrank.gradients import gw_lr_gradients, gw_lr_value
from repro_torch.lowrank.init import LowRankDraws, anchor_init, random_init

__all__ = [
    "CostFactors",
    "GroundFactors",
    "LowRankDraws",
    "anchor_init",
    "factor_ground",
    "gw_lr_gradients",
    "gw_lr_value",
    "khatri_rao_square",
    "lr_dykstra",
    "random_init",
    "sketch_factors",
    "sq_euclidean_factors",
]
