"""``QuadraticProblem`` — the task of coupling two geometries.

Plain GW (no extras), fused GW (``M`` or feature geometries +
``fused_penalty``) and unbalanced GW (``lam``) are one class; solvers
dispatch on which optional fields are set.
"""
from __future__ import annotations

from dataclasses import InitVar, dataclass
from typing import Any, Optional

import torch

from repro_torch.api.geometry import Geometry
from repro_torch.core import ground_cost as gc
from repro_torch.core.utils import scalar

_MASS_ATOL = 1e-4


@dataclass(frozen=True)
class QuadraticProblem:
    """A (fused/unbalanced) quadratic OT problem between two geometries.

    geom_x, geom_y — the two spaces (cost + marginal [+ features])
    loss           — ground-loss name ("l2", "l1", "kl")
    fused_penalty  — α ∈ (0, 1]: weight of the quadratic term in fused GW,
                     required iff a linear term is present
    M              — optional (m, n) linear cost for fused GW
    lam            — optional λ > 0: unbalanced marginal-KL strength
                     (None → balanced, weights must sum to 1)
    validate       — init-only flag; ``False`` skips all checks
    """
    geom_x: Geometry
    geom_y: Geometry
    loss: str = "l2"
    fused_penalty: Optional[Any] = None
    M: Optional[Any] = None
    lam: Optional[Any] = None
    validate: InitVar[bool] = True

    def __post_init__(self, validate: bool = True):
        if self.M is not None:
            object.__setattr__(self, "M",
                               torch.as_tensor(self.M, dtype=torch.float32))
        if validate:
            self.check()

    def check(self):
        """Validate shapes and values; raises ValueError with the fix."""
        self.geom_x.check()
        self.geom_y.check()
        m, n = self.shape
        if self.loss not in gc.LOSSES:
            raise ValueError(
                f"unknown ground loss {self.loss!r} (known: l1, l2, kl)")
        if self.M is not None and tuple(self.M.shape) != (m, n):
            raise ValueError(
                f"M must have shape ({m}, {n}) = (len(geom_x), "
                f"len(geom_y)), got {tuple(self.M.shape)}")
        has_lin = self.is_fused
        if has_lin and self.fused_penalty is None:
            raise ValueError(
                "a linear term (M or features on both geometries) requires "
                "fused_penalty=α to be set (C_fu = α·L⊗T + (1-α)·M)")
        if self.fused_penalty is not None:
            if not has_lin:
                raise ValueError(
                    "fused_penalty set but no linear term: provide M or put "
                    "features on both geometries")
            alpha = scalar(self.fused_penalty)
            if not 0.0 < alpha <= 1.0:
                raise ValueError(
                    f"fused_penalty must lie in (0, 1], got {alpha}")
        if (self.geom_x.features is not None) != (
                self.geom_y.features is not None) and self.M is None:
            raise ValueError(
                "features must be set on both geometries (or neither) "
                "when no explicit M is given")
        if self.lam is not None and scalar(self.lam) <= 0.0:
            raise ValueError(f"lam must be > 0, got {scalar(self.lam)}")
        if self.lam is None:
            for name, w in (("geom_x", self.geom_x.weights),
                            ("geom_y", self.geom_y.weights)):
                total = float(torch.sum(w))
                if abs(total - 1.0) > _MASS_ATOL:
                    raise ValueError(
                        f"{name}.weights must sum to 1 for a balanced "
                        f"problem (got {total:.6f}); normalize them or "
                        f"pass lam=... for an unbalanced problem")
        object.__setattr__(self, "_validated", True)
        return self

    def to(self, device) -> "QuadraticProblem":
        """The same problem with every array on ``device`` (checked if this
        one was)."""
        moved = QuadraticProblem(
            self.geom_x.to(device), self.geom_y.to(device), self.loss,
            self.fused_penalty,
            None if self.M is None else self.M.to(device), self.lam,
            validate=False)
        if getattr(self, "_validated", False):
            object.__setattr__(moved, "_validated", True)
        return moved

    @property
    def shape(self):
        return (self.geom_x.n, self.geom_y.n)

    @property
    def is_fused(self) -> bool:
        return self.M is not None or (
            self.geom_x.features is not None
            and self.geom_y.features is not None)

    @property
    def is_unbalanced(self) -> bool:
        return self.lam is not None

    def linear_cost_dense(self):
        """The (m, n) linear cost M (explicit, or derived from features)."""
        if self.M is not None:
            return self.M
        fx, fy = self.geom_x.features, self.geom_y.features
        return torch.sum((fx[:, None, :] - fy[None, :, :]) ** 2, dim=-1)

    def linear_cost_at(self, rows, cols):
        """M gathered on a COO support — O(s·d), never materializes (m, n)."""
        if self.M is not None:
            return self.M[rows, cols]
        fx, fy = self.geom_x.features, self.geom_y.features
        return torch.sum((fx[rows] - fy[cols]) ** 2, dim=-1)
