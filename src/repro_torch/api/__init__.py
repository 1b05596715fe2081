"""Problem/Solver/Output API of the port (counterpart of repro.api)."""
from repro_torch.api.geometry import Geometry
from repro_torch.api.output import (
    GridCoupling,
    GWOutput,
    LowRankCoupling,
    QuantizedCoupling,
    SparseCoupling,
)
from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solve import select_solver, solve
from repro_torch.api.solvers import (
    DenseGWSolver,
    GridGWSolver,
    SparGWSolver,
    available_solvers,
    get_solver,
    register_solver,
)

__all__ = [
    "Geometry",
    "QuadraticProblem",
    "GWOutput",
    "SparseCoupling",
    "GridCoupling",
    "LowRankCoupling",
    "QuantizedCoupling",
    "solve",
    "select_solver",
    "SparGWSolver",
    "GridGWSolver",
    "DenseGWSolver",
    "LowRankGWSolver",
    "QuantizedGWSolver",
    "get_solver",
    "register_solver",
    "available_solvers",
]

# register "lowrank_gw" and "quantized_gw"; both modules import
# api.solvers, so they come last
from repro_torch.lowrank.solver import LowRankGWSolver  # noqa: E402
from repro_torch.multiscale.solver import QuantizedGWSolver  # noqa: E402
