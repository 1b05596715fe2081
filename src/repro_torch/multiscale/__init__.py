"""Multiscale (quantized) GW of the port — anchor-compress → solve → refine
(counterpart of ``repro.multiscale``).

The stages are reusable on their own: ``anchors.select_anchors`` (FPS +
weighted medoid refinement), ``compress.compress_problem`` (anchor-level
QuadraticProblem) and ``refine.block_refine`` (block-local Sinkhorn
expansion). The registered ``quantized_gw`` solver
(:class:`QuantizedGWSolver`) composes them with any registered base
solver for the anchor-level solve.
"""
from repro_torch.multiscale.anchors import (
    AnchorAssignment,
    farthest_point_sampling,
    medoid_refinement,
    member_table,
    membership,
    select_anchors,
)
from repro_torch.multiscale.compress import (
    coarse_value_correction,
    compress_geometry,
    compress_linear_cost,
    compress_problem,
)
from repro_torch.multiscale.refine import block_refine, top_pairs
from repro_torch.multiscale.solver import QuantizedDraws, QuantizedGWSolver

__all__ = [
    "AnchorAssignment",
    "select_anchors",
    "farthest_point_sampling",
    "medoid_refinement",
    "member_table",
    "membership",
    "coarse_value_correction",
    "compress_geometry",
    "compress_linear_cost",
    "compress_problem",
    "block_refine",
    "top_pairs",
    "QuantizedGWSolver",
    "QuantizedDraws",
]
