"""The paper's Moon pair (Li et al., arXiv:2205.13573, §6.1), frozen.

Two noisy interleaved half circles in the plane, with Gaussian marginals
over the point index (the paper's N(n/3, n/20) and N(n/2, n/20): the
configuration's ``problem.marginals`` gives the means and the deviation as
shares of n), floored at 1e-9 and normalised. The points are drawn on the host in float64 by NumPy (n x 2
numbers); the n x n Euclidean distance matrix, the large part, is made on
the device in float64 and stored as float32, the precision it is served
in.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.data import Pool

NOISE = 0.05
WEIGHT_FLOOR = 1e-9
READS = ("problem.family", "problem.ground_cost", "problem.marginals",
         "dtype")


def moon_points(n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 2) float64: two noisy half circles, n // 2 points in the first."""
    n1 = n // 2
    t1, t2 = np.pi * rng.random(n1), np.pi * rng.random(n - n1)
    pts = np.concatenate([np.stack([np.cos(t1), np.sin(t1)], 1),
                          np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], 1)])
    return pts + NOISE * rng.standard_normal(pts.shape)


def moon_weights(n: int, mean_frac: float, std_frac: float = 0.05
                 ) -> np.ndarray:
    """(n,) float32 marginal: a Gaussian bump at ``mean_frac * n`` with
    standard deviation ``std_frac * n``, floored at 1e-9 and normalised."""
    idx = np.arange(n)
    w = np.exp(-0.5 * ((idx - mean_frac * n) / (std_frac * n)) ** 2) \
        + WEIGHT_FLOOR
    return (w / w.sum()).astype(np.float32)


def distance_matrix(points: np.ndarray, device) -> torch.Tensor:
    """(n, n) float32 Euclidean distances of ``points``, made on
    ``device`` in float64 as ``sqrt(max(|x|² + |y|² - 2 x·y, 0))``."""
    x = torch.as_tensor(points, dtype=torch.float64, device=device)
    sq = (x * x).sum(1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    return torch.sqrt(d2).to(torch.float32)


def make_pool(config: dict, n: int, size: int, seed: int, device) -> Pool:
    """``size`` Moon clouds of ``n`` points, cloud i from the seed sequence
    (seed, "pool", i), and the configuration's two marginals."""
    pr = config["problem"]
    if pr["family"] != "moon" or pr["ground_cost"] != "euclidean" \
            or config["dtype"] != "float32":
        raise ValueError("the Moon family makes float32 Euclidean costs")
    costs = []
    for i in range(size):
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed % 2**64, 0x706F6F6C, i]))
        costs.append(distance_matrix(moon_points(n, rng), device))
    mg = pr["marginals"]
    if set(mg) != {"x_mean", "y_mean", "std"}:
        raise ValueError(f"Moon marginals are x_mean, y_mean and std; got "
                         f"{sorted(mg)}")
    a, b = (torch.as_tensor(moon_weights(n, float(mg[k]), float(mg["std"])),
                            device=device) for k in ("x_mean", "y_mean"))
    return Pool(costs, a, b)
