"""The port stands alone: no JAX and nothing of the reference package.

Every ``.py`` file under ``src/repro_torch/`` and ``chip_smoke.py`` is
parsed with ``ast``; an import of ``jax`` (or ``jaxlib``), of ``repro``
/ ``repro.*`` or of ``benchmarks`` fails the test. The entry points run on the card by
default and must raise, not fall back to the CPU, when there is none.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import interop
from repro_torch.kernels import dispatch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")
# the multiscale and health modules: scanned like every other file, and
# required to be there
NEW_MODULES = ("multiscale/anchors.py", "multiscale/compress.py",
               "multiscale/refine.py", "multiscale/solver.py",
               "health/faults.py", "health/fallback.py")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 15
    port = ROOT / "src" / "repro_torch"
    assert all(port / m in files for m in NEW_MODULES)
    bad = [(str(p.relative_to(ROOT)), root) for p in files
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.core import sinkhorn\n"
                 "import jax.numpy as jnp\nfrom repro_torch import solve\n"
                 "from benchmarks import datasets\n")
    assert [r for r in _imported_roots(f) if r in FORBIDDEN] == [
        "repro", "jax", "benchmarks"]


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 300
    a = np.full(n, 1.0 / n, np.float32)
    C = np.ones((n, n), np.float32)
    p = interop.to_problem(C, a, C, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve(p, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device()
    assert dispatch.resolve_device("cpu") == torch.device("cpu")


def test_grid_solver_and_kernel_entry_points_raise_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 64
    a = np.full(n, 1.0 / n, np.float32)
    C = np.ones((n, n), np.float32)
    p = interop.to_problem(C, a, C, a, "l1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve(p, repro_torch.GridGWSolver(s_r=8, s_c=8),
                          generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve(p, "grid_gw",
                          generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("route", ["dense_gw", "lowrank_gw", "unbalanced",
                                   "quantized_gw"])
def test_new_routes_raise_without_a_card(monkeypatch, route):
    """The dense, low-rank, unbalanced and quantized routes resolve their
    device like the others: the card unless the caller asks for the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 64
    a = np.full(n, 1.0 / n, np.float32)
    pts = np.random.default_rng(0).standard_normal((n, 3))
    if route == "lowrank_gw":
        p = interop.to_problem(None, a, None, a, points_x=pts, points_y=pts)
    else:
        C = np.ones((n, n), np.float32)
        p = interop.to_problem(C, a, C, a,
                               lam=1.0 if route == "unbalanced" else None)
    solver = "spar_gw" if route == "unbalanced" else route
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve(p, solver,
                          generator=torch.Generator().manual_seed(0))
