"""The port stands alone: no JAX and nothing of the reference package.

Every ``.py`` file under ``src/repro_torch/`` and ``chip_smoke.py`` is
parsed with ``ast``; an import of ``jax`` (or ``jaxlib``) or of ``repro``
/ ``repro.*`` fails the test. The entry points run on the card by
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
FORBIDDEN = ("jax", "jaxlib", "repro")


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
    bad = [(str(p.relative_to(ROOT)), root) for p in files
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.core import sinkhorn\n"
                 "import jax.numpy as jnp\nfrom repro_torch import solve\n")
    assert [r for r in _imported_roots(f) if r in FORBIDDEN] == [
        "repro", "jax"]


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
