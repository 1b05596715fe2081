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
# the multiscale, health, diff, optim, obs, serve, launch, legacy core and
# training modules:
# scanned like every other file, and required to be there
NEW_MODULES = ("multiscale/anchors.py", "multiscale/compress.py",
               "multiscale/refine.py", "multiscale/solver.py",
               "health/faults.py", "health/fallback.py",
               "diff/__init__.py", "diff/fixed_point.py", "diff/losses.py",
               "diff/barycenter.py", "diff/unrolled.py", "optim/adamw.py",
               "obs/__init__.py", "obs/registry.py", "obs/span.py",
               "obs/trace.py", "obs/report.py", "obs/http.py",
               "serve/__init__.py", "serve/batching.py", "serve/cache.py",
               "serve/lanes.py", "serve/metrics.py", "serve/server.py",
               "launch/__init__.py", "launch/serve.py",
               "core/spar_gw.py", "core/emd.py", "core/sagrow.py",
               "core/align.py", "core/sharded_gw.py",
               "data/__init__.py", "data/pipeline.py",
               "checkpoint/__init__.py", "checkpoint/manager.py",
               "launch/steps.py", "launch/train.py",
               "configs/smollm_135m.py", "configs/phi4_mini_3_8b.py",
               "models/moe.py", "configs/minicpm3_4b.py",
               "configs/llama4_scout_17b_a16e.py",
               "configs/phi3_5_moe_42b_a6_6b.py",
               "configs/llama_3_2_vision_90b.py", "configs/xlstm_125m.py",
               "configs/musicgen_medium.py",
               "distrib/__init__.py", "distrib/sharding.py",
               "distrib/compression.py", "distrib/pipeline.py",
               "models/sharding_ctx.py", "launch/mesh.py",
               "launch/specs.py", "launch/dryrun.py", "launch/hillclimb.py")
# the modules the LM stack's last architectures added: each imports alone
LM_MODULES = ("repro_torch.models.moe", "repro_torch.configs.minicpm3_4b",
              "repro_torch.distrib.sharding",
              "repro_torch.distrib.compression",
              "repro_torch.distrib.pipeline",
              "repro_torch.models.sharding_ctx", "repro_torch.launch.mesh",
              "repro_torch.launch.specs", "repro_torch.launch.dryrun",
              "repro_torch.launch.hillclimb",
              "repro_torch.configs.llama4_scout_17b_a16e",
              "repro_torch.configs.phi3_5_moe_42b_a6_6b",
              "repro_torch.configs.llama_3_2_vision_90b",
              "repro_torch.configs.xlstm_125m",
              "repro_torch.configs.musicgen_medium")


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


def test_diff_obs_and_optim_import_alone_with_the_reference_names():
    """Each new package imports in a fresh process without JAX, and
    exposes the reference's public names (``repro_torch.diff`` adds
    ``unrolled_value``)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import repro_torch.diff, repro_torch.obs, repro_torch.optim\n"
        "from repro_torch.diff import (envelope_loop, locally_constant,\n"
        "    gw_loss, fgw_loss, quadratic_loss, gw_barycenter,\n"
        "    BarycenterResult, unrolled_value)\n"
        "from repro_torch.optim.adamw import init, update\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "print(sorted(repro_torch.obs.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    import repro.obs
    assert out.stdout.strip() == str(sorted(repro.obs.__all__))


def test_serve_and_launch_import_alone_with_the_reference_names():
    """``repro_torch.serve`` and ``repro_torch.launch.serve`` import in a
    fresh process without JAX; ``serve`` exposes the reference's public
    names but ``enable_compilation_cache`` (the port compiles nothing per
    shape)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.launch.serve\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "print(sorted(repro_torch.serve.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    import repro.serve
    want = sorted(set(repro.serve.__all__) - {"enable_compilation_cache"})
    assert out.stdout.strip() == str(want)


def test_server_and_launcher_raise_without_a_card(monkeypatch):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import GWServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GWServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])


@pytest.mark.parametrize("module", LM_MODULES)
def test_lm_modules_import_alone(module):
    """Each new module imports first in a fresh process without JAX or the
    reference; a config module's ``CONFIG`` resolves through
    ``configs.get_arch``."""
    import subprocess
    import sys

    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "if hasattr(m, 'CONFIG'):\n"
        "    from repro_torch.configs import get_arch, get_reduced\n"
        "    assert get_arch(m.CONFIG.name) is m.CONFIG\n"
        "    assert get_reduced(m.CONFIG.name).family == m.CONFIG.family\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_mesh_training_and_the_dry_run_raise_without_a_card(monkeypatch):
    """``train(mesh=)``, the meshes and the dry run take the card unless
    the caller names the CPU: with no card they raise, not fall back."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun, hillclimb, mesh, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("smollm_135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(cfg, 1, 4, 16, mesh=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--gw"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hillclimb.main(["--arch", "smollm-135m", "--shape", "train_4k",
                        "--variant", "sp"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh()
