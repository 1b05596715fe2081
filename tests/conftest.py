import importlib.util
import subprocess
import sys
import textwrap

import pytest

# Optional-dependency guard: test modules must NOT hard-import optional
# packages (a ModuleNotFoundError at collection aborts the whole suite).
# Instead they guard the import with try/except and mark dependent tests
# with @pytest.mark.optional_dep("<package>"); this hook skips them when
# the package is missing. Dev installs get everything: requirements-dev.txt.
_OPTIONAL_DEPS = ("hypothesis",)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "optional_dep(name): test requires an optional dev dependency; "
        "skipped (not errored) when the package is not installed.")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with the reason without one")


def pytest_collection_modifyitems(config, items):
    missing = {name for name in _OPTIONAL_DEPS
               if importlib.util.find_spec(name) is None}
    if not missing:
        return
    for item in items:
        marker = item.get_closest_marker("optional_dep")
        if marker and marker.args and marker.args[0] in missing:
            item.add_marker(pytest.mark.skip(
                reason=f"optional dependency {marker.args[0]!r} "
                       f"not installed (see requirements-dev.txt)"))


def run_with_devices(code: str, n_devices: int = 4, timeout: int = 420):
    """Run a snippet in a subprocess with N forced host devices (the main
    process is locked to 1 device once jax initializes)."""
    env = {"PYTHONPATH": "src",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}",
           "PATH": "/usr/bin:/bin"}
    import os
    env["PATH"] = os.environ.get("PATH", env["PATH"])
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, **env}, cwd=".")
    if res.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}")
    return res.stdout


@pytest.fixture
def multi_device_runner():
    return run_with_devices
