"""Fixtures of the benchmark's CPU tests: the benchmark's description, its
cells cut to a size a CPU test holds, and one torch thread."""
import copy

import pytest
import torch

from portbench import harness


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite may run in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def small(cell: harness.Cell, n: int = 512, s_per_n: int = 2,
          outer: int = 3, inner: int = 10) -> harness.Cell:
    """``cell`` at n points, s = s_per_n·n, outer x inner iterations, on a
    pool of 4, with jobs of at most 3 clouds. n = 512 is a serving bucket,
    so nothing is padded."""
    config = copy.deepcopy(cell.config)
    config["solver"].update(s_per_n=s_per_n, outer_iters=outer,
                            inner_iters=inner)
    traffic = dict(cell.traffic, n=n, pool=4,
                   collection=min(3, int(cell.traffic["collection"])),
                   warmup_jobs=1, check_sample=3, profile_jobs=1)
    return harness.Cell(cell.name, cell.spec, config, traffic)


@pytest.fixture
def small_cell(bench, monkeypatch):
    """Makes a cell at a small size (:func:`small`). The server picks its
    solver by auto-selection, which keeps the full budgets at any size, so
    here it picks the small cell's solver."""
    def make(name, **kw):
        cell = small(harness.find_cell(bench, name), **kw)
        harness.check_cell(cell)
        from repro_torch.api.solvers import get_solver
        solver = get_solver(cell.config["solver"]["name"])(**cell.settings)
        import portbench.entries.server as entry
        import repro_torch.serve.server as server
        for mod in (entry, server):
            monkeypatch.setattr(mod, "select_solver",
                                lambda problem: solver)
        return cell
    return make
