"""The readers of the solver's spans inside a dispatch: their arithmetic on
synthetic span records, and what they read from a whole run of each cell
on the CPU at a small size."""
import time
from types import SimpleNamespace

import pytest

from portbench import harness

CELLS = ["server-moon2048-c2x28", "lib-moon8192-solve"]
SOLVER_METRICS = {"solver.sinkhorn_s", "solver.cost_s", "solver.check_s",
                  "solver.host_wait_s", "solver.host_reads"}


def _ctx(spans):
    cell = SimpleNamespace(traffic={"n": 2048},
                           config={"problem": {"loss": "l2"}},
                           settings={"s": 32768, "outer_iters": 20,
                                     "inner_iters": 50})
    return harness.Context(cell, [], 0.0, 1.0, setup_s=12.5,
                           peak_bytes=3 * 2**30, counters={}, spans=spans,
                           trace=None)


def _dispatch(name, sub, **attrs):
    return dict({"name": name, "start_s": 0.0, "duration_s": 1.0,
                 "sub": sub}, **attrs)


SOLVER_READERS = [
    ("solver.sinkhorn_s", "solver.sinkhorn", 1),
    ("solver.cost_s", "solver.cost", 1),
    ("solver.check_s", "solver.check", 1),
    ("solver.host_wait_s", "solver.host_read", 1),
    ("solver.host_reads", "solver.host_read", 0),
]


@pytest.mark.parametrize("metric,span,field", SOLVER_READERS)
def test_solver_span_readers_average_the_dispatches_roll_ups(metric, span,
                                                             field):
    """Each reader averages one entry of the dispatches' ``sub`` roll-ups
    (a dispatch without the span counts 0), over flushes and solves, and
    reads nothing without a dispatch that holds the span."""
    reader = harness.load_reader(metric)
    spans = [
        _dispatch("serve.dispatch", {span: [20, 0.5], "other": [3, 9.0]}),
        _dispatch("solve.dispatch", {span: [22, 0.7]}),
        _dispatch("serve.dispatch", {"other": [1, 1.0]}),
        # not a dispatch, and a dispatch of a program without roll-ups
        {"name": "serve.submit", "start_s": 0.0, "duration_s": 0.1,
         "sub": {span: [99, 99.0]}},
        {"name": "solve.dispatch", "start_s": 0.0, "duration_s": 1.0},
    ]
    want = ((20 + 22 + 0) / 3, (0.5 + 0.7 + 0.0) / 3)[field]
    assert reader.read(_ctx(spans)) == pytest.approx(want)
    assert reader.read(_ctx([])) is None
    assert reader.read(_ctx(spans[2:])) is None


def test_worker_wait_reader_averages_the_flushes_queue_time():
    reader = harness.load_reader("serve.worker_wait_s")
    spans = [_dispatch("serve.dispatch", {}, queued_s=q)
             for q in (0.0, 1.5, 3.0)]
    spans.append(_dispatch("solve.dispatch", {}, queued_s=100.0))
    assert reader.read(_ctx(spans)) == pytest.approx(1.5)
    # a program whose flushes carry no queue time: nothing is read
    old = [{"name": "serve.dispatch", "start_s": 0.0, "duration_s": 1.0}]
    assert reader.read(_ctx(old)) is None
    assert reader.read(_ctx([])) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_solver_spans(bench, small_cell, cell):
    """A traced run at 3 outer steps reads the five solver metrics in both
    cells: 3 health reads and the last error's a dispatch, and a flush's
    values besides (on the CPU the cost routes need no range check); the
    worker's wait only in the served cell."""
    res = harness.run_cell(bench, cell, 2**31 + 99, 0.6, True, "cpu",
                           time.perf_counter(), cell=small_cell(cell))
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert SOLVER_METRICS <= set(got)
    served = cell.startswith("server")
    assert got["solver.host_reads"]["value"] == 3 + 1 + served
    assert ("serve.worker_wait_s" in got) == served
    if served:
        assert got["serve.worker_wait_s"]["value"] >= 0.0
