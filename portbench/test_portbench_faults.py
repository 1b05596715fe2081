"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell (set-up, window, check) on the CPU
at a small size, skipping only the look for a card, with one fault
planted in the program: a step that returns its state unchanged; half of
the batch left out and the mean taken over the rest (half of the sampled
support, the rest counted double; for the server also half of a flush's
lanes); an answer altered where it is produced. A cell on one chip has no
exchange between chips to leave out.
"""
import time

import pytest
import torch

from portbench import harness

CELLS = ["server-moon2048-c2x28", "lib-moon8192-solve"]


def _run(bench, cell):
    return harness.run_cell(bench, cell.name, 2**31 + 99, 0.6, False, "cpu",
                            time.perf_counter(), cell=cell)


def _plant_unchanged_step(monkeypatch):
    import repro_torch.api.solvers as solvers
    import repro_torch.serve.lanes as lanes

    def frozen(loop):
        def run(step_fn, *args, **kw):
            return loop(lambda T, *rest: T, *args, **kw)
        return run
    monkeypatch.setattr(solvers, "pga_loop", frozen(solvers.pga_loop))
    monkeypatch.setattr(lanes, "health_loop_lanes",
                        frozen(lanes.health_loop_lanes))


def _half(fn):
    def half(t, off=0.0):
        keep = torch.ones_like(t)
        keep[..., t.shape[-1] // 2:] = 0.0
        return fn(2.0 * keep * t, off)
    return half


def _plant_half_support(monkeypatch):
    import repro_torch.api.solvers as solvers
    import repro_torch.serve.lanes as lanes
    for mod, name in ((solvers, "make_spar_cost_fn"),
                      (lanes, "make_spar_cost_fn_lanes")):
        make = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _make=make, **k: _half(_make(*a, **k)))


def _plant_half_lanes(monkeypatch):
    import repro_torch.serve.server as server
    run = server.run_lanes

    def half_lanes(stack):
        outs = run(stack)
        h = max(1, len(outs) // 2)
        return outs[:h] + [outs[i % h] for i in range(h, len(outs))]
    monkeypatch.setattr(server, "run_lanes", half_lanes)


def _alter(out):
    import dataclasses
    return dataclasses.replace(out, value=out.value * 1.01)


def _plant_altered_answer(monkeypatch):
    import repro_torch.api.solvers as solvers
    import repro_torch.serve.server as server
    run_balanced = solvers.SparGWSolver._run_balanced
    monkeypatch.setattr(solvers.SparGWSolver, "_run_balanced",
                        lambda self, *a: _alter(run_balanced(self, *a)))
    run = server.run_lanes
    monkeypatch.setattr(server, "run_lanes",
                        lambda stack: [_alter(o) for o in run(stack)])


FAULTS = {"unchanged_step": _plant_unchanged_step,
          "half_support": _plant_half_support,
          "altered_answer": _plant_altered_answer}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, small_cell, cell, trace):
    res = harness.run_cell(bench, cell, 2**31 + 99, 0.6, trace, "cpu",
                           time.perf_counter(), cell=small_cell(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in harness.metric_specs(bench, cell, trace)}
    assert set(res["metrics"]) <= want
    if trace:
        # the CPU runs no device op: the device's metrics read nothing
        assert res["device"]["window_s"] > 0
        assert "device.idle_pct" not in res["metrics"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(bench, small_cell, monkeypatch, cell,
                                      fault):
    FAULTS[fault](monkeypatch)
    res = _run(bench, small_cell(cell))
    assert not res["correct"], res["checks"]


def test_half_of_a_flush_left_out_is_not_correct(bench, small_cell,
                                                 monkeypatch):
    _plant_half_lanes(monkeypatch)
    cell = small_cell("server-moon2048-c2x28")
    # one client's jobs of ten pairs and a long deadline: flushes hold
    # eight lanes; every answer is judged
    cell.traffic.update(clients=1, collection=5, pool=5, check_sample=10**6)
    cell.config["server"]["max_wait_s"] = 1.0
    res = _run(bench, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_stalled_answer_anywhere_is_not_correct(bench, small_cell,
                                                  monkeypatch, cell):
    """``failed`` counts every answer of the window, not only the sample
    the reference recomputes, and is part of ``correct``."""
    import dataclasses

    c = small_cell(cell)
    # the sample's numbers pass whatever the answers: only `failed` judges
    monkeypatch.setattr(harness, "check", lambda *args: {})
    assert _run(bench, c)["correct"]
    entry = c.entry.Entry
    wait = entry.wait
    monkeypatch.setattr(entry, "wait", lambda self, h: dataclasses.replace(
        wait(self, h), status=harness.STALLED))
    res = _run(bench, c)
    assert res["checks"] == {"failed": {"value": res["attempted"],
                                        "limit": 0}}
    assert res["attempted"] > 0 and not res["correct"]
