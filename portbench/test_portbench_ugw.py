"""The unbalanced configuration (``spar-moon-l2-unbalanced``) on the CPU:
the plain reference of Alg. 3 against ``repro_torch`` at small sizes, its
control, the counts of an unbalanced solve, the readers the cell reports
(``ugw.mfu_pct`` and the solver and device readers it shares with the
balanced cells), whole small runs sound and with a fault planted, and
discovery of the cell."""
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import devtrace, harness, loadgen, readings, roofline, \
    ugw_counts
from portbench.data import moon
from portbench.entries import Outcome
from portbench.reference import spar_ugw as reference

UGW = "lib-moon8192-ugw"
SEED = 2**31 + 99


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    Cx = moon.distance_matrix(moon.moon_points(n, rng), "cpu")
    Cy = moon.distance_matrix(moon.moon_points(n, rng), "cpu")
    a = torch.as_tensor(moon.moon_weights(n, 1 / 3))
    b = torch.as_tensor(moon.moon_weights(n, 1 / 2))
    return Cx, Cy, a, b


def _settings(n, s_per_n, outer, inner):
    return dict(s=s_per_n * n, reg="prox", epsilon=0.01, outer_iters=outer,
                inner_iters=inner, max_rescues=2, rescue_factor=2.0)


def _program(Cx, Cy, a, b, settings, seed=None, support=None, lam=1.0):
    from repro_torch import Geometry, QuadraticProblem, SparGWSolver, solve
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return solve(QuadraticProblem(Geometry(Cx, a), Geometry(Cy, b), lam=lam),
                 SparGWSolver(**settings), generator=gen, support=support,
                 device="cpu")


def _outcome(out):
    c = out.coupling
    return Outcome(float(out.value), c.rows, c.cols, c.vals,
                   int(out.status.code), int(out.n_iters))


# The program is float32 and the reference float64, on the same support
# and with the same health rule: every gap is float32 rounding carried
# through the steps. Measured at these sizes: value 2.7e-8-4.1e-7,
# coupling 6.8e-7-1.3e-6, mass 1.4e-7; the TF32 control reads 0.9-3.0e-4,
# 1.5-4.3e-4 and 6e-7-6e-5. The tolerances sit 10-20x over the program.
VALUE_RTOL, COUPLING_RTOL, MASS_RTOL = 1e-5, 2e-5, 2e-6


@pytest.mark.parametrize("n,s_per_n,outer,inner", [(96, 4, 4, 10),
                                                   (300, 2, 20, 50)])
def test_reference_matches_the_program(n, s_per_n, outer, inner):
    Cx, Cy, a, b = _pair(n, 3)
    settings = _settings(n, s_per_n, outer, inner)
    seed = 2**40 + 17
    out = _program(Cx, Cy, a, b, settings, seed)
    ref = reference.solve(Cx, Cy, a, b, 1.0, seed, settings)
    # eq. (9) in float32 in the program's order: the same draw
    assert torch.equal(out.coupling.rows, ref.rows)
    assert torch.equal(out.coupling.cols, ref.cols)
    got = reference.compare(_outcome(out), ref)
    assert got["support_mismatch"] == 0 and got["status_mismatch"] == 0
    assert got["value_rel"] <= VALUE_RTOL
    assert got["coupling_rel"] <= COUPLING_RTOL
    assert got["mass_rel"] <= MASS_RTOL
    control = reference.solve(Cx, Cy, a, b, 1.0, seed, settings,
                              precision="tf32")
    control = Outcome(control.value, control.rows, control.cols, control.T,
                      control.status, control.n_iters)
    got = reference.compare(control, ref)
    assert got["value_rel"] > VALUE_RTOL
    assert got["coupling_rel"] > COUPLING_RTOL


def test_an_answer_on_another_support_is_judged_on_its_own():
    """Pairs the program drew elsewhere count in ``support_mismatch``; the
    value, coupling and mass are judged against the reference solved on
    the program's support, not on the redrawn one."""
    Cx, Cy, a, b = _pair(64, 4)
    settings = _settings(64, 4, 3, 10)
    ref = reference.solve(Cx, Cy, a, b, 1.0, 7, settings)
    rows, cols = ref.rows.clone(), ref.cols.clone()
    rows[:3] = (rows[:3] + 1) % 64
    out = _program(Cx, Cy, a, b, settings, support=(rows, cols))
    got = reference.compare(_outcome(out), ref)
    assert got["support_mismatch"] == 3
    assert got["value_rel"] <= VALUE_RTOL
    assert got["coupling_rel"] <= COUPLING_RTOL
    assert got["mass_rel"] <= MASS_RTOL


def test_eq9_float32_is_the_float64_route_within_rounding():
    """The draw's float32 p (dense product) and the reference's float64 p
    (rank-one identity) are the same probability: a product measure would
    be far from both."""
    Cx, Cy, a, b = _pair(80, 5)
    p32 = reference.probs_float32(Cx, Cy, a, b, 1.0, 0.01).double()
    p64 = reference.probs(Cx.double(), Cy.double(), a.double(), b.double(),
                          1.0, 0.01)
    assert float(p64.sum()) == pytest.approx(1.0, abs=1e-12)
    assert float((p32 - p64).abs().sum()) <= 1e-5
    balanced = torch.sqrt(a.double())[:, None] * torch.sqrt(b.double())
    balanced = balanced / balanced.sum()
    assert float((balanced - p64).abs().sum()) > 0.1


def test_control_is_not_correct_and_the_program_is(bench, small_cell):
    cell = small_cell(UGW)
    got = readings.readings(bench, UGW, 2**31 + 3, 4, "cpu", cell)
    limits = cell.config["limits"]
    assert all(got["program"][k] <= limits[k] for k in limits), got
    assert any(got["control"][k] > limits[k] for k in limits), got


def test_counts_on_hand_worked_sizes():
    s, n = 8, 4
    # init: 10 n² matrix-vector, 9 n² eq. (9), 8 draws of 4 comparisons
    assert ugw_counts.init_ops(s, n) == 19 * 16 + 8 * 4
    assert ugw_counts.sinkhorn_iter_ops(s, n) == 8 * 8 + 4 * 4
    assert ugw_counts.step_ops(s, n) == 11 * 8 + 8 * 4
    # 336 init + 3 · 128 costs + 6 · 80 iterations + 2 · 120 steps + 72
    assert ugw_counts.solve_ops(s, n, 2, 3) == 336 + 384 + 480 + 240 + 72
    # the rank-one init is O(n²), not the dense product's 2 n³
    n = 8192
    init = ugw_counts.init_ops(16 * n, n)
    assert init < 20 * n * n + 16 * n * 27
    assert init < 2.0 * n ** 3 / 800
    # at the cell's shape the cost evaluations are most of the work
    whole = ugw_counts.solve_ops(16 * n, n, 20, 50)
    assert 21 * roofline.cost_eval_ops(16 * n, n) > 0.9 * whole


def _ctx(spans=(), records=(), trace=None, n=8192):
    cell = SimpleNamespace(traffic={"n": n},
                           config={"problem": {"loss": "l2"}},
                           settings={"s": 16 * n, "outer_iters": 20,
                                     "inner_iters": 50})
    return harness.Context(cell, list(records), 0.0, 10.0, setup_s=12.5,
                           peak_bytes=2**30, counters={}, spans=list(spans),
                           trace=trace)


def _dispatch(sub):
    return {"name": "solve.dispatch", "start_s": 0.0, "duration_s": 1.0,
            "sub": sub}


@pytest.mark.parametrize("metric,span", [("solver.cost_s", "solver.cost"),
                                         ("solver.sinkhorn_s",
                                          "solver.sinkhorn")])
def test_span_readers_average_the_dispatches(metric, span):
    """The balanced cells' span readers read an unbalanced dispatch's
    roll-up, ``solver.ugw_init`` beside the spans they read."""
    reader = harness.load_reader(metric)
    init = {"solver.ugw_init": [1, 0.002]}
    spans = [_dispatch({**init, span: [20, 0.25]}),
             _dispatch({**init, span: [20, 0.75]}),
             _dispatch({**init, "solver.check": [20, 0.1]})]
    assert reader.read(_ctx(spans)) == pytest.approx((0.25 + 0.75) / 3)
    # a program whose unbalanced path opens no such span: nothing to read
    assert reader.read(_ctx(spans[2:])) is None
    assert reader.read(_ctx()) is None


def test_kernels_and_mfu_readers():
    kern, mfu = (harness.load_reader(m) for m in ("device.kernels_per_req",
                                                  "ugw.mfu_pct"))
    t = devtrace.Summary(window_s=2.0, busy_s=1.0, kernels=120, by_name={},
                         requests=3)
    assert kern.read(_ctx(trace=t)) == 40.0
    assert kern.read(_ctx()) is None
    recs = [loadgen.Record(None, 0.0, done, None) for done in (2.0, 4.0)]
    rate = 2 / 4.0
    want = 100.0 * rate * ugw_counts.solve_ops(16 * 8192, 8192, 20, 50) \
        / roofline.FP32_FLOPS
    assert mfu.read(_ctx(records=recs)) == pytest.approx(want)
    assert 0.0 < want < 1.0
    assert mfu.read(_ctx()) is None


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(bench, small_cell, trace):
    res = harness.run_cell(bench, UGW, SEED, 0.6, trace, "cpu",
                           time.perf_counter(), cell=small_cell(UGW))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"failed"} | set(reference.NUMBERS)
    want = {m["name"] for m in harness.metric_specs(bench, UGW, trace)}
    assert set(res["metrics"]) <= want
    if trace:
        got = res["metrics"]
        assert {"solver.sinkhorn_s", "solver.cost_s", "ugw.mfu_pct",
                "solve.dispatch_s", "solver.host_reads"} <= set(got)
        # the CPU runs no device op: the device's metrics read nothing
        assert "device.kernels_per_req" not in got


def _plant_half_sinkhorn(monkeypatch):
    import repro_torch.api.solvers as solvers
    run = solvers.sparse_sinkhorn_unbalanced_log

    def half(*args, **kw):
        args = list(args)
        args[-1] = max(1, args[-1] // 2)        # inner iterations
        return run(*args, **kw)
    monkeypatch.setattr(solvers, "sparse_sinkhorn_unbalanced_log", half)


def _plant_balanced_rho(monkeypatch):
    """The exponent ρ = 1: the balanced update under the unbalanced
    step."""
    import repro_torch.api.solvers as solvers
    run = solvers.sparse_sinkhorn_unbalanced_log
    monkeypatch.setattr(
        solvers, "sparse_sinkhorn_unbalanced_log",
        lambda a, b, rows, cols, logK, lam, eps, *rest, **kw:
        run(a, b, rows, cols, logK, lam, 0.0 * eps, *rest, **kw))


def _plant_eq5_draw(monkeypatch):
    """The support drawn, and weighted, by eq. (5)'s product measure
    sqrt(a) ⊗ sqrt(b) in place of eq. (9)."""
    from repro_torch.core import sampling

    def eq5(a, b, *rest, **kw):
        pa, pb = torch.sqrt(a), torch.sqrt(b)
        return (pa / pa.sum())[:, None] * (pb / pb.sum())[None, :]
    monkeypatch.setattr(sampling, "unbalanced_probs", eq5)


def _plant_altered_answer(monkeypatch):
    import repro_torch.api.solvers as solvers
    run = solvers.SparGWSolver._run_unbalanced
    def altered(self, *args):
        out = run(self, *args)
        return dataclasses.replace(out, value=out.value * 1.01)
    monkeypatch.setattr(solvers.SparGWSolver, "_run_unbalanced", altered)


FAULTS = {"half_sinkhorn": _plant_half_sinkhorn,
          "balanced_rho": _plant_balanced_rho,
          "eq5_draw": _plant_eq5_draw,
          "altered_answer": _plant_altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(bench, small_cell, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    cell = small_cell(UGW)
    res = harness.run_cell(bench, UGW, SEED, 0.6, False, "cpu",
                           time.perf_counter(), cell=cell)
    assert not res["correct"], res["checks"]
    if fault == "eq5_draw":
        # nearly every pair of the support moves
        got = res["checks"]["support_mismatch"]["value"]
        assert got > 0.9 * cell.settings["s"]


def test_cell_finds_its_configuration_and_mix(bench):
    c = harness.find_cell(bench, UGW)
    assert c.config["name"] == c.spec["config"] and c.spec["chips"] == 1
    assert c.config["reduced"] == []
    assert set(c.traffic) == set(loadgen.KEYS)
    assert set(c.config["limits"]) == set(c.reference.NUMBERS)
    assert c.data.__name__ == "portbench.data.moon"
    assert harness.unread_keys(c.config, set(harness.READS)
                               | set(c.entry.Entry.READS)
                               | set(c.data.READS)
                               | set(c.reference.READS)) == []
    from repro_torch.api.solvers import get_solver
    sv = get_solver(c.config["solver"]["name"])(**c.settings)
    assert sv.s == 16 * int(c.traffic["n"])


def test_the_unbalanced_cell_is_alg3_at_lam_one(bench):
    c = harness.find_cell(bench, UGW)
    assert c.config["entry"] == "solve_unbalanced"
    assert c.config["problem"]["lam"] == 1.0
    assert "problem.lam" in c.entry.Entry.READS
    assert c.traffic["n"] == 8192 and c.reference is reference
    assert "mass_rel" in c.config["limits"]
    # without lam the reference refuses the configuration
    c.config = dict(c.config, problem={k: v for k, v in
                                       c.config["problem"].items()
                                       if k != "lam"})
    with pytest.raises(NotImplementedError):
        harness.check_cell(c)


def test_metrics_of_the_unbalanced_cell(bench):
    ugw = {m["name"] for m in harness.metric_specs(bench, UGW, True)}
    assert {"solver.sinkhorn_s", "solver.cost_s", "device.kernels_per_req",
            "ugw.mfu_pct"} <= ugw
    # the balanced readers of a whole request's work and K7's share would
    # read the wrong counts or nothing here
    assert not {"serve.flush_s", "request.mfu_pct",
                "solver.sinkhorn_kernel_share"} & ugw
    for cell in ("server-moon2048-c2x28", "lib-moon8192-solve"):
        assert not any(m["name"].startswith("ugw.")
                       for m in harness.metric_specs(bench, cell, True))
    moved = {m["moves"] for m in harness.metric_specs(bench, UGW, True)}
    reported = {m["name"] for m in harness.metric_specs(bench, UGW, False)}
    assert moved <= reported
