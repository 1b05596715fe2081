"""The arithmetic of the metrics on synthetic timings and traces, and the
roofline counts at both cells' shapes."""
import math
from types import SimpleNamespace

import pytest

from portbench import devtrace, harness, loadgen, roofline, stats
from portbench.reference import spar_gw


def test_rate_counts_all_work_over_all_time():
    done = [1.5, 2.0, 3.0, 4.0, 12.0]
    # four done by the close at 10, the last at 4.0, start at 0.5
    assert stats.rate(done, 0.5, 10.0) == pytest.approx(4 / 3.5)
    assert stats.rate([], 0.0, 1.0) is None


def test_nearest_rank_percentile():
    values = list(range(1, 201))            # 1..200
    assert stats.percentile(values, 95) == 190
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(values[::-1], 50) == 100
    assert stats.percentile([], 95) is None


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    vals = [0.9, 1.0, 1.0, 1.1, 1.2, 1.0]
    import statistics
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_jobs_are_a_function_of_seed_and_index():
    mix = {"collection": 8, "pool": 32}
    a = loadgen.job(2**31 + 11, 5, mix)
    assert a == loadgen.job(2**31 + 11, 5, mix)
    assert a != loadgen.job(2**31 + 12, 5, mix)
    # all 28 pairs of 8 distinct clouds, indexed 5·28 on
    assert [r.index for r in a] == list(range(140, 168))
    assert len({r.x for r in a} | {r.y for r in a}) == 8
    assert len({frozenset((r.x, r.y)) for r in a}) == 28
    pairs = [loadgen.job(7, j, {"collection": 2, "pool": 4})
             for j in range(200)]
    assert all(len(p) == 1 and p[0].index == j for j, p in enumerate(pairs))
    assert all(p[0].x != p[0].y and {p[0].x, p[0].y} <= set(range(4))
               for p in pairs)
    assert len({p[0].gen_seed for p in pairs}) == 200


def test_a_job_is_submitted_whole_before_its_answers_are_waited_for():
    calls = []
    recs = loadgen.send_job(lambda r: calls.append(("submit", r.index))
                            or r.index,
                            lambda h: calls.append(("wait", h)) or h,
                            loadgen.job(3, 0, {"collection": 3, "pool": 5}))
    assert [c[0] for c in calls] == ["submit"] * 3 + ["wait"] * 3
    assert [r.outcome for r in recs] == [0, 1, 2]
    assert all(r.latency_s >= 0 for r in recs)


def _ctx(records, start, end, **kw):
    cell = SimpleNamespace(traffic={"n": 2048},
                           config={"problem": {"loss": "l2"}},
                           settings={"s": 32768, "outer_iters": 20,
                                     "inner_iters": 50})
    base = dict(setup_s=12.5, peak_bytes=3 * 2**30, counters={}, spans=[],
                trace=None)
    base.update(kw)
    return harness.Context(cell, records, start, end, **base)


def _records(pairs):
    req = loadgen.Request(0, 0, 1, 0)
    return [loadgen.Record(req, a, b) for a, b in pairs]


def test_end_to_end_readers_on_synthetic_timings():
    recs = _records([(0.0, 1.0), (0.0, 2.0), (1.0, 3.0), (2.0, 4.5),
                     (3.0, 11.0)])
    ctx = _ctx(recs, 0.0, 10.0)
    read = {n: harness.load_reader(n).read(ctx) for n in
            ("requests_per_s", "request.latency_p95_s", "peak_mem_gib",
             "setup_s")}
    assert read["requests_per_s"] == pytest.approx(4 / 4.5)
    # the drained one
    assert read["request.latency_p95_s"] == pytest.approx(8.0)
    assert read["peak_mem_gib"] == 3.0
    assert read["setup_s"] == 12.5
    assert harness.load_reader("peak_mem_gib").read(
        _ctx(recs, 0.0, 10.0, peak_bytes=None)) is None


def test_roofline_counts_at_both_cells_shapes():
    # s = 16n at n = 2048 and 8192: the two cost matrices read once bound
    # an evaluation, not its 4 s n operations
    for n, want_us in ((2048, 10.1727), (8192, 160.886)):
        s = 16 * n
        ops, nbytes = 4 * s * n, 8 * n * n + 16 * s
        assert ops / 67e12 < nbytes / 3.35e12
        assert roofline.cost_eval_s(s, n) == pytest.approx(nbytes / 3.35e12)
        assert roofline.cost_eval_s(s, n) * 1e6 == pytest.approx(want_us,
                                                                 rel=1e-4)
    assert roofline.solve_ops(32768, 2048, 20, 50) == \
        21 * 4 * 32768 * 2048 + 1000 * 8 * 32768


def test_the_counted_route_computes_the_l2_cost():
    """The cross term by D's sparse rows (2 s n operations) and s dot
    products of length n (2 s n) is the sum of the s² terms."""
    import torch
    n, s = 30, 200
    g = torch.Generator().manual_seed(4)
    Cx, Cy = torch.rand(n, n, generator=g, dtype=torch.float64), \
        torch.rand(n, n, generator=g, dtype=torch.float64)
    Cx, Cy = Cx + Cx.T, Cy + Cy.T
    r = torch.randint(0, n, (s,), generator=g)
    c = torch.randint(0, n, (s,), generator=g)
    t = torch.rand(s, generator=g, dtype=torch.float64)
    E = torch.zeros(n, n, dtype=torch.float64).index_add_(
        0, r, t[:, None] * Cy[c])             # D Cyᵀ, a row a pair
    cross = (Cx[r] * E.T[c]).sum(1)           # s dots of length n
    u = torch.zeros(n, dtype=torch.float64).index_add_(0, r, t)
    v = torch.zeros(n, dtype=torch.float64).index_add_(0, c, t)
    got = (Cx * Cx @ u)[r] + (Cy * Cy @ v)[c] - 2 * cross
    want = ((Cx[r][:, r] - Cy[c][:, c]) ** 2) @ t
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def _summary(by_name, busy=0.5, window=1.0, kernels=10, requests=2):
    return devtrace.Summary(window_s=window, busy_s=busy, kernels=kernels,
                            by_name=by_name, start_perf=0.0, stop_perf=1.0,
                            requests=requests)


def test_roofline_and_device_readers_on_a_synthetic_trace():
    by_name = {"void spar_matvec_kernel<256>(float const*)": (21, 0.2268),
               "void at::native::index_add_kernel": (1000, 0.3)}
    recs = _records([(0.0, 0.5), (0.1, 0.9), (0.2, 1.5)])
    ctx = _ctx(recs, 0.0, 1.0,
               trace=_summary(by_name, busy=0.6, window=1.0, kernels=5000,
                              requests=2))
    pct = harness.load_reader("spar_cost_roofline").read(ctx)
    # two requests answered, 21 evaluations each
    assert pct == pytest.approx(100 * 2 * 21
                                * roofline.cost_eval_s(32768, 2048) / 0.2268)
    assert 0 < pct < 100
    assert harness.load_reader("device.idle_pct").read(ctx) == \
        pytest.approx(40.0)
    assert harness.load_reader("device.kernels_per_req").read(ctx) == 2500
    # no launch of the named kernels: nothing is read
    ctx.trace = _summary({"other": (3, 0.1)})
    assert harness.load_reader("spar_cost_roofline").read(ctx) is None


def test_mfu_is_the_operations_of_the_window_s_solves_over_the_peak():
    recs = _records([(0.0, 1.0 + i) for i in range(4)])
    ctx = _ctx(recs, 0.0, 10.0)
    want = 100 * (4 / 4.0) * roofline.solve_ops(32768, 2048, 20, 50) / 67e12
    assert harness.load_reader("request.mfu_pct").read(ctx) == \
        pytest.approx(want)


class _Ev:
    def __init__(self, name, lo, dur, cuda, tid=1, corr=0, linked=0):
        self._v = (name, lo, dur, cuda, tid, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def test_trace_reduction_busy_time_and_named_gaps():
    us = 1000
    events = [
        # host: an op that launches kernel 1, then a long host op, then a
        # launch of kernel 2
        _Ev("aten::mul", 0, 10 * us, False),
        _Ev("cudaLaunchKernel", 6 * us, 2 * us, False, corr=1),
        _Ev("aten::item", 20 * us, 50 * us, False),
        _Ev("cudaLaunchKernel", 75 * us, 2 * us, False, corr=2),
        _Ev("kern_a", 10 * us, 10 * us, True, corr=1, linked=1),
        _Ev("kern_b", 80 * us, 15 * us, True, corr=2, linked=2),
        _Ev("Memcpy HtoD", 95 * us, 5 * us, True),
    ]
    spans = [(0.0, 1.0, "serve.dispatch")]
    s = devtrace.reduce(events, 0, 100 * us, 0.0, 1e-4, spans)
    assert s.window_s == pytest.approx(1e-4)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.kernels == 2
    gaps = dict(s.idle_gaps)
    # 0-10 us: before kern_a, the host in aten::mul; 20-80 us: aten::item
    assert gaps["serve.dispatch/aten::mul"] == pytest.approx(10e-6)
    assert gaps["serve.dispatch/aten::item"] == pytest.approx(60e-6)
    assert math.isclose(sum(gaps.values()) + s.busy_s, s.window_s)
    assert s.device_ops[0][0] == "kern_b"


def test_a_sample_is_judged_by_its_worst_value_and_median_coupling():
    nums = [{"support_mismatch": 0, "status_mismatch": 0, "value_rel": v,
             "coupling_rel": c}
            for v, c in ((1e-7, 2e-6), (3e-6, 9e-5), (2e-7, 3e-6))]
    got = spar_gw.aggregate(nums)
    assert got == {"support_mismatch": 0, "status_mismatch": 0,
                   "value_rel": 3e-6, "coupling_rel_median": 3e-6}
    nums[0]["support_mismatch"] = 5
    assert spar_gw.aggregate(nums)["support_mismatch"] == 5
    assert spar_gw.aggregate([]) == {}
