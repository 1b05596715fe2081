"""Telemetry of the port (``repro_torch.obs``) against ``repro.obs``, CPU.

The registry is pure Python in both packages: the same calls must give
the same snapshot (``uptime_s`` aside) and the same Prometheus text,
character for character. Convergence traces come from the same solves
on both sides (the reference's sampled support or low-rank draws
injected) and are held to the loop tolerances of tests/test_torch_solve.py
(PERF.md §6): ``err`` atol 5e-5, ``mass`` rtol 1e-5, ``objective``
rtol 1e-4 (it is the value at every iterate, early ones included, where
the inner Sinkhorn's rounding differences are not yet damped: measured
2.1e-5 at dense_gw's second step, the rtol 1e-4 that
tests/test_torch_health.py gives early iterates), ``delta`` atol 1e-5 +
rtol 1e-3 (a relative ℓ1 movement, a difference of nearly equal iterates
late in a solve), ``scale`` and ``rescued`` exact, NaN in the same
places. A rescued dense_gw solve's err, delta and objective get 1e-3
(see test_trace_of_a_rescued_solve_matches_the_reference). Spans are compared by name, parent and
depth; ``report()`` by its keys.
"""
import collections
import dataclasses
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro import obs as jobs
from repro.health import FaultSpec as JFaultSpec
from repro.obs.registry import MetricsRegistry as JRegistry
from repro_torch import obs
from repro_torch.api import interop
from repro_torch.health import FaultSpec, health_loop
from repro_torch.obs.registry import MetricsRegistry
from test_torch_lowrank import _ref_draws as lowrank_draws
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)

N = 24
KEY = jax.random.PRNGKey(0)
ERR_ATOL = 5e-5
VALUE_RTOL = 1e-5
OBJECTIVE_RTOL = 1e-4
RESCUED_ATOL = 1e-3
DELTA_ATOL, DELTA_RTOL = 1e-5, 1e-3


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)

    def dist(x):
        return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(
            np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    return (dist(rng.standard_normal((n, 2))), a,
            dist(1.2 * rng.standard_normal((n, 2))), a)


def _problems(n=N, loss="l2"):
    Cx, a, Cy, b = _data(n)
    jp = repro.QuadraticProblem(repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                                repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)),
                                loss=loss)
    return jp, interop.to_problem(Cx, a, Cy, b, loss)


def _fields(js):
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    if fields.get("fault") is not None:
        f = fields["fault"]
        fields["fault"] = {"at_iter": int(f.at_iter), "kind": f.kind,
                           "site": f.site, "persistent": f.persistent}
    return fields


# -- the registry -------------------------------------------------------------

def _exercise(reg):
    """The same sequence of registry calls on either package's registry."""
    reg.counter("repro_solves_total", "completed solves by status",
                solver="spar_gw", status="MAXITER").inc()
    reg.counter("repro_solves_total", solver="spar_gw",
                status="MAXITER").inc(2)
    reg.counter("repro_solves_total", solver="dense_gw",
                status="CONVERGED").inc()
    reg.counter("plain_total").inc(0.5)
    reg.gauge("queue_depth", "requests waiting", lane='a"b\\c\nd').set(7)
    reg.gauge("nan_gauge").set(float("nan"))
    reg.gauge("up_down").inc(3)
    reg.gauge("up_down").inc(-1.25)
    h = reg.histogram("latency_seconds", "solve latency", route="spar")
    for v in (0.0004, 0.003, 0.02, 0.02, 0.7, 3.0, 12.0):
        h.observe(v)
    small = reg.histogram("tiny_reservoir", buckets=(1.0, 10.0),
                          reservoir_cap=4)
    for v in range(50):                 # past the cap: reservoir sampling
        small.observe(v * 0.37)
    reg.histogram("empty_hist")
    return reg


def _snapshot(reg):
    snap = reg.snapshot()
    snap.pop("uptime_s")
    return snap


def test_registry_snapshot_and_text_equal_the_reference():
    j, p = _exercise(JRegistry()), _exercise(MetricsRegistry())
    assert _snapshot(p) == _snapshot(j)
    assert p.prometheus_text() == j.prometheus_text()
    assert obs.validate_exposition(p.prometheus_text()) == \
        jobs.validate_exposition(j.prometheus_text())
    doc = json.loads(p.jsonl_line({"run": 1}))
    assert doc["run"] == 1 and "ts" in doc
    json.dumps(_snapshot(p), allow_nan=False)        # NaN gauge → None


def test_registry_errors_and_percentiles_match_the_reference():
    for reg in (JRegistry(), MetricsRegistry()):
        reg.counter("c_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("c_total")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("c_total").inc(-1)
    assert obs.percentiles([]).keys() == jobs.percentiles([]).keys()
    assert all(np.isnan(v) for v in obs.percentiles([]).values())
    samples = [0.3, 0.1, 0.7, 0.2, 0.9]
    assert obs.percentiles(samples) == jobs.percentiles(samples)
    for bad in ("no_newline 1", "bad-name 1\n", 'm{l="x} 1\n',
                "# TYPE m nonsense\n"):
        for fn in (obs.validate_exposition, jobs.validate_exposition):
            with pytest.raises(ValueError):
                fn(bad)


def test_write_jsonl(tmp_path):
    reg = _exercise(MetricsRegistry())
    path = tmp_path / "metrics.jsonl"
    reg.write_jsonl(path, {"step": 0})
    reg.write_jsonl(path, {"step": 1})
    lines = path.read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]


def test_serve_metrics_http_on_an_ephemeral_port():
    reg = MetricsRegistry()
    reg.counter("http_test_total").inc()
    server = obs.serve_metrics_http(0, reg=reg)
    host, port = server.server_address[:2]
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        assert body == reg.prometheus_text()
        assert "http_test_total 1.0" in body
        obs.validate_exposition(body)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=5)
    finally:
        server.shutdown()


# -- convergence traces ---------------------------------------------------------

def _check_trace(P, jo, rescued_dense=False):
    jt, pt = jo.trace, P["trace"]
    assert pt is not None and jt is not None
    n = P["n_iters"]
    assert n == int(jo.n_iters)
    assert obs.n_valid(obs.ConvergenceTrace(**pt)) == n == jobs.n_valid(jt)
    for name in ("scale", "rescued"):
        np.testing.assert_array_equal(pt[name], np.asarray(getattr(jt, name)))
    for name in obs.ConvergenceTrace._fields:
        np.testing.assert_array_equal(np.isnan(pt[name]),
                                      np.isnan(np.asarray(getattr(jt, name))),
                                      err_msg=name)
    tight = not rescued_dense
    np.testing.assert_allclose(pt["err"], np.asarray(jt.err), rtol=0,
                               atol=ERR_ATOL if tight else RESCUED_ATOL)
    np.testing.assert_allclose(pt["mass"], np.asarray(jt.mass),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(pt["objective"], np.asarray(jt.objective),
                               rtol=OBJECTIVE_RTOL if tight else RESCUED_ATOL)
    np.testing.assert_allclose(pt["delta"], np.asarray(jt.delta),
                               rtol=DELTA_RTOL,
                               atol=DELTA_ATOL if tight else RESCUED_ATOL)


def _solve_both(name, js, n=N, loss="l2", **run_kw):
    jp, pp = _problems(n, loss)
    jo = repro.solve(jp, js, key=None if name == "dense_gw" else KEY)
    kw = dict(run_kw)
    if name in ("spar_gw", "grid_gw"):
        kw["support"] = interop.to_support(jo.coupling.rows, jo.coupling.cols)
    elif name == "lowrank_gw":
        kw["draws"] = interop.to_lowrank_draws(**lowrank_draws(KEY, jp, js))
    po = repro_torch.solve(pp, interop.to_solver(_fields(js), name),
                           device="cpu", **kw)
    return jo, po


TRACED = {
    "dense_gw": repro.DenseGWSolver(tol=1e-6, inner_tol=1e-8, outer_iters=10,
                                    trace=True),
    "spar_gw": repro.SparGWSolver(s=8 * N, outer_iters=10, trace=True),
    "grid_gw": repro.GridGWSolver(s_r=12, s_c=12, outer_iters=10,
                                  trace=True),
    "lowrank_gw": repro.LowRankGWSolver(outer_iters=30, trace=True),
}


@pytest.mark.parametrize("name", sorted(TRACED))
def test_trace_matches_the_reference(name):
    jo, po = _solve_both(name, TRACED[name])
    P = interop.output_to_numpy(po)
    _check_trace(P, jo)
    # an objective at every accepted step, and it is the value at the end
    n = P["n_iters"]
    assert np.isfinite(P["trace"]["objective"][:n]).all()
    np.testing.assert_allclose(P["trace"]["objective"][n - 1], P["value"],
                               rtol=VALUE_RTOL)


@pytest.mark.parametrize("name", ["dense_gw", "spar_gw"])
def test_trace_of_a_rescued_solve_matches_the_reference(name):
    """A NaN iterate at step 3: the attempt is rescued, and the trace keeps
    its forensic record (the poisoned mass, rescued = 1, the scale doubled
    after it) on both sides. spar_gw keeps the loop tolerances; dense_gw's
    restart at the doubled ε passes a transition (over steps 7–9 the
    marginal error falls 0.334 → 0.267 while the relative movement of the
    iterate rises 0.009 → 0.133) that amplifies the ulp differences of the
    two sides: measured 2.8e-4 absolute on delta, 1.2e-4 on err, so its
    err, delta and objective columns are held to 1e-3 (absolute, relative
    for the objective)."""
    js = dataclasses.replace(TRACED[name], tol=0.0,
                             fault=JFaultSpec(at_iter=3, kind="nan"))
    jo, po = _solve_both(name, js)
    P = interop.output_to_numpy(po)
    _check_trace(P, jo, rescued_dense=name == "dense_gw")
    tr = P["trace"]
    assert P["status"]["n_rescues"] == 1 == int(jo.status.n_rescues)
    assert tr["rescued"][3] == 1.0 and np.nansum(tr["rescued"]) == 1.0
    assert not np.isfinite(tr["mass"][3]) and np.isnan(tr["err"][3])
    assert tr["scale"][3] == 1.0 and tr["scale"][4] == 2.0


def test_trace_to_dict_is_strict_json():
    _, po = _solve_both("spar_gw", dataclasses.replace(
        TRACED["spar_gw"], fault=JFaultSpec(at_iter=2, kind="nan")))
    doc = obs.trace_to_dict(po.trace)
    assert doc["n_iters"] == po.n_iters
    assert doc["mass"][2] is None and doc["rescued"][2] == 1.0
    assert list(doc) == ["n_iters", *obs.ConvergenceTrace._fields]
    json.loads(json.dumps(doc, allow_nan=False))
    assert obs.trace_to_dict(None) is None


def test_loop_trace_matches_the_reference_loop():
    """health_loop on its own: the same step, fault and objective give
    the same buffers (the toy step of tests/test_obs.py)."""
    def run(loop, xp, fault):
        return loop(lambda T, s: 0.9 * T + 0.1 / s,
                    lambda T: xp.sum(xp.abs(T - 1)), xp.zeros(4), 12, 1e-4,
                    scaled_step=True, max_rescues=2, fault=fault, trace=True,
                    obj_fn=lambda T: xp.sum(T * T))
    from repro.health import health_loop as jhealth_loop
    jr = run(jhealth_loop, jnp, JFaultSpec(at_iter=2, kind="inf"))
    pr = run(health_loop, torch, FaultSpec(at_iter=2, kind="inf"))
    P = {"trace": {k: v.numpy() for k, v in pr.trace._asdict().items()},
         "n_iters": pr.n_iters}

    class _Out:
        trace, n_iters = jr.trace, jr.n_iters
    _check_trace(P, _Out)
    without = health_loop(lambda T: 0.5 * T + 0.5,
                          lambda T: torch.sum(torch.abs(T - 1)),
                          torch.zeros(4), 5, 0.0, trace=True)
    assert torch.isnan(without.trace.objective).all()


def test_trace_off_outputs_are_unchanged_by_tracing():
    """trace=False returns no trace, and turning tracing on changes no bit
    of the solve (the buffers are written beside it)."""
    _, pp = _problems()
    for solver in (repro_torch.SparGWSolver(s=8 * N, outer_iters=10),
                   repro_torch.DenseGWSolver(outer_iters=10, tol=1e-6),
                   repro_torch.GridGWSolver(s_r=12, s_c=12, outer_iters=10),
                   repro_torch.LowRankGWSolver(outer_iters=20)):
        outs = [repro_torch.solve(pp, dataclasses.replace(solver, trace=t),
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu") for t in (False, True)]
        off, on = (interop.output_to_numpy(o) for o in outs)
        assert off.pop("trace") is None and on.pop("trace") is not None
        assert off["value"] == on["value"] and off["status"] == on["status"]
        for k, v in off.items():
            if isinstance(v, np.ndarray):
                assert v.tobytes() == on[k].tobytes(), k


# -- spans, counters, report ------------------------------------------------------

def _counters(reg):
    """{(name, labels): value} of every counter series in a registry."""
    return {(name, tuple(sorted(row["labels"].items()))): row["value"]
            for name, fam in reg.snapshot()["metrics"].items()
            if fam["type"] == "counter" for row in fam["series"]}


def _delta(before, after, rung):
    """What a run added to each counter (the registries are process-wide,
    so other tests' counts are subtracted, not cleared), with the solves
    of the recovering ``rung`` counted whatever their status. Block-size
    resolutions are left out: the reference counts them when ``jit``
    traces (none once an executable is cached), the port at every call;
    ``test_torch_dispatch.py`` compares that counter on direct calls."""
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0.0)
        if not d or k[0] == "repro_kernel_block_resolutions_total":
            continue
        name, labels = k
        if name == "repro_solves_total" and dict(labels)["solver"] == rung:
            k = ("rung_solves", ())
            d += out.get(k, 0.0)
        out[k] = d
    return out


def _span_shape(records):
    return [(r["name"], r["parent"], r["depth"]) for r in records]


# the reference's spans: the stages of solve(); the port's solver.* spans
# inside a dispatch have no counterpart there
LIFECYCLE = ("solve", "solve.select", "solve.validate", "solve.dispatch",
             "solve.fallback")
SPAR_SPANS = {"solver.sample", "solver.cost_build", "solver.cost",
              "solver.sinkhorn", "solver.check", "solver.host_read",
              "solver.value"}


def _lifecycle(records):
    return [r for r in records if r["name"] in LIFECYCLE]


def _solver_spans_under_a_dispatch(records):
    """Names of the solver.* spans, each asserted to lie in a dispatch."""
    by_id = {r["id"]: r for r in records}
    names = set()
    for r in records:
        if not r["name"].startswith("solver."):
            continue
        up = r
        while up["name"] not in ("solve.dispatch", "serve.dispatch"):
            up = by_id[up["parent_id"]]
        names.add(r["name"])
    return names


def test_solve_spans_and_counters_match_the_reference():
    """A persistent NaN on spar_gw (l1, so the ladder skips lowrank_gw)
    under on_failure="fallback": the same lifecycle spans and the same
    counters on both sides (the ladder recovers on quantized_gw)."""
    fault = JFaultSpec(at_iter=1, kind="nan", persistent=True)
    js = repro.SparGWSolver(s=8 * N, outer_iters=10, max_rescues=1,
                            fault=fault)
    jp, pp = _problems(loss="l1")
    jreg, preg = jobs.registry(), obs.registry()
    jbefore, pbefore = _counters(jreg), _counters(preg)
    jobs.clear_spans()
    obs.clear_spans()
    jo = repro.solve(jp, js, key=KEY, on_failure="fallback")
    po = repro_torch.solve(pp, interop.to_solver(_fields(js), "spar_gw"),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu", on_failure="fallback")
    assert po.status.is_healthy and jo.status.is_healthy
    jspans, records = jobs.spans(), obs.spans()
    pspans = _lifecycle(records)
    assert _span_shape(pspans) == _span_shape(_lifecycle(jspans))
    assert [r["name"] for r in pspans] == [
        "solve", "solve.dispatch", "solve.fallback", "solve.dispatch"]
    assert _solver_spans_under_a_dispatch(records) >= SPAR_SPANS
    fb = [r for r in pspans if r["name"] == "solve.fallback"][0]
    jfb = [r for r in jspans if r["name"] == "solve.fallback"][0]
    assert fb["recovered"] and fb["recovered_by"] == jfb["recovered_by"]
    assert all(r["compiled"] is False for r in pspans
               if r["name"] == "solve.dispatch")
    # the recovering rung draws from the ladder's own generator on each
    # side, so its status is not compared: only that one solve of it was
    # counted
    rung = fb["recovered_by"]
    jdelta = _delta(jbefore, _counters(jreg), rung)
    pdelta = _delta(pbefore, _counters(preg), rung)
    assert pdelta == jdelta
    assert {name for name, _ in pdelta} == {
        "repro_solves_total", "repro_rescues_total",
        "repro_solve_failures_total", "repro_fallback_attempts_total",
        "repro_fallback_recoveries_total", "rung_solves"}


def test_select_and_validate_spans_match_the_reference():
    Cx, a, Cy, b = _data()
    jp = repro.QuadraticProblem(repro.Geometry(jnp.asarray(Cx), jnp.asarray(a)),
                                repro.Geometry(jnp.asarray(Cy), jnp.asarray(b)),
                                validate=False)
    pp = repro_torch.QuadraticProblem(repro_torch.Geometry(Cx, a),
                                      repro_torch.Geometry(Cy, b),
                                      validate=False)
    jobs.clear_spans()
    obs.clear_spans()
    repro.solve(jp, on_failure="raise")
    repro_torch.solve(pp, device="cpu", on_failure="raise")
    records = obs.spans()
    pspans = _lifecycle(records)
    assert _span_shape(pspans) == _span_shape(_lifecycle(jobs.spans()))
    assert [r["name"] for r in pspans] == [
        "solve", "solve.select", "solve.validate", "solve.dispatch"]
    assert pspans[0]["solver"] == "dense_gw"
    # dense_gw shares the health loop: its checks and reads are spanned
    assert _solver_spans_under_a_dispatch(records) == {
        "solver.check", "solver.host_read"}


def test_span_nesting_and_breakdown():
    obs.clear_spans()
    with obs.span("outer", tag=1) as rec:
        with obs.span("inner"):
            pass
        rec["extra"] = "x"
    recs = obs.spans()
    assert _span_shape(recs) == [("outer", None, 0), ("inner", "outer", 1)]
    assert recs[0]["tag"] == 1 and recs[0]["extra"] == "x"
    agg = obs.span_breakdown(recs)
    assert agg["outer"]["count"] == 1
    assert agg["outer"]["total_s"] >= agg["inner"]["total_s"] >= 0.0


def test_span_records_carry_ids_and_sub_rollups_on_two_threads():
    """Each record has a unique ``id`` and its parent's ``parent_id``; a
    closing span adds itself to every open span of its own thread only,
    so ``outer`` sums its thread's 3 ``mid`` and 6 ``leaf`` spans."""
    obs.clear_spans()
    meet = threading.Barrier(2)

    def work(tag):
        with obs.span("outer", tag=tag):
            for _ in range(3):
                with obs.span("mid"):
                    meet.wait()         # both threads hold open spans
                    for _ in range(2):
                        with obs.span("leaf"):
                            pass
    threads = [threading.Thread(target=work, args=(t,), name=f"w{t}")
               for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = obs.spans()
    by_id = {r["id"]: r for r in recs}
    assert len(by_id) == len(recs) == 2 * (1 + 3 + 6)
    for r in recs:
        if r["parent_id"] is None:
            assert r["name"] == "outer" and r["parent"] is None
        else:
            up = by_id[r["parent_id"]]
            assert (up["name"], up["thread"], up["depth"] + 1) == (
                r["parent"], r["thread"], r["depth"])
    for outer in (r for r in recs if r["name"] == "outer"):
        mine = [r for r in recs if r["thread"] == outer["thread"]]
        assert set(outer["sub"]) == {"mid", "leaf"}
        for name, count in (("mid", 3), ("leaf", 6)):
            got = outer["sub"][name]
            assert got[0] == count
            assert got[1] == pytest.approx(sum(
                r["duration_s"] for r in mine if r["name"] == name))
    for mid in (r for r in recs if r["name"] == "mid"):
        kids = [r for r in recs if r["parent_id"] == mid["id"]]
        assert mid["sub"] == {"leaf": [2, pytest.approx(
            sum(r["duration_s"] for r in kids))]}
    assert all(r["sub"] == {} for r in recs if r["name"] == "leaf")
    # a snapshot is a copy: changing it leaves the ring as it was
    recs[0]["sub"].clear()
    assert obs.spans()[0]["sub"]


def test_span_ids_and_roll_ups_hold_under_many_threads():
    """More threads than cores, switching every microsecond: no id is
    given twice and no roll-up loses a count."""
    workers, rounds = (os.cpu_count() or 1) + 4, 200
    obs.clear_spans()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with obs.span("stress.outer"):
            for _ in range(rounds):
                with obs.span("stress.leaf"):
                    pass
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = obs.spans()
    assert len(recs) == workers * (rounds + 1)
    assert len({r["id"] for r in recs}) == len(recs)
    outers = [r for r in recs if r["name"] == "stress.outer"]
    assert [r["sub"]["stress.leaf"][0] for r in outers] == [rounds] * workers


def _names_and_sites(records):
    return collections.Counter((r["name"], r.get("site")) for r in records)


def _check_solver_spans(records, dispatch, k, reads):
    """``k`` outer steps' spans under ``dispatch``, once each of the
    solve's set-up and value, and the dispatch's roll-up equal to them."""
    mine = [r for r in records if r["name"].startswith("solver.")]
    by_id = {r["id"]: r for r in records}
    for r in mine:
        up = r
        while up["id"] != dispatch["id"]:
            up = by_id[up["parent_id"]]
    got = _names_and_sites(mine)
    for name in ("solver.cost", "solver.sinkhorn", "solver.check"):
        assert got[(name, None)] == k, name
    assert got[("solver.host_read", "health")] == k
    for name in ("solver.sample", "solver.cost_build", "solver.value"):
        assert got[(name, None)] == 1, name
    for site, n in reads.items():
        assert got[("solver.host_read", site)] == n, site
    assert sum(n for (name, _), n in got.items()
               if name == "solver.host_read") == k + sum(reads.values())
    assert all(r["parent"] == "solver.check" for r in mine
               if r.get("site") == "health")
    for name in {n for n, _ in got}:
        count, seconds = dispatch["sub"][name]
        assert count == sum(n for (m, _), n in got.items() if m == name)
        assert seconds == pytest.approx(sum(
            r["duration_s"] for r in mine if r["name"] == name))
    (build,) = [r for r in mine if r["name"] == "solver.cost_build"]
    assert build["route"] == "plain"        # no kernel runs on the CPU


@pytest.mark.parametrize("k", [3, 7])
def test_spar_solve_spans_under_the_dispatch(k):
    """outer_iters=k gives k cost, Sinkhorn, check and health-read spans
    under ``solve.dispatch``; the answer is the one the reference
    comparison holds (the reference's support injected), and annotating
    the spans for the profiler changes no bit of it."""
    js = repro.SparGWSolver(s=8 * N, outer_iters=k)
    obs.clear_spans()
    jo, po = _solve_both("spar_gw", js)
    records = obs.spans()
    (dispatch,) = [r for r in records if r["name"] == "solve.dispatch"]
    _check_solver_spans(records, dispatch, k, {"last_err": 1})
    np.testing.assert_allclose(float(po.value), float(jo.value),
                               rtol=VALUE_RTOL)
    obs.configure(profiler_annotations=True)
    try:
        _, again = _solve_both("spar_gw", js)
    finally:
        obs.configure(None)
    for x, y in ((po.value, again.value), (po.coupling.vals,
                                           again.coupling.vals),
                 (po.errors, again.errors)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k", [2, 5])
def test_server_flush_spans_carry_request_ids_and_the_queue_wait(k):
    """A flush of three spar requests: ``serve.dispatch`` carries their
    ids in lane order and the time it waited for the worker, the solver's
    spans lie under it, each lane is its solo solve bit for bit, and the
    server keeps no ``serve.batch`` span."""
    from repro_torch.serve import GWServer, ServeConfig
    sv = repro_torch.SparGWSolver(s=8 * 16, outer_iters=k)
    probs = [interop.to_problem(*_data(16, seed)) for seed in range(3)]
    obs.clear_spans()
    srv = GWServer(ServeConfig(max_batch=4, max_wait_s=60.0, device="cpu",
                               on_failure="none"))
    try:
        rids = [srv.submit(p, sv, generator=torch.Generator().manual_seed(i))
                for i, p in enumerate(probs)]
        res = srv.results(rids)
    finally:
        srv.close()
    records = obs.spans()
    (dispatch,) = [r for r in records if r["name"] == "serve.dispatch"]
    assert dispatch["rids"] == rids and dispatch["lanes"] == 4
    assert dispatch["queued_s"] >= 0.0
    assert dispatch["thread"] == "gwserver-worker"
    _check_solver_spans(records, dispatch, k,
                        {"last_err": 1, "values": 1})
    for name in ("serve.submit", "serve.block"):
        assert sorted(r["rid"] for r in records
                      if r["name"] == name) == rids
    assert "serve.batch" not in {r["name"] for r in records}
    for i, (r, p) in enumerate(zip(res, probs)):
        solo = sv.run(p, generator=torch.Generator().manual_seed(i))
        assert torch.equal(r.output.value, solo.value)
        assert torch.equal(r.output.coupling.vals, solo.coupling.vals)


def test_span_profiler_annotation_pass_through():
    """With the annotation on, a span is also a torch.profiler region."""
    obs.configure(profiler_annotations=True)
    try:
        with torch.profiler.profile() as prof:
            with obs.span("annotated.span"):
                torch.ones(3).sum()
    finally:
        obs.configure(None)
    assert any(e.name == "annotated.span" for e in prof.events())


def test_report_keys_match_the_reference():
    js = repro.DenseGWSolver(outer_iters=8, tol=0.0, inner_tol=1e-8,
                             trace=True)
    jp, pp = _problems()
    jobs.clear_spans()
    obs.clear_spans()
    jo = repro.solve(jp, js, on_failure="raise")
    po = repro_torch.solve(pp, interop.to_solver(_fields(js), "dense_gw"),
                           device="cpu")
    jdoc, pdoc = jobs.report(jo, solver="dense_gw"), obs.report(
        po, solver="dense_gw")
    assert set(pdoc) == set(jdoc) == {"solve", "spans", "breakdown",
                                      "metrics"}
    assert set(pdoc["solve"]) == set(jdoc["solve"])
    assert set(pdoc["breakdown"]) == set(jdoc["breakdown"])
    assert set(pdoc["solve"]["trace"]) == set(jdoc["solve"]["trace"])
    assert pdoc["solve"]["n_iters"] == 8 == jdoc["solve"]["n_iters"]
    assert pdoc["solve"]["status"] == jdoc["solve"]["status"]
    np.testing.assert_allclose(pdoc["solve"]["value"], jdoc["solve"]["value"],
                               rtol=VALUE_RTOL)
    assert pdoc["breakdown"]["compile_s"] == 0.0
    assert pdoc["breakdown"]["dispatch_s"] > 0.0
    json.dumps(pdoc, allow_nan=False)
    # the argument-less report describes the last solve
    assert obs.report()["solve"]["n_iters"] == 8
