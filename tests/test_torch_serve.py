"""The serving slice: ``repro_torch.serve`` against ``repro.serve``, CPU.

Inputs are made from numpy seeds and handed to both packages. The port
is held to the reference where the reference is deterministic (bucket
policy, padding, ``content_hash`` digests, batch grouping, cache
counters, metric keys) and to ``tests/test_torch_solve.py``'s bounds
where it computes: a served value within rtol 1e-5 of the reference
server's, coupling entries within atol 1e-6 + rtol 1e-4 (both sides run
the same fp32 solve and differ in summation order).

Lanes: on the CPU a lane is bit for bit its solo solve (``solver.run``
on the padded problem, from the same generator state): value, coupling,
errors, status, iteration count and trace, whatever its mates (clean,
poisoned or filler) and whatever the width of its flush, width 1
included. That is more than the reference gives (its vmapped lane is one
ulp off its eager solve on this jax); the port gets it by running one
matvec a lane where a batched one would sum in another order.
"""
import contextlib
import dataclasses
import io
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.serve as rserve
import repro_torch
from repro_torch import DenseGWSolver, Geometry, QuadraticProblem
from repro_torch import SparGWSolver
from repro_torch.health import FaultSpec
from repro_torch.health.loop import health_loop, health_loop_lanes
from repro_torch.kernels.spar_cost import ops, spar_cost
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (
    DEFAULT_BUCKETS,
    PAD_WEIGHT,
    GeometryCache,
    GWServer,
    ServeConfig,
    ServeMetrics,
    batch_signature,
    bucket_for,
    next_pow2,
    pad_geometry,
    pad_problem,
    percentiles,
)
from repro_torch.serve.batching import (
    MIN_LANES,
    GeneratorState,
    disarm_fault,
    stack_items,
)
from repro_torch.serve.lanes import lane_route, run_lanes
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse

VALUE_RTOL = 1e-5
VALS_ATOL, VALS_RTOL = 1e-6, 1e-4

BASE = DenseGWSolver(tol=1e-6, inner_tol=1e-8, outer_iters=10)
CLEAN = dataclasses.replace(BASE, max_rescues=0,
                            fault=FaultSpec(at_iter=-1, kind="nan"))
POISONED = dataclasses.replace(BASE, max_rescues=0,
                               fault=FaultSpec(at_iter=2, kind="nan"))
PERSISTENT = dataclasses.replace(
    BASE, max_rescues=0, fault=FaultSpec(at_iter=1, kind="nan",
                                         persistent=True))


def _cpu(**kw):
    return ServeConfig(max_wait_s=60.0, device="cpu", **kw)


def _cost(seed: int, n: int, scale: float = 1.0):
    x = np.random.default_rng(seed).standard_normal((n, 2)) * scale
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)


def _geom(seed: int, n: int, scale: float = 1.0) -> Geometry:
    return Geometry(_cost(seed, n, scale), np.full(n, 1 / n, np.float32))


def _problem(seed: int, m: int, n: int = None, **kw) -> QuadraticProblem:
    n = m if n is None else n
    return QuadraticProblem(_geom(seed, m), _geom(seed + 50, n, scale=1.2),
                            **kw)


def _fused(seed: int, m: int, n: int = None) -> QuadraticProblem:
    n = m if n is None else n
    M = np.random.default_rng(seed + 7).random((m, n)).astype(np.float32)
    return _problem(seed, m, n, M=M, fused_penalty=0.5)


def _ref_geom(seed: int, n: int, scale: float = 1.0):
    return repro.Geometry(jnp.asarray(_cost(seed, n, scale)),
                          jnp.full(n, 1 / n, jnp.float32))


def _ref_problem(seed: int, m: int, n: int = None, **kw):
    n = m if n is None else n
    return repro.QuadraticProblem(_ref_geom(seed, m),
                                  _ref_geom(seed + 50, n, scale=1.2), **kw)


FLT_MIN = float(np.finfo(np.float32).tiny)


def x64_prox_coupling(Cx, Cy, a, b, loss="l2", epsilon=1e-2, outer_iters=20,
                      inner_iters=50, M=None, alpha=1.0):
    """The reference's dense prox solve (``DenseGWSolver``'s stable step:
    ``dense_cost``, then ``sinkhorn_log`` on -C/ε + log T) in float64 with
    float32's flush: coupling entries below float32's smallest normal are
    0 and their log is -inf, as XLA gives them in float32. Without the
    flush a float64 run keeps entries that both float32 runs lose and is
    no reference for them (at 14 x 30 it lands at another value, 0.903
    against 1.184). Returns the coupling and the last cost."""
    from repro.core.gw import dense_cost as j_dense_cost
    from repro.core.sinkhorn import sinkhorn_log as j_sinkhorn_log

    with jax.enable_x64(True):
        Cx, Cy, a, b = (jnp.asarray(np.asarray(x, np.float64))
                        for x in (Cx, Cy, a, b))

        def flush(x):
            return jnp.where(jnp.abs(x) < FLT_MIN, 0.0, x)

        a, b = flush(a), flush(b)
        T = flush(a[:, None] * b[None, :])
        for _ in range(outer_iters):
            C = j_dense_cost(Cx, Cy, T, loss)
            if M is not None:
                C = alpha * C + (1 - alpha) * jnp.asarray(M, jnp.float64)
            logT = jnp.where(T >= FLT_MIN,
                             jnp.log(jnp.where(T > 0, T, 1.0)), -jnp.inf)
            T = flush(j_sinkhorn_log(a, b, -C / epsilon + logT,
                                     inner_iters))
        return np.asarray(T), np.asarray(C)


def prox_gap(T, T64, atol=VALS_ATOL):
    """The least rtol at ``atol`` that holds the coupling ``T`` to the
    float64 coupling ``T64`` (0 where ``atol`` alone holds it)."""
    over = np.abs(np.asarray(T, np.float64) - T64) - atol
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.where(over > 0, over / np.abs(T64), 0.0).max())


# A float32 dense prox coupling against the float64 solve, at atol 1e-6:
# set from readings (tests/torch_prox_readings.py, PERF.md §6), a few
# times the largest float32 reading and far below what a wrong coupling
# reads (the solve with ε 10% too large)
PROX_RTOL = 2e-3


def _bits(x, y) -> bool:
    """Equal shapes and values, NaN where the other has NaN."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return x.shape == y.shape and x.dtype == y.dtype and bool(
        torch.all((x == y) | (torch.isnan(x) & torch.isnan(y))))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=VALS_RTOL, atol=VALS_ATOL)


def _same(lane, solo):
    """A lane is its solo solve bit for bit: value, coupling, errors,
    trace, and the status, iteration count and convergence flag."""
    assert _bits(lane.value, solo.value)
    if isinstance(solo.coupling, torch.Tensor):
        assert _bits(lane.coupling, solo.coupling)
    else:
        assert all(_bits(x, y) for x, y in zip(lane.coupling, solo.coupling))
    assert _bits(lane.errors, solo.errors)
    assert (lane.n_iters, lane.converged) == (solo.n_iters, solo.converged)
    ls, ss = lane.status, solo.status
    assert (ls.code, ls.fail_iter, ls.n_rescues) == (
        ss.code, ss.fail_iter, ss.n_rescues)
    assert _bits(torch.tensor(ls.last_err), torch.tensor(ss.last_err))
    assert (lane.trace is None) == (solo.trace is None)
    if solo.trace is not None:
        assert all(_bits(x, y) for x, y in zip(lane.trace, solo.trace))


# ---------------------------------------------------------------------------
# bucket policy and padding
# ---------------------------------------------------------------------------

def test_bucket_policy_matches_reference():
    assert DEFAULT_BUCKETS == rserve.DEFAULT_BUCKETS
    sizes = list(range(1, 600)) + [1000, 1024, 1025, 2000, 4097]
    assert [bucket_for(n) for n in sizes] == [rserve.bucket_for(n)
                                             for n in sizes]
    custom = (10, 30)
    assert [bucket_for(n, custom) for n in range(1, 70)] == [
        rserve.bucket_for(n, custom) for n in range(1, 70)]
    with pytest.raises(ValueError):
        bucket_for(0)


def test_next_pow2_has_no_width_floor():
    # a lane's bits do not depend on the width of its flush, width 1
    # included (test_lane_bits_do_not_depend_on_the_width), so the port
    # drops the reference's floor of 2 and rounds as it does above it
    assert MIN_LANES == 1 and rserve.batching.MIN_LANES == 2
    assert next_pow2(1) == 1
    assert [next_pow2(n) for n in range(2, 20)] == [
        rserve.next_pow2(n) for n in range(2, 20)]


def test_pad_geometry_matches_reference():
    rng = np.random.default_rng(0)
    C = _cost(0, 14)
    w = np.full(14, 1 / 14, np.float32)
    pts = rng.random((14, 3)).astype(np.float32)
    feat = rng.random((14, 2)).astype(np.float32)
    got = pad_geometry(Geometry(C, w, features=feat, points=pts), 16)
    want = rserve.pad_geometry(repro.Geometry(C, w, features=feat,
                                              points=pts), 16)
    for name in ("cost", "weights", "features", "points"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    assert np.all(got.weights.numpy()[14:] == np.float32(PAD_WEIGHT))
    assert PAD_WEIGHT == rserve.PAD_WEIGHT
    assert np.float32(PAD_WEIGHT) > np.finfo(np.float32).tiny
    cloud = pad_geometry(Geometry.from_points(pts, w), 16)
    assert cloud.cost is None and tuple(cloud.points.shape) == (16, 3)


def test_pad_geometry_noop_at_size_and_rejects_overflow():
    g = _geom(0, 16)
    assert pad_geometry(g, 16) is g
    with pytest.raises(ValueError):
        pad_geometry(g, 12)


def test_pad_problem_pads_the_linear_term_like_reference():
    p = _fused(3, 13, 11)
    rp = repro.QuadraticProblem(_ref_geom(3, 13), _ref_geom(53, 11, 1.2),
                                M=jnp.asarray(p.M.numpy()),
                                fused_penalty=0.5)
    got, want = pad_problem(p, 16, 16), rserve.pad_problem(rp, 16, 16)
    assert np.array_equal(got.M.numpy(), np.asarray(want.M))
    assert got.shape == (16, 16) and got.fused_penalty == 0.5


def test_padded_solve_matches_unpadded_values():
    prob = _problem(0, 14)
    out_ref = repro_torch.solve(prob, CLEAN, device="cpu")
    out_pad = repro_torch.solve(pad_problem(prob, 16, 16), CLEAN,
                                device="cpu", validate=False)
    np.testing.assert_allclose(float(out_pad.value), float(out_ref.value),
                               rtol=1e-4)
    T_pad = out_pad.coupling.numpy()
    np.testing.assert_allclose(T_pad[:14, :14], out_ref.coupling.numpy(),
                               atol=5e-4)
    assert float(T_pad[14:, :].sum()) < 1e-6


# ---------------------------------------------------------------------------
# Geometry.content_hash
# ---------------------------------------------------------------------------

def _hash_cases():
    rng = np.random.default_rng(1)
    C = rng.random((8, 8)).astype(np.float32)
    w = np.full(8, 1 / 8, np.float32)
    pts = rng.random((8, 3)).astype(np.float32)
    feat = rng.random((8, 2)).astype(np.float32)
    return {"cost": ((C, w), {}),
            "cost_F_order": ((np.asfortranarray(C), w), {}),
            "point_cloud": ((None, w), {"points": pts}),
            "cost_and_points": ((C, w), {"points": pts}),
            "features": ((C, w), {"features": feat}),
            "cloud_and_features": ((None, w), {"points": pts,
                                               "features": feat})}


@pytest.mark.parametrize("case", sorted(_hash_cases()))
def test_content_hash_digest_equals_reference(case):
    args, kw = _hash_cases()[case]
    got = Geometry(*args, **kw).content_hash()
    assert got == repro.Geometry(*args, **kw).content_hash()
    assert got == Geometry(*args, **kw).content_hash()   # stable


def test_content_hash_sensitivity_and_memo():
    rng = np.random.default_rng(2)
    C = rng.random((8, 8)).astype(np.float32)
    w = np.full(8, 1 / 8, np.float32)
    g = Geometry(C, w)
    assert g.content_hash() is g.content_hash()
    w2 = w.copy()
    w2[0] += np.float32(1e-6)
    assert Geometry(C, w2, validate=False).content_hash() != g.content_hash()
    C2 = C.copy()
    C2[3, 4] += np.float32(1e-6)
    assert Geometry(C2, w).content_hash() != g.content_hash()
    # the port's Geometry holds float32: a float64 input is its float32
    assert Geometry(C.astype(np.float64), w).content_hash() == \
        g.content_hash()


def test_content_hash_point_cloud_never_materializes_cost(monkeypatch):
    p = np.random.default_rng(3).random((50, 3)).astype(np.float32)
    g = Geometry.from_points(p, np.full(50, 1 / 50, np.float32))

    def boom(self):
        raise AssertionError("content_hash materialized the n x n cost")

    monkeypatch.setattr(Geometry, "cost_matrix", property(boom))
    assert isinstance(g.content_hash(), str)


def test_content_hash_refuses_a_tensor_that_requires_grad():
    C = torch.tensor(_cost(0, 8), requires_grad=True)
    g = Geometry(C, torch.full((8,), 1 / 8), validate=False)
    with pytest.raises(ValueError, match="require"):
        g.content_hash()


# ---------------------------------------------------------------------------
# batch signatures: the reference's grouping
# ---------------------------------------------------------------------------

def _request_pairs():
    """(port item, reference item) for a mixed request set."""
    eps_half = dict(epsilon=5e-3)
    cases = [
        # (m, n, loss, bucket, fused, solver fields, solver name, generator)
        (14, 14, "l2", 16, False, dict(fault=dict(at_iter=-1)), "dense", 0),
        (12, 13, "l2", 16, False, dict(fault=dict(at_iter=2)), "dense", 0),
        (14, 14, "l2", 16, False, dict(fault=dict(at_iter=2,
                                                  persistent=True)),
         "dense", 0),
        (14, 14, "l1", 16, False, dict(fault=dict(at_iter=-1)), "dense", 0),
        (14, 14, "l2", 16, False, dict(fault=dict(at_iter=-1),
                                       outer_iters=11), "dense", 0),
        (14, 14, "l2", 16, False, dict(fault=dict(at_iter=-1), **eps_half),
         "dense", 0),
        (20, 14, "l2", 24, False, dict(fault=dict(at_iter=-1)), "dense", 0),
        (14, 14, "l2", 16, False, {}, "dense", 0),
        (14, 14, "l2", 16, False, {}, "dense", 1),
        (14, 14, "l2", 16, True, {}, "dense", 0),
        (14, 14, "l2", 16, False, dict(s=256), "spar", 1),
        (13, 15, "l2", 16, False, dict(s=256, **eps_half), "spar", 1),
        (14, 14, "l2", 16, False, dict(s=512), "spar", 1),
    ]
    pairs = []
    for k, (m, n, loss, nb, fused, fields, name, gen) in enumerate(cases):
        mb = bucket_for(m)
        extra, rextra = {}, {}
        if fused:
            M = np.random.default_rng(k).random((m, n)).astype(np.float32)
            extra = rextra = dict(fused_penalty=0.5)
            extra, rextra = dict(extra, M=M), dict(rextra, M=jnp.asarray(M))
        p = pad_problem(_problem(k, m, n, loss=loss, **extra), mb, nb)
        rp = rserve.pad_problem(_ref_problem(k, m, n, loss=loss, **rextra),
                                mb, nb)
        pf = dict(fields)
        rf = dict(fields)
        if "fault" in fields:
            pf["fault"] = FaultSpec(**fields["fault"])
            rf["fault"] = repro.health.FaultSpec(
                **dict(fields["fault"], at_iter=jnp.int32(
                    fields["fault"]["at_iter"])))
        solver = (DenseGWSolver if name == "dense" else SparGWSolver)(**pf)
        rsolver = (repro.DenseGWSolver if name == "dense"
                   else repro.SparGWSolver)(**rf)
        pairs.append(((p, solver, GeneratorState.of(_gen(k)) if gen
                       else None),
                      (rp, rsolver, jax.random.PRNGKey(k) if gen else None)))
    return pairs


def _groups(signatures):
    seen = {}
    return [seen.setdefault(sig, len(seen)) for sig in signatures]


def test_batch_signature_groups_requests_as_the_reference_does():
    pairs = _request_pairs()
    got = _groups([batch_signature(p) for p, _ in pairs])
    want = _groups([rserve.batch_signature(r) for _, r in pairs])
    assert got == want
    # CLEAN and POISONED share a bucket; epsilon is a leaf, so a solver
    # that differs only in it does too
    assert got[0] == got[1] == got[5]
    assert len(set(got)) >= 9


def test_disarm_fault_keeps_the_signature():
    item = (pad_problem(_problem(0, 14), 16, 16), POISONED, None)
    filler = (item[0], disarm_fault(POISONED), None)
    assert filler[1].fault.at_iter == -1
    assert batch_signature(item) == batch_signature(filler)
    assert disarm_fault(BASE) is BASE


# ---------------------------------------------------------------------------
# GeometryCache
# ---------------------------------------------------------------------------

def test_cache_counters_and_artifact_reuse():
    cache = GeometryCache(8)
    g = _geom(0, 14)
    a1 = cache.padded(g, 16)
    assert cache.padded(g, 16) is a1
    assert (cache.hits, cache.misses) == (1, 1)
    g2 = Geometry(g.cost.clone(), g.weights.clone())   # same content
    assert cache.padded(g2, 16) is a1
    assert cache.hits == 2


def test_cache_lru_eviction_counts_like_reference():
    def run(cache, geoms):
        for g in geoms:
            cache.padded(g, 16)
        cache.padded(geoms[0], 16)
        return cache.stats()

    got = run(GeometryCache(2), [_geom(s, 12) for s in range(3)])
    want = run(rserve.GeometryCache(2), [_ref_geom(s, 12) for s in range(3)])
    assert got == want
    assert got["evictions"] == 2 and got["misses"] == 4


def test_cache_lowrank_factors_and_anchors():
    pts = np.random.default_rng(4).random((12, 2)).astype(np.float32)
    g = Geometry.from_points(pts, np.full(12, 1 / 12, np.float32))
    cache = GeometryCache(8)
    fac = cache.lowrank_factors(g)
    np.testing.assert_allclose(fac.todense().numpy(), g.cost_matrix.numpy(),
                               atol=1e-5)
    idx1 = cache.anchors(g, 4)
    idx2 = GeometryCache(8).anchors(g, 4)   # fresh cache, same geometry
    assert all(_bits(x, y) for x, y in zip(idx1, idx2))
    assert tuple(idx1.indices.shape) == (4,)
    with pytest.raises(ValueError, match="point-cloud"):
        cache.lowrank_factors(_geom(0, 8))


def test_cache_warm_populates_all_artifacts():
    pts = np.random.default_rng(5).random((10, 2)).astype(np.float32)
    g = Geometry.from_points(pts, np.full(10, 1 / 10, np.float32))
    cache = GeometryCache(8)
    cache.warm(g, buckets=(16, 24), k=3)
    assert len(cache) == 4 and cache.hits == 0
    cache.warm(g, buckets=(16, 24), k=3)
    assert cache.hits == 4
    cache.reset_counters()
    assert cache.stats()["hits"] == 0 and len(cache) == 4


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_percentiles_match_reference():
    samples = list(np.random.default_rng(6).random(101))
    assert percentiles(samples) == rserve.percentiles(samples)
    assert all(math.isnan(v) for v in percentiles([]).values())


def test_summary_keys_match_reference():
    got, want = ServeMetrics(), rserve.ServeMetrics()
    for m in (got, want):
        t = m.record_submit()
        m.record_batch(1, 2)
        m.record_result(t, t, failed=False, fell_back=False)
    g = got.summary(GeometryCache(2).stats())
    w = want.summary(rserve.GeometryCache(2).stats())
    assert sorted(g) == sorted(w)
    for k in ("n_submitted", "n_completed", "n_batches", "mean_batch_lanes",
              "filler_lane_frac", "cache_hit_rate"):
        assert g[k] == w[k], k


# ---------------------------------------------------------------------------
# the server against the reference server
# ---------------------------------------------------------------------------

def test_server_matches_reference_server():
    """Values within rtol 1e-5 and couplings within atol 1e-6 + rtol 1e-4
    of the reference server's, the same padded shapes and batches.

    The served lanes are the port's solo solves bit for bit, so this holds
    the solo dense solve to the reference's. Every coupling of both
    servers is also held to the reference's solve of the padded problem
    in float64 with float32's flush (:func:`x64_prox_coupling`) at atol
    1e-6 + rtol ``PROX_RTOL``. The last two couplings are held that way
    only: after 20 prox steps they are off each other past the direct
    bound in 2 of 768 entries (28 x 20: 1.9e-6 at a 2.0e-3 entry; 14 x 30:
    2.5e-6 at a 6.4e-4 entry). The cause is measured, not a drift of one
    side: from the same iterate, one step of either side lands as near the
    float64 step (its cost off by <= 5e-6 of |C| <= 12, divided by
    ε = 1e-2), and the prox term log T carries each step's rounding
    forward undamped, so the two fp32 trajectories part by the sum of
    their steps' roundings. Against the float64 solve the 28 x 20 port
    coupling needs rtol 4.0e-4 at atol 1e-6 and every other side none;
    the solve with ε 10% too large reads 0.70 or more on every shape
    (tests/torch_prox_readings.py, PERF.md §6)."""
    solver = DenseGWSolver()
    sizes = [(12, 14), (13, 16), (20, 14), (14, 14), (28, 20), (14, 30)]
    coupling_held = 4
    srv = GWServer(_cpu(max_batch=4, on_failure="none"))
    ref = rserve.GWServer(rserve.ServeConfig(max_batch=4, max_wait_s=60.0,
                                             on_failure="none"))
    try:
        got = srv.results([srv.submit(_problem(k, m, n), solver)
                           for k, (m, n) in enumerate(sizes)])
        want = ref.results([ref.submit(_ref_problem(k, m, n),
                                       repro.DenseGWSolver())
                            for k, (m, n) in enumerate(sizes)])
    finally:
        srv.close()
        ref.close()
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.padded_shape == w.padded_shape and g.shape == w.shape
        np.testing.assert_allclose(g.value, w.value, rtol=VALUE_RTOL)
        if k < coupling_held:
            _close(g.coupling_dense(), w.coupling_dense())
        m, n = sizes[k]
        padded = rserve.pad_problem(_ref_problem(k, m, n), *g.padded_shape)
        T64, _ = x64_prox_coupling(
            np.asarray(padded.geom_x.cost), np.asarray(padded.geom_y.cost),
            np.asarray(padded.geom_x.weights),
            np.asarray(padded.geom_y.weights))
        for side in (g, w):
            np.testing.assert_allclose(side.coupling_dense(), T64[:m, :n],
                                       rtol=PROX_RTOL, atol=VALS_ATOL)
        assert g.status_name == w.status_name and not g.failed
    assert srv.stats()["n_batches"] == ref.stats()["n_batches"] == 4


def test_server_results_match_solo_solves():
    srv = GWServer(_cpu(max_batch=4, on_failure="none"))
    probs = [_problem(s, 12 + s) for s in range(3)]
    try:
        res = srv.results([srv.submit(p, CLEAN) for p in probs])
    finally:
        srv.close()
    for r, p in zip(res, probs):
        _same(r.output, CLEAN.run(pad_problem(p, 16, 16)))
        assert r.coupling_dense().shape == p.shape


# ---------------------------------------------------------------------------
# lane isolation and width invariance
# ---------------------------------------------------------------------------

def test_poisoned_lane_isolated_and_mates_bitwise_solo():
    probs = [_problem(s, 14) for s in (0, 1, 2, 5)]
    solvers = [CLEAN, POISONED, CLEAN, CLEAN]
    srv = GWServer(_cpu(max_batch=4, on_failure="none"))
    solo_srv = GWServer(_cpu(max_batch=4, on_failure="none"))
    try:
        res = srv.results([srv.submit(p, s) for p, s in zip(probs, solvers)])
        assert res[1].status_name == "DIVERGED" and res[1].failed
        assert srv.stats()["n_batches"] == 1
        for i in (0, 2, 3):
            solo = solo_srv.result(solo_srv.submit(probs[i], CLEAN))
            assert not res[i].failed
            assert _bits(res[i].output.value, solo.output.value)
            assert _bits(res[i].output.coupling, solo.output.coupling)
    finally:
        srv.close()
        solo_srv.close()


def test_filler_lanes_do_not_change_request_bits():
    """Lane 0 is the poisoned, diverging request: alone (one lane), and
    beside two real requests and a filler lane (a disarmed replica of
    lane 0), it keeps the same bits."""
    prob = _problem(3, 13)
    solo_srv = GWServer(_cpu(max_batch=8, on_failure="none"))
    trio_srv = GWServer(_cpu(max_batch=3, on_failure="none"))
    try:
        solo = solo_srv.result(solo_srv.submit(prob, POISONED))
        rids = [trio_srv.submit(prob, POISONED),
                trio_srv.submit(_problem(8, 15), CLEAN),
                trio_srv.submit(_problem(9, 16), CLEAN)]
        trio = trio_srv.results(rids)
        assert trio_srv.stats()["filler_lane_frac"] == 0.25
    finally:
        solo_srv.close()
        trio_srv.close()
    assert solo.status_name == trio[0].status_name == "DIVERGED"
    _same(trio[0].output, solo.output)
    assert [r.status_name for r in trio[1:]] == ["MAXITER", "MAXITER"]


def _lanes(items):
    return run_lanes(stack_items(items))


@pytest.mark.parametrize("family", ["dense", "spar"])
def test_lane_bits_do_not_depend_on_the_width(family):
    probs = [pad_problem(_problem(s, 20 + s, 30), 24, 32) for s in range(4)]
    if family == "dense":
        items = [(p, DenseGWSolver(), None) for p in probs]
        solo = DenseGWSolver().run(probs[0])
    else:
        items = [(p, SparGWSolver(s=512), GeneratorState.of(_gen(10 + k)))
                 for k, p in enumerate(probs)]
        solo = SparGWSolver(s=512).run(probs[0], generator=_gen(10))
    for B in (1, 2, 3, 4):
        _same(_lanes(items[:B])[0], solo)


# ---------------------------------------------------------------------------
# lane-batched solves against solo solves
# ---------------------------------------------------------------------------

_DENSE_CASES = {
    "l2": (dict(), "l2", False),
    "l1": (dict(outer_iters=5), "l1", False),
    "kl": (dict(outer_iters=5), "kl", False),
    "fused": (dict(), "l2", True),
    "plain": (dict(stable=False, epsilon=5e-2), "l2", False),
    "tol": (dict(tol=1e-5, inner_tol=1e-7, outer_iters=40), "l2", False),
    "ent": (dict(reg="ent", epsilon=5e-2), "l2", False),
}


@pytest.mark.parametrize("case", sorted(_DENSE_CASES))
def test_dense_lanes_match_solo_solves(case):
    fields, loss, fused = _DENSE_CASES[case]
    make = _fused if fused else (lambda s, m, n: _problem(s, m, n,
                                                          loss=loss))
    probs = [pad_problem(make(s, 10 + 2 * s, 12), 16, 16) for s in range(3)]
    # epsilon is a leaf: each lane may carry its own
    solvers = [DenseGWSolver(**dict(fields, epsilon=fields.get(
        "epsilon", 1e-2) * (1 + 0.5 * k))) for k in range(3)]
    assert lane_route(probs[0], solvers[0]) == "dense"
    outs = _lanes([(p, s, None) for p, s in zip(probs, solvers)])
    for out, p, s in zip(outs, probs, solvers):
        _same(out, s.run(p))


_SPAR_CASES = {
    "l2": (dict(), "l2", False),
    "l1": (dict(outer_iters=5), "l1", False),
    "fused": (dict(), "l2", True),
    "plain": (dict(stable=False, epsilon=5e-2), "l2", False),
    "inner_tol": (dict(inner_tol=1e-6, inner_iters=200), "l2", False),
    "tol": (dict(tol=1e-4, outer_iters=30), "l2", False),
    "jnp": (dict(cost_impl="jnp"), "l2", False),
}


@pytest.mark.parametrize("case", sorted(_SPAR_CASES))
def test_spar_lanes_match_solo_solves_on_the_same_generator_state(case):
    fields, loss, fused = _SPAR_CASES[case]
    make = _fused if fused else (lambda s, m, n: _problem(s, m, n,
                                                          loss=loss))
    probs = [pad_problem(make(s, 12 + 3 * s, 20), 24, 24) for s in range(3)]
    solver = SparGWSolver(s=16 * 24, **fields)
    states = [GeneratorState.of(_gen(20 + k)) for k in range(3)]
    outs = _lanes([(p, solver, st) for p, st in zip(probs, states)])
    for out, p, st in zip(outs, probs, states):
        _same(out, solver.run(p, generator=st.restore()))


def test_spar_lanes_launch_k1_once_a_step_for_the_flush():
    """On the CPU the wrapper runs its plain version and counts nothing;
    the materialized lanes closure takes one (B, s) call a step, so the
    card launches K1 once a step for all lanes (chip_smoke phase 4g
    counts the launches)."""
    probs = [pad_problem(_problem(s, 14, 16), 16, 16) for s in range(3)]
    solver = SparGWSolver(s=256, outer_iters=4)
    calls = []
    real = ops.spar_matvec_cuda

    def counting(Lmat, t, off, threads=256):
        calls.append(tuple(t.shape))
        return real(Lmat, t, off, threads=threads)

    ops.spar_matvec_cuda = counting
    try:
        _lanes([(p, solver, GeneratorState.of(_gen(k)))
                for k, p in enumerate(probs)])
    finally:
        ops.spar_matvec_cuda = real
    assert calls == [(3, 256)] * (solver.outer_iters + 1)


@pytest.mark.parametrize("route", ["unbalanced", "grid"])
def test_other_families_run_lane_by_lane(route):
    if route == "unbalanced":
        probs = [pad_problem(_problem(s, 14, lam=1.0), 16, 16)
                 for s in range(2)]
        solver = SparGWSolver(s=256, outer_iters=5)
    else:
        probs = [pad_problem(_problem(s, 14), 16, 16) for s in range(2)]
        solver = repro_torch.GridGWSolver(s_r=8, s_c=8, outer_iters=5)
    assert lane_route(probs[0], solver) == "sequential"
    states = [GeneratorState.of(_gen(k)) for k in range(2)]
    outs = _lanes([(p, solver, st) for p, st in zip(probs, states)])
    for out, p, st in zip(outs, probs, states):
        _same(out, solver.run(p, generator=st.restore()))


# ---------------------------------------------------------------------------
# the lane loop against health_loop, lane by lane
# ---------------------------------------------------------------------------

_FAULTS = {
    "nan_iterate": ("nan", "iterate", False, [3, -1, 0]),
    "overflow_cost": ("overflow", "cost", False, [2, 5, -1]),
    "zero_persistent": ("zero", "iterate", True, [4, -1, 7]),
    "inf_cost_persistent": ("inf", "cost", True, [-1, 1, 3]),
}


@pytest.mark.parametrize("case", sorted(_FAULTS))
def test_lane_loop_matches_health_loop_lane_by_lane(case):
    """Statuses, iteration counts, rescues, errors and traces of each lane
    against the solo loop on the same lane (dense solver, traced, two
    rescues, a fault per lane)."""
    kind, site, persistent, ats = _FAULTS[case]
    probs = [pad_problem(_problem(s, 12 + s), 16, 16) for s in range(3)]
    solvers = [DenseGWSolver(outer_iters=10, max_rescues=2, trace=True,
                             tol=1e-6, fault=FaultSpec(at, kind, site,
                                                       persistent))
               for at in ats]
    outs = _lanes([(p, s, None) for p, s in zip(probs, solvers)])
    for out, p, s in zip(outs, probs, solvers):
        _same(out, s.run(p))


def test_lane_loop_reads_the_host_once_an_iteration():
    """One ``.tolist()`` of the lanes' verdicts a step (plus one for the
    last errors at the end), however many lanes."""
    B, iters = 5, 7
    T0 = torch.rand(B, 4, 3) + 0.1
    reads = []
    real = torch.Tensor.tolist

    def counting(self):
        reads.append(tuple(self.shape))
        return real(self)

    torch.Tensor.tolist = counting
    try:
        res = health_loop_lanes(lambda T, scale: T * 0.9,
                                lambda T: T.sum(dim=(1, 2)), T0, iters, 0.0)
    finally:
        torch.Tensor.tolist = real
    assert reads == [(2, B)] * iters + [(B,)]
    for b, r in enumerate(res):
        solo = health_loop(lambda T, scale: T * 0.9, lambda T: T.sum(),
                           T0[b], iters, 0.0, scaled_step=True)
        assert _bits(r.iterate, solo.iterate)
        assert r.n_iters == solo.n_iters and r.status == solo.status


# ---------------------------------------------------------------------------
# per-request fallback
# ---------------------------------------------------------------------------

def test_poisoned_request_falls_back_from_its_generator_state():
    """A persistent fault on a spar lane: the request falls back solo from
    the generator state recorded at submit (the ladder of a fused problem:
    quantized, then dense), bitwise what a solo fallback solve from that
    state gives; the caller's generator is not advanced; mates stay on
    the batched path."""
    persistent = SparGWSolver(s=256, max_rescues=0, fault=FaultSpec(
        at_iter=1, kind="nan", persistent=True))
    clean = dataclasses.replace(persistent, fault=FaultSpec(
        at_iter=-1, kind="nan", persistent=True))
    probs = [_fused(s, 14) for s in (0, 1)]
    gens = [_gen(100), _gen(101)]
    before = [g.get_state().clone() for g in gens]
    srv = GWServer(_cpu(max_batch=2))
    try:
        res = srv.results([srv.submit(p, s, generator=g) for p, s, g in
                           zip(probs, (clean, persistent), gens)])
        assert srv.stats()["n_batches"] == 1
        assert srv.stats()["n_fallbacks"] == 1
    finally:
        srv.close()
    assert all(torch.equal(g.get_state(), b) for g, b in zip(gens, before))
    assert res[1].failed and res[1].fell_back
    assert res[1].status.code < 2 and math.isfinite(res[1].value)
    assert res[1].coupling_dense().shape == (14, 14)
    want = repro_torch.solve(probs[1], persistent, generator=_gen(101),
                             device="cpu", on_failure="fallback")
    assert res[1].value == float(want.value)
    assert not res[0].failed and not res[0].fell_back
    _same(res[0].output, clean.run(pad_problem(probs[0], 16, 16),
                                   generator=_gen(100)))


def test_keyless_dense_fallback_returns_batched_output():
    srv = GWServer(_cpu(max_batch=2))
    try:
        res = srv.result(srv.submit(_problem(0, 14), PERSISTENT))
    finally:
        srv.close()
    assert res.failed and not res.fell_back
    assert res.status_name == "DIVERGED"


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_server_lifecycle_poll_and_stats():
    srv = GWServer(_cpu(max_batch=8, on_failure="none"))
    try:
        rid = srv.submit(_problem(0, 14), CLEAN)
        assert srv.poll(rid) == "queued"
        srv.flush()
        assert srv.poll(rid) in ("running", "done")
        res = srv.result(rid)
        assert srv.poll(rid) == "done"
        assert res is srv.result(rid)            # idempotent
        stats = srv.stats()
        assert stats["n_completed"] == 1 and stats["n_batches"] == 1
        assert stats["mean_batch_lanes"] == MIN_LANES   # no filler lane
        assert np.isfinite(stats["latency_p99_ms"])
        assert "repro_serve_requests_total" in srv.metrics_text()
        srv.reset_stats()
        assert srv.stats()["n_completed"] == 0
        with pytest.raises(KeyError):
            srv.result(999)
    finally:
        srv.close()


def test_submit_never_waits_on_a_solve():
    """A full bucket is handed to the worker: submit returns while the
    flush may still be running, and result waits for it."""
    srv = GWServer(_cpu(max_batch=2, on_failure="none"))
    try:
        solver = DenseGWSolver(outer_iters=40, inner_iters=200)
        rids = [srv.submit(_problem(s, 60), solver) for s in range(2)]
        assert all(srv._requests[r].state == "running" for r in rids)
        assert all(srv.result(r).status_name == "MAXITER" for r in rids)
    finally:
        srv.close()


def test_flusher_honors_max_wait_without_a_call():
    srv = GWServer(ServeConfig(max_batch=8, max_wait_s=0.05, device="cpu",
                               on_failure="none"))
    try:
        rid = srv.submit(_problem(0, 14), CLEAN)
        deadline = time.perf_counter() + 10.0
        while (srv.metrics.n_batches == 0
               and time.perf_counter() < deadline):
            time.sleep(0.01)          # no server call in the meantime
        assert srv.metrics.n_batches == 1
        assert srv.result(rid).status_name == "MAXITER"
    finally:
        srv.close()
    assert srv._flusher is None and srv._worker is None


def test_closed_server_still_serves_queued_requests():
    srv = GWServer(_cpu(max_batch=8, on_failure="none",
                        flush_thread=False))
    rid = srv.submit(_problem(0, 14), CLEAN)
    srv.close()
    srv.close()                                # idempotent
    assert srv.result(rid).status_name == "MAXITER"


def test_server_multi_bucket_routing():
    srv = GWServer(_cpu(max_batch=8, on_failure="none"))
    try:
        res = srv.results([srv.submit(_problem(s, n), CLEAN)
                           for s, n in enumerate((12, 20, 14, 28))])
        assert [r.padded_shape for r in res] == [(16, 16), (24, 24),
                                                 (16, 16), (32, 32)]
        assert srv.stats()["n_batches"] == 3
    finally:
        srv.close()


def test_submit_and_config_validation():
    srv = GWServer(_cpu())
    try:
        with pytest.raises(ValueError, match="generator"):
            srv.submit(_problem(0, 14), "spar_gw")
    finally:
        srv.close()
    with pytest.raises(ValueError):
        ServeConfig(on_failure="retry")
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)


# ---------------------------------------------------------------------------
# K1's lane axis (plain version on the CPU) and the launcher
# ---------------------------------------------------------------------------

def test_matvec_lanes_plain_and_backward():
    rng = np.random.default_rng(7)
    L = torch.tensor(rng.random((3, 33, 33)), dtype=torch.float32)
    t = torch.tensor(rng.random((3, 33)) - 0.5, dtype=torch.float32)
    off = torch.tensor(rng.random((3, 33)), dtype=torch.float32)
    got = spar_cost.spar_matvec_cuda(L, t, off)
    want = torch.stack([L[b] @ t[b] + off[b] for b in range(3)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    ins = [x.clone().requires_grad_(True) for x in (L, t, off)]
    ref = [x.clone().requires_grad_(True) for x in (L, t, off)]
    w = torch.tensor(rng.random((3, 33)), dtype=torch.float32)
    out = spar_cost.spar_matvec_cuda(*ins)
    assert "SparMatvec" in type(out.grad_fn).__name__
    g = torch.autograd.grad((out * w).sum(), ins)
    g_ref = torch.autograd.grad(
        (torch.stack([ref[0][b] @ ref[1][b] + ref[2][b]
                      for b in range(3)]) * w).sum(), ref)
    for x, y in zip(g, g_ref):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_materialized_lanes_keep_every_lane_aligned():
    probs = [_problem(s, 9, 7) for s in range(3)]
    rng = np.random.default_rng(8)
    rows = torch.tensor(rng.integers(0, 9, (3, 5)))
    cols = torch.tensor(rng.integers(0, 7, (3, 5)))
    Lmat = ops.materialize_lanes([p.geom_x.cost for p in probs],
                                 [p.geom_y.cost for p in probs], rows, cols,
                                 "l2")
    assert Lmat.stride() == (28, 5, 1)         # 25 floats rounded up to 28
    for b, p in enumerate(probs):
        want = ops.materialize_loss(p.geom_x.cost, p.geom_y.cost, rows[b],
                                    cols[b], "l2")
        assert torch.equal(Lmat[b], want)


def test_launch_serve_runs_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--requests", "4"])
    out = buf.getvalue()
    assert out.count("rid=") == 4 and "n_completed = 4" in out
    # --mode lm runs every architecture (tests/test_torch_decode.py) but
    # the two on which the reference's lm_main fails, which raise
    with pytest.raises(ValueError, match="reference's lm_main fails"):
        launch_serve.main(["--mode", "lm", "--arch", "musicgen-medium",
                           "--device", "cpu"])
