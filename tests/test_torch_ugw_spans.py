"""The spans of an unbalanced SPAR-GW solve (Alg. 3) on the CPU.

The unbalanced path records, under its ``solve.dispatch``, the balanced
path's ``solver.*`` spans (one ``solver.sample``, one
``solver.cost_build``, one ``solver.cost`` and one ``solver.sinkhorn`` an
outer step, one ``solver.value``) and ``solver.ugw_init`` around its dense
init, and the dispatch's ``sub`` roll-up counts them. Spans time the host
only: the solve with its spans gives bit for bit what the same solve with
every span of ``api/solvers.py`` made a no-op gives.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import obs
from repro_torch.api import solvers

N = 40
ONCE = ("solver.ugw_init", "solver.sample", "solver.cost_build",
        "solver.value")
A_STEP = ("solver.cost", "solver.sinkhorn", "solver.check")


def _problem(n=N, seed=0, lam=1.0):
    rng = np.random.default_rng(seed)
    x, y = rng.normal(size=(n, 2)), rng.normal(size=(n, 3))
    Cx = torch.as_tensor(np.linalg.norm(x[:, None] - x[None], axis=-1),
                         dtype=torch.float32)
    Cy = torch.as_tensor(np.linalg.norm(y[:, None] - y[None], axis=-1),
                         dtype=torch.float32)
    a = torch.as_tensor(rng.random(n) + 0.1, dtype=torch.float32)
    b = torch.as_tensor(rng.random(n) + 0.1, dtype=torch.float32)
    return repro_torch.QuadraticProblem(
        repro_torch.Geometry(Cx, a / a.sum()),
        repro_torch.Geometry(Cy, 0.8 * b / b.sum()), lam=lam)


def _solve(k, support=None):
    sv = repro_torch.SparGWSolver(s=8 * N, outer_iters=k, inner_iters=10)
    gen = None if support is not None else torch.Generator().manual_seed(5)
    return repro_torch.solve(_problem(), sv, generator=gen, support=support,
                             device="cpu")


@pytest.mark.parametrize("k", [3, 6])
def test_unbalanced_solve_spans_under_the_dispatch(k):
    obs.clear_spans()
    _solve(k)
    records = obs.spans()
    (dispatch,) = [r for r in records if r["name"] == "solve.dispatch"]
    by_id = {r["id"]: r for r in records}
    mine = [r for r in records if r["name"].startswith("solver.")]
    for r in mine:                      # each lies under the dispatch
        up = r
        while up["id"] != dispatch["id"]:
            up = by_id[up["parent_id"]]
    count = {name: sum(r["name"] == name for r in mine)
             for name in {r["name"] for r in mine}}
    for name in ONCE:
        assert count[name] == 1, name
    for name in A_STEP:
        assert count[name] == k, name
    # the solver's own spans open straight under the dispatch
    for r in mine:
        if r["name"] in ONCE + ("solver.cost", "solver.sinkhorn"):
            assert r["parent"] == "solve.dispatch", r
    (build,) = [r for r in mine if r["name"] == "solver.cost_build"]
    assert build["route"] == "plain"            # no kernel runs on the CPU
    for name, n in count.items():
        c, seconds = dispatch["sub"][name]
        assert c == n
        assert seconds == pytest.approx(sum(
            r["duration_s"] for r in mine if r["name"] == name))


@contextlib.contextmanager
def _no_span(name, **attrs):
    yield {}


@pytest.mark.parametrize("injected", [False, True])
def test_spans_change_no_bit_of_the_unbalanced_solve(monkeypatch,
                                                     injected):
    """Value, support, coupling and errors with the spans equal, bit for
    bit, those of the solve whose spans in ``api/solvers.py`` do nothing
    (the path as it ran before it had spans), drawn or injected."""
    support = None
    if injected:
        gen = torch.Generator().manual_seed(11)
        support = (torch.randint(0, N, (8 * N,), generator=gen),
                   torch.randint(0, N, (8 * N,), generator=gen))
    spanned = _solve(4, support)
    monkeypatch.setattr(solvers, "span", _no_span)
    plain = _solve(4, support)
    assert torch.isfinite(spanned.value)
    for x, y in ((spanned.value, plain.value),
                 (spanned.coupling.rows, plain.coupling.rows),
                 (spanned.coupling.cols, plain.coupling.cols),
                 (spanned.coupling.vals, plain.coupling.vals),
                 (spanned.errors, plain.errors)):
        assert torch.equal(x, y)
    assert (spanned.status.code, spanned.n_iters) == (plain.status.code,
                                                      plain.n_iters)
