"""The plain reference against ``repro_torch`` at small sizes on the CPU,
and its control (the reference in TF32 in the program's place), which has
to come out not correct."""
import numpy as np
import pytest
import torch

from portbench import readings
from portbench.data import moon
from portbench.reference import spar_gw as reference


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    Cx = moon.distance_matrix(moon.moon_points(n, rng), "cpu")
    Cy = moon.distance_matrix(moon.moon_points(n, rng), "cpu")
    a = torch.as_tensor(moon.moon_weights(n, 1 / 3))
    b = torch.as_tensor(moon.moon_weights(n, 1 / 2))
    return Cx, Cy, a, b


@pytest.mark.parametrize("n,s_per_n,outer,inner", [(96, 4, 4, 10),
                                                   (300, 2, 20, 50)])
def test_reference_matches_the_program(n, s_per_n, outer, inner):
    from repro_torch import Geometry, QuadraticProblem, SparGWSolver, solve
    Cx, Cy, a, b = _pair(n, 3)
    settings = dict(s=s_per_n * n, reg="prox", epsilon=0.01,
                    outer_iters=outer, inner_iters=inner, max_rescues=2,
                    rescue_factor=2.0)
    seed = 2**40 + 17
    out = solve(QuadraticProblem(Geometry(Cx, a), Geometry(Cy, b)),
                SparGWSolver(**settings),
                generator=torch.Generator().manual_seed(seed), device="cpu")
    ref = reference.solve(Cx, Cy, a, b, seed, settings)
    assert torch.equal(out.coupling.rows, ref.rows)
    assert torch.equal(out.coupling.cols, ref.cols)
    assert (int(out.status.code), int(out.n_iters)) == (ref.status,
                                                        ref.n_iters)
    assert abs(float(out.value) - ref.value) <= 1e-4 * abs(ref.value)
    err = (out.coupling.vals.double() - ref.T).abs().sum() / ref.T.sum()
    assert float(err) <= 1e-4


def test_l2_cost_by_dense_products_is_the_sum_of_terms():
    Cx, Cy, a, b = _pair(40, 5)
    rows, cols = reference.draw_support(a, b, 300, 9)
    t = torch.rand(300, dtype=torch.float64)
    cost = reference._L2Cost(Cx.double(), Cy.double(), rows, cols, False)
    Lmat = (Cx.double()[rows][:, rows] - Cy.double()[cols][:, cols]) ** 2
    assert torch.allclose(cost(t), Lmat @ t, rtol=1e-12, atol=1e-12)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 0.0])
    got = reference.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, -3.0, 0.0]


@pytest.mark.parametrize("name", ["server-moon2048-c2x28",
                                  "lib-moon8192-solve"])
def test_control_is_not_correct_and_the_program_is(bench, small_cell, name):
    cell = small_cell(name)
    got = readings.readings(bench, name, 2**31 + 3, 4, "cpu", cell)
    limits = cell.config["limits"]
    assert all(got["program"][k] <= limits[k] for k in limits), got
    assert any(got["control"][k] > limits[k] for k in limits), got
