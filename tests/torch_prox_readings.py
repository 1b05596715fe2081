"""Readings behind ``PROX_RTOL``: how far float32 dense prox couplings lie
from the float64 solve, and how far a wrong coupling lies.

For every problem it prints the least rtol at atol 1e-6 that holds a
coupling to :func:`test_torch_serve.x64_prox_coupling` (0 where atol
alone holds it), for four float32 runs of the same algorithm: the port's
solve, the reference's solve, and the reference's steps run op by op
(eager) and as one jitted ``fori_loop``, which XLA compiles to other
roundings. And the same reading for a wrong coupling: the float64 solve
with ε 10% too large. The problems are the six padded serve shapes of
``test_server_matches_reference_server``, the ``gw_dense`` shim's
problem of ``test_torch_legacy.py`` and twelve random ones. Runs on the
CPU in about ten minutes:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_prox_readings.py
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np

import repro
import repro.serve as rserve
from repro.core.gw import dense_cost as j_dense_cost
from repro.core.sinkhorn import sinkhorn_log as j_sinkhorn_log
import repro_torch
from repro_torch.serve import GWServer
from test_torch_serve import (
    _cpu,
    _problem,
    _ref_problem,
    prox_gap,
    x64_prox_coupling,
)

SERVE_SIZES = [(12, 14), (13, 16), (20, 14), (14, 14), (28, 20), (14, 30)]


def _ref_steps(Cx, Cy, a, b, outer_iters=20, inner_iters=50, epsilon=1e-2):
    """The reference's prox steps (``DenseGWSolver._run_balanced``'s stable
    step) in float32, op by op and as one jitted ``fori_loop``."""
    Cx, Cy, a, b = (jnp.asarray(x, jnp.float32) for x in (Cx, Cy, a, b))

    def step(T, eps):
        logK = -j_dense_cost(Cx, Cy, T, "l2") / eps + jnp.log(
            jnp.maximum(T, 1e-38))
        return j_sinkhorn_log(a, b, logK, inner_iters)

    T = a[:, None] * b[None, :]
    eager = T
    for _ in range(outer_iters):
        eager = step(eager, jnp.float32(epsilon))
    fused = jax.jit(lambda eps: jax.lax.fori_loop(
        0, outer_iters, lambda i, t: step(t, eps), T))(jnp.float32(epsilon))
    return np.asarray(eager), np.asarray(fused)


def _readings(name, args, port, ref, m, n, **iters):
    T64 = x64_prox_coupling(*args, **iters)[0][:m, :n]
    wide = x64_prox_coupling(*args, **{**iters, "epsilon": 1.1e-2})[0]
    eager, fused = _ref_steps(*args, **iters)
    row = {"port": prox_gap(port, T64),
           "reference": prox_gap(ref, T64),
           "ref eager": prox_gap(eager[:m, :n], T64),
           "ref fori": prox_gap(fused[:m, :n], T64),
           "eps +10%": prox_gap(wide[:m, :n], T64)}
    print(f"{name:>16} " + "  ".join(f"{k} {v:.3g}" for k, v in row.items()),
          flush=True)
    return row


def main():
    rows = []
    solver = repro_torch.DenseGWSolver()
    srv = rserve.GWServer(rserve.ServeConfig(max_batch=4, max_wait_s=60.0,
                                             on_failure="none"))
    port_srv = GWServer(_cpu(max_batch=4, on_failure="none"))
    try:
        got = port_srv.results([port_srv.submit(_problem(k, m, n), solver)
                                for k, (m, n) in enumerate(SERVE_SIZES)])
        want = srv.results([srv.submit(_ref_problem(k, m, n),
                                       repro.DenseGWSolver())
                            for k, (m, n) in enumerate(SERVE_SIZES)])
    finally:
        srv.close()
        port_srv.close()
    for k, ((m, n), g, w) in enumerate(zip(SERVE_SIZES, got, want)):
        padded = rserve.pad_problem(_ref_problem(k, m, n), *g.padded_shape)
        args = [np.asarray(x) for x in (
            padded.geom_x.cost, padded.geom_y.cost, padded.geom_x.weights,
            padded.geom_y.weights)]
        rows.append(_readings(f"serve {m}x{n}", args, g.coupling_dense(),
                              w.coupling_dense(), m, n))

    import test_torch_legacy as legacy
    a, b, Cx, Cy, _ = legacy._data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _, rT = repro.core.gw_dense(*(jnp.asarray(x) for x in (a, b, Cx, Cy)),
                                    **legacy.ITERS)
        _, pT = repro_torch.core.gw_dense(*(legacy._t(x)
                                            for x in (a, b, Cx, Cy)),
                                          **legacy.ITERS, device="cpu")
    rows.append(_readings("gw_dense shim", (Cx, Cy, a, b), pT.numpy(),
                          np.asarray(rT), legacy.N, legacy.N,
                          **legacy.ITERS))

    rng = np.random.default_rng(2024)
    for k in range(12):
        m, n = (int(x) for x in rng.integers(10, 33, 2))
        p = _problem(100 + k, m, n)
        r = _ref_problem(100 + k, m, n)
        pT = repro_torch.solve(p, solver, device="cpu").coupling
        rT = repro.solve(r, repro.DenseGWSolver()).coupling
        args = [np.asarray(x) for x in (r.geom_x.cost, r.geom_y.cost,
                                        r.geom_x.weights, r.geom_y.weights)]
        rows.append(_readings(f"random {m}x{n}", args, pT.numpy(),
                              np.asarray(rT), m, n))

    for name, part in (("tested", rows[:7]), ("random", rows[7:])):
        worst = max(v for r in part for k, v in r.items() if k != "eps +10%")
        wrong = min(r["eps +10%"] for r in part)
        print(f"{name} problems: largest float32 reading {worst:.3g}, "
              f"smallest reading of the eps +10% coupling {wrong:.3g}")


if __name__ == "__main__":
    main()
