"""The port's envelope gradient against its own unrolled gradient for
spar_gw on a sampled support, CPU (a file of its own: the unrolled
gradient through 100 x 300 iterations takes ~40 s here).

tests/test_diff.py's spar case (n = 14, m = 11, s = 16n, 100 x 300
iterations, ε = 5e-2, costs over 10) on the support its x64 run draws,
where the reference holds the two gradients to its bound, a relative gap
of 1e-3 in a directional derivative; measured here 5.8e-4, after the
convergence checks of tests/test_torch_envelope.py.
"""
import jax
import jax.numpy as jnp
import numpy as np

import repro
import repro_torch
from repro_torch.api import interop
from test_torch_envelope import REL_TOL, _envelope_vs_unrolled
from test_torch_solve import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_unrolled import KEY, _problems


def test_envelope_matches_unrolled_spar():
    with jax.enable_x64(True):
        kx, kp = jax.random.split(jax.random.PRNGKey(1))
        x = jax.random.normal(kx, (14, 2))
        th = 0.7
        R = jnp.array([[jnp.cos(th), -jnp.sin(th)],
                       [jnp.sin(th), jnp.cos(th)]])
        y = (x @ R.T + 0.25 * jax.random.normal(kp, (14, 2)))[:11]

        def sq(z):
            s = jnp.sum(z * z, axis=1)
            return jnp.maximum(s[:, None] + s[None, :] - 2.0 * z @ z.T, 0.0)
        Cx, Cy = sq(x) / 10.0, sq(y) / 10.0
        js = repro.SparGWSolver(epsilon=5e-2, s=16 * 14, outer_iters=100,
                                inner_iters=300, tol=0.0, inner_tol=0.0)
        jp, _ = _problems(Cx, np.asarray(Cy), jnp.float64)
        jo = repro.solve(jp(Cx), js, key=KEY)
        support = interop.to_support(jo.coupling.rows, jo.coupling.cols)
    Cx, Cy = np.asarray(Cx, np.float32), np.asarray(Cy, np.float32)
    _, pp = _problems(Cx, Cy)
    D = np.random.default_rng(1).standard_normal((14, 14))
    solver = repro_torch.SparGWSolver(epsilon=5e-2, s=16 * 14,
                                      outer_iters=100, inner_iters=300,
                                      trace=True)
    assert _envelope_vs_unrolled(pp, Cx, solver, (D + D.T) / 2,
                                 support=support) <= REL_TOL
