"""The sharded grid solver over ``torch.distributed`` against the
reference's ``make_sharded_grid_gw`` under ``shard_map``, CPU.

The inputs are ``tests/test_distrib.py``'s (s_r = s_c = 16, ε = 0.05,
4 outer x 15 inner steps). The reference runs in this process on a
one-device ``jax.make_mesh((1, 1), ("data", "model"))``; its arithmetic
does not depend on the mesh's shape beyond summation order. The port runs
over gloo at world size 1 in this process, and at world size 4 as a 2 x 2
mesh in four spawned processes sharing a ``FileStore`` under ``tmp_path``.

Tolerances (``tests/test_torch_solve.py``'s): value rtol 1e-5, block atol
1e-6 + rtol 1e-4: the same fp32 steps, summed in another order. With
``comm_dtype`` bfloat16 both packages round the same operands (the
gathered T and M, and h2(CyC), h1(CxR)) and multiply them in float32.
"""
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.grid_gw import grid_cost as j_grid_cost
from repro.core.sharded_gw import make_sharded_grid_gw as j_make
from repro.core.sinkhorn import sinkhorn_log as j_sinkhorn_log
from repro_torch.core.sharded_gw import ProcessMesh, make_sharded_grid_gw
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse

VALUE_RTOL = 1e-5
VALS_ATOL, VALS_RTOL = 1e-6, 1e-4
S = 16
ARGS = ("l2", 0.05, 4, 15)            # loss, ε, outer, inner
ROOT = Path(__file__).resolve().parents[1]
NAMES = ("CxR", "CyC", "aR", "bC", "w")
COMMS = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs():
    CxR = jax.random.uniform(jax.random.PRNGKey(0), (S, S))
    CxR = (CxR + CxR.T) / 2
    CyC = jax.random.uniform(jax.random.PRNGKey(1), (S, S))
    CyC = (CyC + CyC.T) / 2
    aR, bC = jnp.ones(S) / S, jnp.ones(S) / S
    return dict(zip(NAMES, (np.asarray(x) for x in
                            (CxR, CyC, aR, bC, jnp.ones((S, S))))))


@pytest.fixture(scope="module")
def reference():
    """Per comm dtype: the reference's (value, block) on a 1 x 1 mesh, and
    the value of test_distrib.py's unsharded loop."""
    d = _inputs()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {}
    for name, (_, jdt) in COMMS.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with mesh:
                val, T = j_make(mesh, S, S, *ARGS, comm_dtype=jdt)(
                    *(jnp.asarray(d[k]) for k in NAMES))
        out[name] = (float(val), np.asarray(T))
    CxR, CyC, aR, bC, w = (jnp.asarray(d[k]) for k in NAMES)
    Tr = aR[:, None] * bC[None, :]
    for _ in range(4):
        C = j_grid_cost(CxR, CyC, Tr, "l2")
        Tr = j_sinkhorn_log(aR, bC, -C / 0.05 + jnp.log(w)
                            + jnp.log(jnp.maximum(Tr, 1e-38)), 15)
    out["unsharded"] = float(jnp.sum(Tr * j_grid_cost(CxR, CyC, Tr, "l2")))
    return d, out


def _close(val, T, want):
    np.testing.assert_allclose(val, want[0], rtol=VALUE_RTOL)
    np.testing.assert_allclose(T, want[1], rtol=VALS_RTOL, atol=VALS_ATOL)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "s"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield ProcessMesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("comm", sorted(COMMS))
def test_world_size_one_matches_reference(comm, reference, world_of_one):
    d, want = reference
    fn = make_sharded_grid_gw(world_of_one, S, S, *ARGS,
                              comm_dtype=COMMS[comm][0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        val, T = fn(*(torch.tensor(d[k]) for k in NAMES))
    assert tuple(T.shape) == (S, S) and T.dtype == torch.float32
    _close(float(val), T.numpy(), want[comm])
    # test_distrib.py's own bound against the unsharded loop
    assert abs(float(val) - want["unsharded"]) < 1e-4


def test_mesh_checks_its_shape(world_of_one):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        ProcessMesh(2, 2)


WORKER = textwrap.dedent("""
    import sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    from repro_torch.core.sharded_gw import ProcessMesh, make_sharded_grid_gw
    warnings.simplefilter("ignore", FutureWarning)
    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    mesh = ProcessMesh(2, 2)
    d = np.load(out + "/inputs.npz")
    names = ("CxR", "CyC", "aR", "bC", "w")
    for name, comm in (("f32", None), ("bf16", torch.bfloat16)):
        fn = make_sharded_grid_gw(mesh, 16, 16, "l2", 0.05, 4, 15,
                                  comm_dtype=comm)
        val, T = fn(*(torch.tensor(d[k]) for k in names))
        np.save(f"{out}/{name}_{rank}.npy",
                np.concatenate([[float(val)], T.numpy().ravel()]))
    dist.destroy_process_group()
""")


@pytest.mark.skipif(not dist.is_gloo_available(),
                    reason="torch.distributed has no gloo backend")
def test_world_size_four_as_a_2x2_mesh(reference, tmp_path):
    d, want = reference
    np.savez(tmp_path / "inputs.npz", **d)
    env = {**os.environ, "PYTHONWARNINGS": "ignore"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(tmp_path / "store"),
         str(tmp_path), str(ROOT / "src")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for comm in COMMS:
        results = [np.load(tmp_path / f"{comm}_{r}.npy") for r in range(4)]
        # every rank holds the same value and the whole block
        assert all(np.array_equal(results[0], r) for r in results[1:])
        _close(results[0][0], results[0][1:].reshape(S, S), want[comm])
