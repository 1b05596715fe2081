"""``repro_torch.distrib``'s compression and pipeline against the
reference's, on the CPU over gloo.

* ``quantize_int8`` / ``dequantize_int8``: bitwise equal to the
  reference's on the same inputs, a length not a multiple of 256 among
  them (the same float32 division, max and round half to even).
* ``compressed_psum`` / ``dp_allreduce_grads``: at world size 1 in this
  process, and at world size 4 in four spawned processes sharing a
  ``FileStore`` under ``tmp_path``, against the reference's result from
  the same shards (its ``compressed_psum`` under ``shard_map`` on one
  device for world size 1; for four, its own ``quantize_int8`` of each
  shard and its dequantize-and-sum, what its ``all_gather`` feeds). rtol
  1e-6: the same dequantized terms summed in rank order. Also
  ``tests/test_distrib.py``'s bound against the exact mean.
* ``pipeline_forward`` with 4 stages x 8 microbatches on 4 gloo ranks,
  against the reference's ``pipeline_forward`` on 4 forced host devices
  and the sequential loop, at ``tests/test_distrib.py``'s atol 1e-5.
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

from repro.distrib import compression as ref_comp
from repro_torch.distrib import compression
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parents[1]
PSUM_RTOL = 1e-6
PIPE_ATOL = 1e-5
N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16
LENGTHS = (1000, 256, 517, 3 * 256 + 1)


def _x(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 3.0).astype(
        np.float32)


@pytest.mark.parametrize("n", LENGTHS)
def test_int8_quantization_is_bitwise_the_reference(n):
    x = _x(n, n)
    q, s = compression.quantize_int8(torch.tensor(x))
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    back = compression.dequantize_int8(q, s, (n,))
    rback = ref_comp.dequantize_int8(rq, rs, (n,))
    np.testing.assert_array_equal(back.numpy(), np.asarray(rback))
    # tests/test_distrib.py's bound: block max / 127
    assert np.abs(back.numpy() - x).max() <= np.abs(x).max() / 127.0 * 1.01


def _shards():
    """test_distrib.py's (4, 64) normal shards, and a (3, 100) tree leaf."""
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4, 64)).astype(np.float32),
            rng.standard_normal((4, 3, 100)).astype(np.float32))


def _ref_sum(shards):
    """The reference's compressed sum of ``shards`` (one a rank): its
    quantization of each, dequantized and summed over the ranks."""
    qs, ss = zip(*(ref_comp.quantize_int8(jnp.asarray(s)) for s in shards))
    total = jnp.sum(jnp.stack(qs).astype(jnp.float32) * jnp.stack(ss),
                    axis=0)
    n = shards[0].size
    return np.asarray(total.reshape(-1)[:n].reshape(shards[0].shape))


def test_world_size_one_matches_reference_under_shard_map(tmp_path):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    x = _shards()[0][:1]
    mesh = jax.make_mesh((1,), ("data",))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(shard_map(
            lambda xl: ref_comp.dp_allreduce_grads(
                {"w": xl[0]}, "data", compress=True)["w"],
            mesh=mesh, in_specs=P("data"), out_specs=P(),
            check_vma=False)(jnp.asarray(x)))
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got = compression.dp_allreduce_grads({"w": torch.tensor(x[0])},
                                             compress=True)["w"]
        np.testing.assert_allclose(got.numpy(), want, rtol=PSUM_RTOL)
        np.testing.assert_allclose(got.numpy(), _ref_sum(x), rtol=PSUM_RTOL)
        plain = compression.dp_allreduce_grads([torch.tensor(x[0])])[0]
        np.testing.assert_array_equal(plain.numpy(), x[0])
    finally:
        dist.destroy_process_group()


WORKER = textwrap.dedent("""
    import sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distrib.compression import (compressed_psum,
                                                 dp_allreduce_grads)
    from repro_torch.distrib.pipeline import pipeline_forward
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    d = np.load(out + "/inputs.npz")
    res = {}
    res["psum"] = compressed_psum(torch.tensor(d["x"][rank])).numpy()
    g = dp_allreduce_grads({"a": torch.tensor(d["x"][rank]),
                            "b": [torch.tensor(d["y"][rank])]},
                           compress=True)
    res["mean_a"], res["mean_b"] = g["a"].numpy(), g["b"][0].numpy()
    res["exact_a"] = dp_allreduce_grads(
        {"a": torch.tensor(d["x"][rank])})["a"].numpy()
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pipe",))
    piped = pipeline_forward(mesh, lambda W, x: torch.tanh(x @ W), 4, 8)
    # each rank holds only its stage's weights
    res["pipe"] = piped(torch.tensor(d["Ws"][rank]),
                        torch.tensor(d["xs"])).numpy()
    np.savez(f"{out}/out_{rank}.npz", **res)
    dist.destroy_process_group()
""")

REF_PIPE = """
import jax, jax.numpy as jnp, numpy as np
from repro.distrib.pipeline import pipeline_forward
d = np.load("{path}/inputs.npz")
mesh = jax.make_mesh((4,), ("pipe",))
piped = pipeline_forward(mesh, lambda W, x: jnp.tanh(x @ W), 4, 8)
with mesh:
    y = piped(jnp.asarray(d["Ws"]), jnp.asarray(d["xs"]))
np.save("{path}/ref_pipe.npy", np.asarray(y))
print("ok")
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four gloo ranks' results, and the inputs."""
    path = tmp_path_factory.mktemp("distrib")
    x, y = _shards()
    rng = np.random.default_rng(3)
    d = {"x": x, "y": y,
         "Ws": (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(
             np.float32),
         "xs": rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)}
    np.savez(path / "inputs.npz", **d)
    env = {**os.environ, "PYTHONWARNINGS": "ignore"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(path / "store"),
         str(path), str(ROOT / "src")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return path, d, [dict(np.load(path / f"out_{r}.npz")) for r in range(4)]


@pytest.mark.skipif(not dist.is_gloo_available(),
                    reason="torch.distributed has no gloo backend")
def test_world_size_four_compressed_sum_matches_reference(four_ranks):
    _, d, outs = four_ranks
    want = _ref_sum(d["x"])
    for o in outs:                      # every rank gets the same sum
        np.testing.assert_array_equal(o["psum"], outs[0]["psum"])
    np.testing.assert_allclose(outs[0]["psum"], want, rtol=PSUM_RTOL)
    np.testing.assert_allclose(outs[0]["mean_a"], want / 4, rtol=PSUM_RTOL)
    np.testing.assert_allclose(outs[0]["mean_b"], _ref_sum(d["y"]) / 4,
                               rtol=PSUM_RTOL)
    # tests/test_distrib.py's bound against the exact mean
    exact = d["x"].mean(axis=0)
    bound = np.abs(d["x"]).max() / 127.0 * 1.5 + 1e-6
    assert np.abs(outs[0]["mean_a"] - exact).max() < bound
    np.testing.assert_allclose(outs[0]["exact_a"], exact, rtol=1e-6,
                               atol=1e-7)


@pytest.mark.skipif(not dist.is_gloo_available(),
                    reason="torch.distributed has no gloo backend")
def test_pipeline_matches_reference_and_sequential(four_ranks,
                                                   multi_device_runner):
    path, d, outs = four_ranks
    multi_device_runner(REF_PIPE.format(path=path), n_devices=4)
    ref = np.load(path / "ref_pipe.npy")
    seq = d["xs"]
    for i in range(N_STAGES):
        seq = np.tanh(seq @ d["Ws"][i])
    for o in outs:                      # every rank holds the outputs
        np.testing.assert_array_equal(o["pipe"], outs[0]["pipe"])
    np.testing.assert_allclose(outs[0]["pipe"], ref, atol=PIPE_ATOL)
    np.testing.assert_allclose(outs[0]["pipe"], seq, atol=PIPE_ATOL)
