"""The port's checkpoint manager against ``repro.checkpoint``, on the CPU.

The same numpy tree (dicts, a list, a tuple, an ``AdamWState`` of each
package, a 0-d int32 step) saved by each manager gives equal manifests and
equal ``.npy`` bytes, and each manager restores the other's checkpoint;
then the reference's own checks (tests/test_checkpoint.py) on the port:
a partial write is invisible, keep-k holds, an async save lands, and a
restore into another structure order reads by key. Exact throughout.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import adamw


def _numpy_tree(state_cls, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "blocks": [{"a": rng.standard_normal(3).astype(np.float32)},
                         {"a": rng.standard_normal(3).astype(np.float32)}],
              "pair": (np.arange(7, dtype=np.int32),
                       rng.standard_normal((2, 2)))}
    zeros = {"w": np.zeros((4, 5), np.float32)}
    return {"params": params,
            "opt": state_cls(np.asarray(3, np.int32), zeros,
                             {"w": np.ones((4, 5), np.float32)})}


def _files(step_dir):
    return {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())}


def test_manifests_and_bytes_equal_the_reference(tmp_path):
    extra = {"pipeline": {"step": 3, "seed": 9}}
    RefManager(tmp_path / "ref").save(
        3, _numpy_tree(ref_adamw.AdamWState), extra=extra)
    CheckpointManager(tmp_path / "port").save(
        3, _numpy_tree(adamw.AdamWState), extra=extra)
    ref = _files(tmp_path / "ref" / "step_0000000003")
    port = _files(tmp_path / "port" / "step_0000000003")
    assert ref == port
    keys = [leaf["key"] for leaf in json.loads(port["manifest.json"])[
        "leaves"]]
    assert keys[:3] == ["opt/.step", "opt/.m/w", "opt/.v/w"]
    assert "params/blocks/1/a" in keys and "params/pair/0" in keys


def test_tensor_leaves_write_the_same_bytes(tmp_path):
    """A tree of tensors (the trainer's) is written as its numpy copy."""
    tree = _numpy_tree(adamw.AdamWState)
    as_tensors = {"params": adamw.tree_map(torch.from_numpy, tree["params"]),
                  "opt": adamw.AdamWState(*(adamw.tree_map(
                      torch.from_numpy, x) for x in tree["opt"]))}
    CheckpointManager(tmp_path / "a").save(1, tree)
    CheckpointManager(tmp_path / "b").save(1, as_tensors)
    assert _files(tmp_path / "a" / "step_0000000001") == _files(
        tmp_path / "b" / "step_0000000001")


def _assert_tree_equal(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        assert x.dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, np.asarray(y))


def test_each_restores_the_other(tmp_path):
    RefManager(tmp_path / "ref").save(5, _numpy_tree(ref_adamw.AdamWState),
                                      extra={"k": 1})
    CheckpointManager(tmp_path / "port").save(
        5, _numpy_tree(adamw.AdamWState), extra={"k": 1})
    # the port reads the reference's, into tensors on the target's device
    target = _numpy_tree(adamw.AdamWState, seed=1)
    target = {"params": adamw.tree_map(torch.from_numpy, target["params"]),
              "opt": adamw.AdamWState(*(adamw.tree_map(torch.from_numpy, x)
                                        for x in target["opt"]))}
    got, extra = CheckpointManager(tmp_path / "ref").restore(5, target)
    assert extra == {"k": 1} and isinstance(got["opt"], adamw.AdamWState)
    assert all(torch.is_tensor(x) and x.device.type == "cpu"
               for x in adamw.tree_leaves(got["params"]))
    _assert_tree_equal(
        {"params": got["params"], "opt": tuple(got["opt"])},
        {"params": _numpy_tree(adamw.AdamWState)["params"],
         "opt": tuple(_numpy_tree(adamw.AdamWState)["opt"])})
    # the reference reads the port's
    got, extra = RefManager(tmp_path / "port").restore(
        5, _numpy_tree(ref_adamw.AdamWState, seed=2))
    assert extra == {"k": 1}
    _assert_tree_equal(got, _numpy_tree(ref_adamw.AdamWState))


def test_restore_casts_to_the_target_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": np.arange(4, dtype=np.int32)})
    got, _ = mgr.restore(1, {"x": torch.zeros(4, dtype=torch.int64)})
    assert got["x"].dtype == torch.int64 and got["x"].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"x": torch.zeros(5)})


def test_bfloat16_and_shardings_raise(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(1, {"x": torch.zeros(3, dtype=torch.bfloat16)})
    mgr.save(2, {"x": np.zeros(3, np.float32)})
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.restore(2, {"x": torch.zeros(3, dtype=torch.bfloat16)})
    # restoring onto a mesh (covered in test_torch_mesh_train.py) refuses
    # a bfloat16 target as well, before it places anything
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.restore(2, {"x": torch.zeros(3, dtype=torch.bfloat16)},
                    shardings={"x": None})


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 5, generator=g),
            "nested": {"b": torch.arange(7),
                       "c": (torch.ones(3), torch.zeros(2))}}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    mgr.save(3, t, extra={"pipeline": {"step": 3, "seed": 9}})
    restored, extra = mgr.restore(3, t)
    for x, y in zip(adamw.tree_leaves(t), adamw.tree_leaves(restored)):
        assert torch.equal(x, y)
    assert extra["pipeline"]["step"] == 3


def test_partial_write_invisible(tmp_path):
    """A .tmp dir (crashed writer) must never be picked up."""
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_0000000002.tmp")
    assert mgr.latest_step() == 1
    # a step dir without manifest (corruption) is also skipped
    os.makedirs(tmp_path / "step_0000000005")
    assert mgr.latest_step() == 1


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    t = _tree()
    mgr.save(7, t, blocking=False)
    t["a"].zero_()              # the tree was copied before save returned
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore(7, t)
    assert torch.equal(restored["a"], _tree()["a"])


def test_restore_different_structure_order(tmp_path):
    """Restore is keyed by path, not flatten order."""
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, _tree())
    target = {"nested": {"c": (torch.zeros(3), torch.ones(2)),
                         "b": torch.zeros(7, dtype=torch.int32)},
              "a": torch.zeros((4, 5))}
    restored, _ = mgr.restore(1, target)
    assert restored["nested"]["b"].tolist() == list(range(7))
    assert restored["nested"]["b"].dtype == torch.int32
    assert list(restored) == ["nested", "a"]
