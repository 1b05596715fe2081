"""Fault-tolerant checkpointing: atomic, async, keep-k.

The counterpart of ``repro.checkpoint.manager``, in its on-disk format:
one ``.npy`` per tree leaf and a JSON manifest (step, ``extra`` such as
the data pipeline's state, and per leaf its key, file, shape and dtype).
A leaf's key is its path as the reference's ``_flatten_with_paths``
writes it: dict keys (in sorted order) and sequence indices joined by
``/``, a ``NamedTuple`` field as ``.name`` (so an ``AdamWState``'s moments
are ``opt/.m/...``); ``None`` holds no leaf. The two packages write the
same manifest and the same ``.npy`` bytes for the same tree, and each
restores the other's checkpoints.

Writes go to ``step_XXXXXXXXXX.tmp`` and are published by an atomic
``os.replace``, so a crashed writer never leaves a checkpoint that
``latest_step`` picks up; the oldest are removed past ``keep``.
``save(blocking=False)`` copies the tree to the host and writes it from a
background thread while training goes on.

``restore`` reads the leaves by key into the structure of a target tree
and puts each on the device and in the dtype of its target leaf: the
one-card counterpart of the reference's ``device_put`` with shardings.
Restoring onto another mesh (``shardings``) waits for the distributed
port (ROADMAP item 17d). bfloat16 leaves have no counterpart: numpy has
no bfloat16 dtype without the reference's ``ml_dtypes``, and the trainer
keeps float32 parameters, so both ways raise a ``TypeError``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in the reference's order and key format."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for name, x in zip(tree._fields, tree)
                for kv in _flatten_with_paths(x, prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten_with_paths(x, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _map_with_paths(fn, tree, prefix=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, x, prefix + (f".{name}",))
                            for name, x in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, x, prefix + (str(i),))
                          for i, x in enumerate(tree))
    return fn("/".join(prefix), tree)


def _to_host(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which "
                            f"numpy cannot hold; save float32 leaves")
        host = leaf.detach().cpu().contiguous().numpy()
        # a CPU tensor's numpy view would share its memory: copy it, so a
        # background write sees the tree as it was when saved
        return host.copy() if leaf.device.type == "cpu" else host
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True):
        """Atomic checkpoint write; ``blocking=False`` runs in a background
        thread (compute continues while the previous step persists). The
        tree is copied to the host before this returns either way."""
        host_tree = _map_with_paths(_to_host, tree)
        if blocking:
            self._write(step, host_tree, extra or {})
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree, extra or {}))
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree, extra):
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if final.exists() and (final / "manifest.json").exists():
            return                       # checkpoints are immutable
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for key, leaf in _flatten_with_paths(host_tree):
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, leaf)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(leaf.shape),
                 "dtype": str(leaf.dtype)})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, shardings: Any = None):
        """Restore into the structure of ``target_tree``, leaves looked up
        by key (not by flatten order). A tensor target leaf gets a tensor
        on its device in its dtype; any other target leaf gets the numpy
        array in the target's dtype. Returns (tree, extra)."""
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto a mesh (shardings) waits for the "
                "distributed port (ROADMAP item 17d); one card restores "
                "onto the target leaves' devices")
        path = self.dir / f"step_{step:010d}"
        with open(path / "manifest.json") as f:
            manifest = json.load(f)
        by_key = {rec["key"]: rec for rec in manifest["leaves"]}

        def load(key, target):
            rec = by_key[key]
            if rec["dtype"] == "bfloat16" or (
                    isinstance(target, torch.Tensor)
                    and target.dtype == torch.bfloat16):
                raise TypeError(f"checkpoint leaf {key!r}: bfloat16 has no "
                                f"numpy counterpart here")
            arr = np.load(path / rec["file"])
            shape = tuple(target.shape) if hasattr(target, "shape") \
                else np.shape(target)
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the target {shape}")
            if isinstance(target, torch.Tensor):
                return torch.from_numpy(arr).to(device=target.device,
                                                dtype=target.dtype)
            return arr.astype(np.asarray(target).dtype, copy=False)

        return _map_with_paths(load, target_tree), manifest["extra"]
