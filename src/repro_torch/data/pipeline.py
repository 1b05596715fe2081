"""Deterministic synthetic token pipeline — shard-aware and checkpointable.

The port's own copy of ``repro.data.pipeline`` (numpy only; the port
imports nothing of the reference): batch ``i`` is a pure function of
(seed, step), drawn by the same numpy calls in the same order, so its
batches are bit for bit the reference's. Restarts are exact (the step
rides in the checkpoint), data-parallel shards slice the same global
batch, and elastic re-scaling just re-slices. A real deployment swaps
``_synthesize`` for tokenized shard files.

Batches are numpy arrays (int32 tokens and labels, float32 image
embeddings for a VLM config); the trainer moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass
class DataConfig:
    seed: int = 1234
    # markov-chain synthetic language (so CE actually decreases in examples)
    order_bias: float = 0.8


class TokenPipeline:
    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int,
                 data_cfg: Optional[DataConfig] = None):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.dc = data_cfg or DataConfig()
        self.step = 0

    # -- state (checkpointable) --------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.dc.seed}

    def load_state_dict(self, state: Dict):
        self.step = int(state["step"])
        self.dc.seed = int(state["seed"])

    # -- batches -------------------------------------------------------------
    def _synthesize(self, rng: np.random.Generator, batch: int):
        V = self.cfg.vocab_size
        S = self.seq_len + 1
        # cheap markov-ish stream: next token correlated with previous
        base = rng.integers(0, V, size=(batch, S), dtype=np.int64)
        keep = rng.random((batch, S)) < self.dc.order_bias
        toks = base.copy()
        for t in range(1, S):
            toks[:, t] = np.where(keep[:, t],
                                  (toks[:, t - 1] * 31 + 7) % V,
                                  base[:, t])
        return toks.astype(np.int32)

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch `step` — pure function of (seed, step)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.dc.seed, step]))
        toks = self._synthesize(rng, self.global_batch)
        if self.cfg.n_codebooks > 1:
            C = self.cfg.n_codebooks
            toks = np.stack([(toks * (c + 1) + c) % self.cfg.vocab_size
                             for c in range(C)], axis=-1)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "vlm":
            img = rng.standard_normal(
                (self.global_batch, self.cfg.n_image_tokens,
                 self.cfg.d_model)).astype(np.float32)
            batch["image_embeds"] = img
        return batch

    def shard_slice(self, batch: Dict, shard_index: int, num_shards: int):
        """Per-host slice of the global batch (multi-host data loading)."""
        per = self.global_batch // num_shards
        lo = shard_index * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.global_batch_at(self.step)
        self.step += 1
        return b
