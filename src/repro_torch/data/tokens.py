"""Deterministic, resumable, host-shardable synthetic token pipeline.

Every batch is a pure function of ``(seed, step, shard)`` — a Philox counter
keyed on those three — so:

* restarts are exact (the checkpoint stores just ``step``),
* each data-parallel host generates only its shard (no broadcast),
* no filesystem or tokenizer dependency (offline container).

The streams are *learnable*: each sequence follows an affine recurrence
``tok[t+1] = (a·tok[t] + b) mod V`` with per-sequence (a, b) drawn from a
small pool, plus noise — a few hundred steps of a small LM visibly drops
the loss, which the integration tests assert.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline", "PipelineState"]


@dataclasses.dataclass(frozen=True)
class PipelineState:
    step: int = 0

    def to_json(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_json(cls, d: dict) -> "PipelineState":
        return cls(step=int(d["step"]))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch: int                  # per-shard batch
    seq_len: int
    seed: int = 0
    shard: int = 0              # data-parallel shard index
    n_shards: int = 1
    noise: float = 0.05
    pool: int = 16              # size of the (a, b) pattern pool

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=np.uint64(self.seed),
                             counter=[0, 0, np.uint64(step), np.uint64(self.shard)])
        )

    def batch_at(self, state: PipelineState) -> tuple[dict, PipelineState]:
        rng = self._rng(state.step)
        V = self.vocab_size
        pat = rng.integers(0, self.pool, size=self.batch)
        a = 1 + 2 * (1 + pat)                       # odd multipliers, invertible mod 2^k
        b = 7 * (1 + pat)
        toks = np.empty((self.batch, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, V, size=self.batch)
        for t in range(1, self.seq_len):
            toks[:, t] = (a * toks[:, t - 1] + b) % V
        flip = rng.random((self.batch, self.seq_len)) < self.noise
        toks = np.where(flip, rng.integers(0, V, size=toks.shape), toks).astype(np.int32)
        return {"tokens": toks}, PipelineState(step=state.step + 1)
